"""Checkpoint manifest: the sharded-model layout save and restore agree
on — a copy of ``tpubench/lifecycle/manifest.py`` (same format string,
same object names, same bytes), so either package restores a checkpoint
the other saved.

A checkpoint is ``objects`` shard-objects of ``object_bytes`` each — one
object per parameter shard — plus one ``MANIFEST.json`` object naming them
all with their sizes and crc32s.

Object content is :func:`~tpubench_torch.storage.base.deterministic_bytes`
of the object's NAME, so any host (or the restore verifier) can regenerate
and check any shard without shipping bytes around. The crc32 travels in
the manifest, which is what makes "zero corrupt finalizes" and
"byte-identical restore" checkable with one cheap pass instead of a
second full copy of the checkpoint.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass

from tpubench_torch.storage.base import deterministic_bytes

MANIFEST_FORMAT = "tpubench-ckpt/1"


@dataclass(frozen=True)
class ShardSpec:
    """One checkpoint shard-object."""

    name: str
    size: int
    crc32: int


@dataclass(frozen=True)
class CkptManifest:
    prefix: str
    objects: tuple

    @property
    def total_bytes(self) -> int:
        return sum(o.size for o in self.objects)

    def to_json(self) -> str:
        return json.dumps({
            "format": MANIFEST_FORMAT,
            "prefix": self.prefix,
            "objects": [
                {"name": o.name, "size": o.size, "crc32": o.crc32}
                for o in self.objects
            ],
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "CkptManifest":
        doc = json.loads(text)
        if doc.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"not a checkpoint manifest (format="
                f"{doc.get('format')!r}, want {MANIFEST_FORMAT})"
            )
        return cls(
            prefix=doc["prefix"],
            objects=tuple(
                ShardSpec(o["name"], int(o["size"]), int(o["crc32"]))
                for o in doc["objects"]
            ),
        )


def manifest_name(prefix: str) -> str:
    return f"{prefix}MANIFEST.json"


def shard_object_name(prefix: str, index: int) -> str:
    return f"{prefix}shard_{index:05d}"


def shard_content(name: str, size: int):
    """The shard's deterministic byte content (uint8 ndarray)."""
    return deterministic_bytes(name, size)


def build_manifest(prefix: str, n_objects: int,
                   object_bytes: int) -> CkptManifest:
    """The layout ``ckpt-save`` writes: crc32s computed from the same
    deterministic content the upload will stream."""
    objects = []
    for i in range(n_objects):
        name = shard_object_name(prefix, i)
        crc = zlib.crc32(shard_content(name, object_bytes).tobytes())
        objects.append(ShardSpec(name, object_bytes, crc & 0xFFFFFFFF))
    return CkptManifest(prefix=prefix, objects=tuple(objects))


def read_manifest(backend, prefix: str) -> CkptManifest:
    """Fetch and parse ``<prefix>MANIFEST.json`` through any backend."""
    name = manifest_name(prefix)
    meta = backend.stat(name)
    reader = backend.open_read(name)
    buf = bytearray(meta.size)
    mv = memoryview(buf)
    got = 0
    try:
        while got < meta.size:
            n = reader.readinto(mv[got:])
            if n <= 0:
                break
            got += n
    finally:
        reader.close()
    return CkptManifest.from_json(bytes(buf[:got]).decode())
