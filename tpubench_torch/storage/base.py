"""Backend protocol and shared primitives — a copy of
``tpubench/storage/base.py``.

The reference's L1 surface is ``bucket.Object(name).NewReader(ctx)``
streamed through a reused 2 MB buffer (``main.go:134-140``). The protocol
keeps that shape — a streaming reader filled into a caller-owned buffer —
because a caller-owned buffer is what the staging path needs (fill a
pinned slot, copy it to the device, reuse it).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Protocol, runtime_checkable

import numpy as np


class StorageError(Exception):
    """Backend error; ``transient`` drives the retry policy."""

    def __init__(self, msg: str, *, transient: bool = False, code: int = 0):
        super().__init__(msg)
        self.transient = transient
        self.code = code


@dataclass(frozen=True)
class ObjectMeta:
    name: str
    size: int
    generation: int = 0


def object_meta_dict(meta: ObjectMeta) -> dict:
    """The GCS JSON ``storage#object`` rendering of a stat result (what
    the loopback source server answers a metadata GET with)."""
    return {
        "kind": "storage#object",
        "name": meta.name,
        "size": str(meta.size),
        "generation": str(meta.generation),
    }


@runtime_checkable
class ObjectReader(Protocol):
    """Streaming reader for one object (or byte range).

    ``readinto`` fills as much of ``buf`` as available and returns the byte
    count (0 = EOF). Implementations set ``first_byte_ns`` to a
    ``time.perf_counter_ns`` stamp when the first payload byte arrives.
    """

    first_byte_ns: Optional[int]

    def readinto(self, buf: memoryview) -> int: ...

    def close(self) -> None: ...


@runtime_checkable
class ObjectWriter(Protocol):
    """Resumable streaming writer for one object (the GCS resumable-upload
    shape: session open → content-range parts → finalize).

    ``write`` appends one part and returns the server-acknowledged
    committed offset; ``offset`` is the committed offset the CLIENT
    currently believes; ``committed`` re-probes the server (the
    308-with-Range resume query) and resyncs ``offset`` — the primitive
    the mid-part resume path is built on. ``finalize`` completes the
    object and returns its metadata; implementations make it IDEMPOTENT
    server-side where the wire allows (a finalize retried after a lost
    response must not double-commit). ``abort`` abandons the session
    (best-effort; never raises)."""

    offset: int

    def write(self, data) -> int: ...

    def committed(self) -> int: ...

    def finalize(self) -> ObjectMeta: ...

    def abort(self) -> None: ...


@runtime_checkable
class StorageBackend(Protocol):
    """L1 backend. One instance is shared by every worker, so
    implementations must be thread-safe.

    ``write`` is the one-shot media upload; ``open_write`` the resumable
    multi-part session (both honor ``if_generation_match`` where the
    store has generations: 0 = object must not exist, N = current
    generation must be N; mismatch is a non-transient ``StorageError``
    with ``code=412`` — the idempotent-retry correctness anchor).
    ``list`` accepts ``page_size`` where the wire paginates
    (``maxResults``/``pageToken``); in-process stores ignore it."""

    def open_read(
        self, name: str, start: int = 0, length: Optional[int] = None
    ) -> ObjectReader: ...

    def write(
        self, name: str, data: bytes,
        if_generation_match: Optional[int] = None,
    ) -> ObjectMeta: ...

    def open_write(
        self, name: str, if_generation_match: Optional[int] = None
    ) -> ObjectWriter: ...

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]: ...

    def stat(self, name: str) -> ObjectMeta: ...

    def delete(self, name: str) -> None: ...

    def close(self) -> None: ...


def deterministic_bytes(name: str, size: int) -> np.ndarray:
    """Content of a synthetic object, reproducible from its name alone —
    the same bytes ``tpubench.storage.base.deterministic_bytes`` gives, so
    both packages serve one dataset."""
    seed = zlib.crc32(name.encode()) & 0xFFFFFFFF
    rng = np.random.Generator(np.random.Philox(seed))
    return rng.integers(0, 256, size=size, dtype=np.uint8)


def read_object_through(
    reader: ObjectReader, granule: memoryview, sink=None
) -> tuple[int, Optional[int]]:
    """The hot-loop copy: stream ``reader`` through the reused ``granule``
    buffer (reference: ``io.CopyBuffer(io.Discard, rc, 2MB)``, main.go:140).

    ``sink(filled_memoryview)`` is called per filled granule — ``None``
    discards (reference behavior); the staging path passes the stager's
    copying ``submit``. Closes the reader (main.go:148).
    Returns (total_bytes, first_byte_ns).
    """
    total = 0
    try:
        while True:
            n = reader.readinto(granule)
            if n <= 0:
                break
            total += n
            if sink is not None:
                sink(granule[:n])
    finally:
        reader.close()
    return total, reader.first_byte_ns


def read_object_into_sink(
    reader: ObjectReader, sink, granule_bytes: int
) -> tuple[int, Optional[int]]:
    """Zero-copy variant of :func:`read_object_through`: each granule is read
    *directly into* the staging slot the sink hands out (``sink.acquire()``),
    then staged with ``sink.commit(n)`` — no intermediate granule buffer.
    Semantics otherwise identical: streams to EOF, closes the reader,
    returns (total_bytes, first_byte_ns).
    """
    total = 0
    try:
        while True:
            dst = sink.acquire()
            n = reader.readinto(dst[:granule_bytes])
            if n <= 0:
                break
            total += n
            sink.commit(n)
    finally:
        reader.close()
    return total, reader.first_byte_ns


def iter_ranges(size: int, granule: int) -> Iterator[tuple[int, int]]:
    """(start, length) granule decomposition of a byte range."""
    off = 0
    while off < size:
        n = min(granule, size - off)
        yield off, n
        off += n
