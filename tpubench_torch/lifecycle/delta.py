"""Checkpoint DELTA saves: per-shard dirty tracking with CAS uploads.

A full ``ckpt-save`` re-uploads every shard every time; a training step
dirties only a fraction of them. :class:`DeltaTracker` keeps the
per-shard state a delta saver needs — content version (what the trainer
last wrote), committed storage generation (what the last save landed),
and a published crc32 per ``(shard, generation)`` so a restore can
verify byte-identity against the generation it actually fetched even
while saves keep landing new ones underneath it.

Each delta save uploads ONLY the dirty shards, each guarded by
``ifGenerationMatch`` on the generation this tracker committed last: a
412 precondition failure is NON-transient (another writer moved the
shard — split-brain, not weather), so it is never silently retried.
It is counted as a ``cas_conflict`` and classified into a full-save
fallback for that shard (one unconditional re-upload that re-adopts
whatever generation results), keeping the save correct while making the
conflict loud in the scorecard. The manifest is republished LAST and
only on an error-free pass — the ckpt.py publish discipline.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Optional

from tpubench_torch.storage.base import StorageError

from .manifest import CkptManifest, manifest_name, shard_content


def _versioned_content(name: str, size: int, version: int):
    """Deterministic shard bytes for one content version. Version 0 is
    the base ``shard_content`` (byte-identical to what build_manifest
    hashed); later versions derive from a salted name so every dirty
    step changes the bytes."""
    return shard_content(name if version == 0 else f"{name}#v{version}", size)


class DeltaTracker:
    """Per-shard dirty/generation/crc state shared by the delta saver
    and the restore verifier (leaf lock: nothing else is acquired while
    it is held)."""

    def __init__(self, manifest: CkptManifest):
        self._lock = threading.Lock()
        self.manifest = manifest
        self.version = {s.name: 0 for s in manifest.objects}
        self.dirty: set[str] = set()
        self.generation: dict[str, Optional[int]] = {
            s.name: None for s in manifest.objects
        }
        # (shard name, storage generation) -> crc32 of the committed
        # bytes. The restore plane verifies against the generation it
        # stat-pinned, so a save landing mid-restore can't make a good
        # read look torn (or a torn read look good).
        self.published_crc: dict[tuple[str, int], int] = {}

    # ------------------------------------------------------------ state --
    def adopt(self, name: str, generation: int, crc: int) -> None:
        """Record a committed shard generation (the baseline full save
        or a delta commit)."""
        with self._lock:
            self.generation[name] = generation
            self.published_crc[(name, generation)] = crc
            self.dirty.discard(name)

    def crc_for(self, name: str, generation: int) -> Optional[int]:
        with self._lock:
            return self.published_crc.get((name, generation))

    def mutate(self, rng, fraction: float) -> list[str]:
        """One training step: dirty ``fraction`` of the shards (at least
        one), bumping their content version. ``rng`` is a seeded
        ``random.Random`` — the dirty set is deterministic per run."""
        names = [s.name for s in self.manifest.objects]
        k = max(1, int(round(fraction * len(names))))
        picked = sorted(rng.sample(names, min(k, len(names))))
        with self._lock:
            for name in picked:
                self.version[name] += 1
                self.dirty.add(name)
        return picked

    def snapshot_dirty(self) -> dict[str, int]:
        """The shard set one save pass will upload: {name: version}."""
        with self._lock:
            return {n: self.version[n] for n in sorted(self.dirty)}

    def snapshot_all(self) -> dict[str, int]:
        """Every shard at its current version (the full-save arm)."""
        with self._lock:
            return {s.name: self.version[s.name]
                    for s in self.manifest.objects}


def delta_save(
    backend,
    tracker: DeltaTracker,
    part_bytes: int,
    *,
    delta: bool = True,
    ring=None,
    transport_label: str = "",
    part_recorder=None,
    clock_ns=time.perf_counter_ns,
) -> dict:
    """One save pass under live traffic.

    ``delta=True`` uploads only the tracker's dirty shards, each CAS-
    guarded on its last committed generation; ``delta=False`` is the
    full-save arm (every shard, unguarded — the A/B baseline). Returns
    the pass's ledger: shard counts by disposition, bytes uploaded, CAS
    conflicts and their classified full fallbacks, errors.
    """
    from .upload import upload_object

    manifest = tracker.manifest
    todo = tracker.snapshot_dirty() if delta else tracker.snapshot_all()
    sizes = {s.name: s.size for s in manifest.objects}
    stats = {
        "shards_total": len(manifest.objects),
        "dirty_shards": len(tracker.snapshot_dirty()),
        "uploaded_shards": 0,
        "skipped_clean": len(manifest.objects) - len(todo),
        "cas_conflicts": 0,
        "full_fallbacks": 0,
        "bytes_uploaded": 0,
        "errors": 0,
    }
    for name, version in todo.items():
        data = _versioned_content(name, sizes[name], version)
        payload = data.tobytes()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        guard = tracker.generation.get(name) if delta else None
        op = (
            ring.begin(name, transport_label, kind="upload")
            if ring is not None else None
        )
        try:
            try:
                meta, _ = upload_object(
                    backend, name, payload, part_bytes,
                    if_generation_match=guard,
                    part_recorder=part_recorder,
                )
            except StorageError as e:
                if guard is None or e.transient or e.code != 412:
                    raise
                # CAS lost: another writer committed a generation we
                # never adopted. Non-transient by design — classify it
                # and fall back to ONE unconditional full re-upload of
                # this shard rather than retrying the stale guard.
                stats["cas_conflicts"] += 1
                stats["full_fallbacks"] += 1
                if op is not None:
                    op.note("delta", shard=name, outcome="cas_conflict")
                meta, _ = upload_object(
                    backend, name, payload, part_bytes,
                    if_generation_match=None,
                    part_recorder=part_recorder,
                )
        except Exception as e:  # noqa: BLE001 — per-shard failure is data
            stats["errors"] += 1
            if op is not None:
                op.finish(error=e)
            continue
        tracker.adopt(name, meta.generation, crc)
        stats["uploaded_shards"] += 1
        stats["bytes_uploaded"] += len(payload)
        if op is not None:
            op.mark("delta_commit", clock_ns())
            op.finish(len(payload))
    if stats["errors"] == 0:
        # Publish-last discipline: the manifest only moves after an
        # error-free pass, so a crashed save never dangles pointers.
        backend.write(manifest_name(manifest.prefix),
                      manifest.to_json().encode())
    return stats
