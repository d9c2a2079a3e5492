"""The ckpt-save upload driver: one object through a resumable session
(a copy of ``tpubench/lifecycle/upload.py``).

Streams an object's bytes through ``backend.open_write`` in
``part_bytes``-sized content-range parts, stamping the lifecycle flight
phases (``upload_open`` at session open — before any connection work, so
the phase order survives pooled-connection reuse — ``part_sent`` at the
first committed part, ``upload_complete`` at finalize) and a ``part``
note per committed part. Part-level retry/backoff is NOT here: it rides
the backend stack's
:class:`~tpubench_torch.storage.retrying._ResumingWriter`
(the read path's resume discipline, mirrored), so hedge/watchdog/breaker
and the gax policy compose underneath exactly like they do for reads.
"""

from __future__ import annotations

import time
import zlib
from typing import Optional

from tpubench_torch.obs.flight import annotate as flight_annotate
from tpubench_torch.obs.flight import note_phase as flight_note
from tpubench_torch.storage.base import ObjectMeta


def upload_object(
    backend,
    name: str,
    data,
    part_bytes: int,
    *,
    if_generation_match: Optional[int] = None,
    part_recorder=None,
) -> tuple[ObjectMeta, dict]:
    """Upload ``data`` (any buffer) as ``name`` in resumable parts.

    Returns ``(meta, stats)`` where stats carries ``parts``,
    ``resumed_parts`` (from the resuming writer, 0 on raw backends) and
    ``bytes``. ``part_recorder`` (a LatencyRecorder) gets one sample per
    part — the save scorecard's part p50/p99. On failure the session is
    aborted (best-effort) and the error re-raised.
    """
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    total = len(mv)
    flight_note("upload_open")
    writer = backend.open_write(name, if_generation_match=if_generation_match)
    parts = 0
    try:
        off = 0
        while off < total:
            n = min(part_bytes, total - off)
            t0 = time.perf_counter_ns()
            writer.write(mv[off:off + n])
            dt = time.perf_counter_ns() - t0
            if part_recorder is not None:
                part_recorder.record_ns(dt)
            parts += 1
            flight_note("part_sent")
            flight_annotate("part", bytes=n, ms=round(dt / 1e6, 3))
            off += n
        meta = writer.finalize()
        flight_note("upload_complete")
    except BaseException:
        writer.abort()
        raise
    if meta.size != total:
        # A finalize that committed the wrong byte count is corruption,
        # not a transport hiccup — surface it loudly.
        raise IOError(
            f"upload {name}: finalized {meta.size} bytes, sent {total}"
        )
    return meta, {
        "parts": parts,
        "resumed_parts": int(getattr(writer, "resumed_parts", 0)),
        "bytes": total,
    }


def readback_crc32(backend, name: str, size: int,
                   granule: int = 1 << 20) -> int:
    """crc32 of the object's stored bytes (the zero-corrupt-finalizes
    verifier): streamed through a reused granule, never materializing
    the object."""
    reader = backend.open_read(name)
    buf = memoryview(bytearray(granule))
    crc = 0
    got = 0
    try:
        while got < size:
            n = reader.readinto(buf)
            if n <= 0:
                break
            crc = zlib.crc32(buf[:n], crc)
            got += n
    finally:
        reader.close()
    if got != size:
        raise IOError(f"readback {name}: short read {got}/{size}")
    return crc & 0xFFFFFFFF
