"""Checkpoint save/restore workloads (``ckpt-save`` / ``ckpt-restore``;
``tpubench/workloads/ckpt.py``).

* **ckpt-save** — a sharded-model manifest of ``lifecycle.objects``
  shard-objects streamed out through resumable multi-part uploads
  (session → content-range parts → finalize), with part-level
  retry/resume riding the backend stack's resuming writer. Scorecard:
  save goodput, part p50/p99, resumed-part count, and ZERO corrupt
  finalizes (readback crc32 vs the manifest). Device-free, as in
  ``tpubench``; the manifest is written last, and only when every object
  finalized with the bytes the manifest names (the readiness marker).
* **ckpt-restore** — the manifest read back and every object fetched as
  lane-aligned byte-range shards (``dist.shard``), one per rank of the
  pod: rank r fetches shard r of every object into page-locked host
  buffers (allocated and touched before the timed window, as
  ``tpubench`` prefaults its buffers outside it), verifies the bytes
  against the manifest's crc32s and stages them onto its device
  (:func:`~tpubench_torch.dist.reassemble.shard_to_device_array`), the
  stage time ending when the copies' events are synchronized.
  **time-to-restore** = fetch + stage is the headline metric.

Where ``tpubench`` fetches all ``n_shards`` shards of an object in one
process and lays them over its mesh (8 on its simulated CPU mesh), a rank
here holds one shard: ``shards_per_object`` is the pod's world size (1 on
the card). The manifest has one crc32 per object, so at several ranks
each rank's shard crc32s are all-gathered and combined in rank order
(:func:`crc32_combine`): a corrupted shard on any rank makes ``verified``
false, and ``errors`` at least 1, on every rank.

No silent degrade: with ``lifecycle.restore_device`` on, the restore
stages onto ``device`` (CUDA unless the caller asks for the CPU) or
raises; ``restore_device = False`` is the only host-RAM restore, and its
result says ``staged: false``. The staged tensors are not kept in the
result (tests and ``chip_smoke.py`` see them by wrapping
``dist.reassemble.shard_to_device_array``).
"""

from __future__ import annotations

import contextlib
import time
import zlib
from typing import Optional


from tpubench_torch.config import BenchConfig
from tpubench_torch.lifecycle.manifest import (
    CkptManifest,
    build_manifest,
    manifest_name,
    read_manifest,
    shard_content,
)
from tpubench_torch.lifecycle.upload import readback_crc32, upload_object
from tpubench_torch.metrics import LatencyRecorder, merge_recorders
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs.flight import (
    flight_from_config,
    rank_journal_path,
    transport_label,
)
from tpubench_torch.storage import open_backend
from tpubench_torch.workloads.common import WorkerGroup, fetch_shard

def _flight_finish(cfg: BenchConfig, flight, res: RunResult,
                   workload: str) -> None:
    """Journal/summary stamping tail (the read workload's discipline)."""
    if flight is None:
        return
    res.extra["flight"] = flight.summary()
    if cfg.obs.flight_journal:
        jpath = rank_journal_path(cfg)
        res.extra["flight_journal"] = flight.write_journal(
            jpath, extra={"workload": workload},
            max_bytes=cfg.obs.journal_max_bytes,
        )


def _activate(flight):
    return flight.activate() if flight is not None else contextlib.nullcontext()


def run_ckpt_save(
    cfg: BenchConfig, backend=None, manifest: Optional[CkptManifest] = None,
) -> RunResult:
    lc = cfg.lifecycle
    owns = backend is None
    backend = backend or open_backend(cfg)
    flight = flight_from_config(cfg)
    tlabel = transport_label(cfg)
    manifest = manifest or build_manifest(lc.prefix, lc.objects,
                                          lc.object_bytes)
    n_workers = min(lc.writers, len(manifest.objects))
    part_recs = [LatencyRecorder(f"part{i}") for i in range(n_workers)]
    obj_recs = [LatencyRecorder(f"obj{i}") for i in range(n_workers)]
    parts = [0] * n_workers
    resumed = [0] * n_workers
    uploaded = [0] * n_workers
    corrupt = [0] * n_workers

    def worker(i: int, cancel) -> None:
        ring = flight.worker(f"save{i}") if flight is not None else None
        for spec in manifest.objects[i::n_workers]:
            if cancel.is_set():
                break
            data = shard_content(spec.name, spec.size)
            t0 = time.perf_counter_ns()
            op = (
                ring.begin(spec.name, tlabel, enqueue_ns=t0, kind="upload")
                if ring is not None else None
            )
            try:
                _meta, stats = upload_object(
                    backend, spec.name, data.data, lc.part_bytes,
                    part_recorder=part_recs[i],
                )
            except BaseException as e:
                if op is not None:
                    op.finish(error=e)
                raise
            obj_recs[i].record_ns(time.perf_counter_ns() - t0)
            if op is not None:
                op.finish(stats["bytes"])
            parts[i] += stats["parts"]
            resumed[i] += stats["resumed_parts"]
            uploaded[i] += stats["bytes"]
            if lc.verify and readback_crc32(
                backend, spec.name, spec.size
            ) != spec.crc32:
                # A finalize that committed wrong bytes is the one
                # failure a resumable upload may NEVER have.
                corrupt[i] += 1

    t0 = time.perf_counter()
    try:
        with _activate(flight):
            gres = WorkerGroup(
                abort_on_error=cfg.workload.abort_on_error
            ).run(n_workers, worker, name="ckpt-save")
        # The manifest lands LAST, through the one-shot media path: it is
        # restore's readiness marker, so a failed or corrupt shard (under
        # abort_on_error=False) publishes none.
        if gres.error_count == 0 and sum(corrupt) == 0:
            backend.write(
                manifest_name(lc.prefix), manifest.to_json().encode()
            )
        wall = time.perf_counter() - t0
    finally:
        if owns:
            backend.close()
    total = sum(uploaded)
    part_all = merge_recorders(part_recs)
    res = RunResult(
        workload="ckpt_save",
        config=cfg.to_dict(),
        bytes_total=total,
        wall_seconds=wall,
        gbps=(total / 1e9) / wall if wall > 0 else 0.0,
        gbps_per_chip=(total / 1e9) / wall if wall > 0 else 0.0,
        summaries={
            "part": summarize_ns(part_all),
            "object_upload": summarize_ns(merge_recorders(obj_recs)),
        } if part_all.size else {},
        errors=gres.error_count + sum(corrupt),
    )
    res.extra["lifecycle"] = {
        "op": "save",
        "objects": len(manifest.objects),
        "bytes": total,
        "parts": sum(parts),
        "part_bytes": lc.part_bytes,
        "goodput_gbps": res.gbps,
        "part_latency": (
            summarize_ns(part_all).to_dict() if part_all.size else None
        ),
        "resumed_parts": sum(resumed),
        "corrupt_finalizes": sum(corrupt),
        "verified": bool(lc.verify) and sum(corrupt) == 0,
        "worker_errors": gres.error_count,
    }
    _flight_finish(cfg, flight, res, "ckpt_save")
    return res


# ------------------------------------------------------------- crc32 ----


def _gf2_times(mat: list, vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: list) -> list:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of ``A + B`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``
    (zlib's ``crc32_combine``, which Python's ``zlib`` does not expose):
    ``crc1`` is advanced over ``len2`` zero bytes by repeated squaring of
    the one-zero-bit operator in GF(2), then xored with ``crc2``."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    odd = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    even = _gf2_square(odd)  # two zero bits
    odd = _gf2_square(even)  # four zero bits
    crc1 &= 0xFFFFFFFF
    while True:
        even = _gf2_square(odd)  # first pass: one zero byte
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def _pod_verdict(crcs: list, lengths: list, failed: int, world: int,
                 group=None) -> tuple[list, int]:
    """Every rank's view of the pod: ``(object crc32s, failed ranks)``.
    At one rank the rank's own; at several, each rank's shard crc32s,
    shard lengths and fetch-failure flag are all-gathered and the crc32s
    combined in rank order (shard r follows shard r-1 in the object)."""
    if world == 1:
        return crcs, failed
    import torch.distributed as dist

    views: list = [None] * world
    dist.all_gather_object(views, (crcs, lengths, failed), group=group)
    combined = list(views[0][0])
    for oi in range(len(combined)):
        for r in range(1, world):
            combined[oi] = crc32_combine(
                combined[oi], views[r][0][oi], views[r][1][oi]
            )
    return combined, sum(v[2] for v in views)


def _world() -> tuple[int, int, object]:
    """(world size, rank, group) of the joined process group; a process
    in no group is a pod of one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1, 0, None
    return dist.get_world_size(), dist.get_rank(), dist.group.WORLD


def run_ckpt_restore(cfg: BenchConfig, backend=None,
                     device="cuda") -> RunResult:
    """Restore ``<prefix>MANIFEST.json``'s checkpoint: this rank's shard of
    every object onto ``device`` (or host RAM only under
    ``lifecycle.restore_device = False``). At several ranks the process
    group must be joined (``cli.execute`` brings one up)."""
    from tpubench_torch.dist.shard import ShardTable
    from tpubench_torch.staging.device import new_slot

    lc = cfg.lifecycle
    lane = cfg.staging.lane
    use_device = lc.restore_device
    pod = None
    if use_device:
        from tpubench_torch.dist.reassemble import make_mesh

        # Raises without CUDA unless the caller asked for the CPU, and
        # without a joined group: never a host-RAM fallback.
        pod = make_mesh(axis=cfg.dist.mesh_axis, device=device)
        world, rank, group = pod.size, pod.rank, pod.group
    else:
        world, rank, group = _world()
    owns = backend is None
    backend = backend or open_backend(cfg)
    flight = flight_from_config(cfg)
    tlabel = transport_label(cfg)
    try:
        manifest = read_manifest(backend, lc.prefix)
        tables = [
            ShardTable.build(spec.size, world, align=lane)
            for spec in manifest.objects
        ]
        shards = [t.shard(rank) for t in tables]
        # Destination buffers, made and touched before the timed window:
        # page-locked on CUDA (their copies to the card are then
        # asynchronous), plain host memory otherwise.
        pinned = pod is not None and pod.device.type == "cuda"
        slots = [
            new_slot((t.shard_bytes // lane, lane), pinned) for t in tables
        ]
        for s in slots:
            s.fill_(0)
        buffers = [s.numpy().reshape(-1) for s in slots]
        n_objects = len(manifest.objects)
        n_workers = max(1, min(lc.readers, n_objects))

        def fetch(i: int, cancel) -> None:
            ring = flight.worker(f"restore{i}") if flight is not None else None
            for oi in range(i, n_objects, n_workers):
                if cancel.is_set():
                    break
                spec = manifest.objects[oi]
                op = ring.begin(spec.name, tlabel) if ring is not None else None
                try:
                    fetch_shard(backend, spec.name, tables[oi], rank,
                                buffers[oi])
                except BaseException as e:
                    if op is not None:
                        op.finish(error=e)
                    raise
                if op is not None:
                    op.mark("body_complete")
                    op.finish(shards[oi].length)

        # ---- fetch: this rank's shard of every object, fanned over readers
        failure: Optional[BaseException] = None
        t0 = time.perf_counter()
        try:
            with _activate(flight):
                gres = WorkerGroup(
                    abort_on_error=cfg.workload.abort_on_error
                ).run(n_workers, fetch, name="ckpt-restore")
            fetch_errors = gres.error_count
        except BaseException as e:  # noqa: BLE001 — re-raised after the verdict
            failure, fetch_errors = e, 1
        t_fetch = time.perf_counter() - t0

        # ---- verify: byte identity against the manifest's crc32s --------
        # (the pod exchanges its verdict even when this rank failed, so
        # no rank waits on a collective another never joins)
        crcs = [
            zlib.crc32(memoryview(buffers[oi])[:shards[oi].length]) & 0xFFFFFFFF
            if lc.verify and failure is None else 0
            for oi in range(n_objects)
        ]
        lengths = [sh.length for sh in shards]
        pod_crcs, failed_ranks = _pod_verdict(
            crcs, lengths, int(fetch_errors > 0), world, group
        )
        if failure is not None:
            raise failure
        # Another rank's failed fetch counts here too: a checkpoint with a
        # hole anywhere is not restored on any rank.
        others_failed = failed_ranks - int(fetch_errors > 0)
        verify_fail = sum(
            c != spec.crc32 for c, spec in zip(pod_crcs, manifest.objects)
        ) if lc.verify else 0

        # ---- stage: shard buffers → this rank's device ------------------
        t_stage = 0.0
        if pod is not None:
            from tpubench_torch.dist.reassemble import shard_to_device_array

            t0 = time.perf_counter()
            staged = [
                shard_to_device_array([s], pod, lane) for s in slots
            ]
            for st in staged:
                st.event.synchronize()
            t_stage = time.perf_counter() - t0
            del staged
        time_to_restore = t_fetch + t_stage
    finally:
        if owns:
            backend.close()

    total = manifest.total_bytes
    n_chips = world if pod is not None else 1
    res = RunResult(
        workload="ckpt_restore",
        config=cfg.to_dict(),
        bytes_total=total,
        wall_seconds=time_to_restore,
        gbps=(total / 1e9) / time_to_restore if time_to_restore > 0 else 0.0,
        gbps_per_chip=(
            (total / 1e9) / time_to_restore / world
            if time_to_restore > 0 else 0.0
        ),
        n_chips=n_chips,
        errors=fetch_errors + others_failed + verify_fail,
    )
    res.extra["lifecycle"] = {
        "op": "restore",
        "objects": n_objects,
        "bytes": total,
        "time_to_restore_s": time_to_restore,
        "fetch_seconds": t_fetch,
        "stage_seconds": t_stage,
        "goodput_gbps": res.gbps,
        "staged": pod is not None,
        "shards_per_object": world,
        "verified": (
            verify_fail == 0 and others_failed == 0 if lc.verify else None
        ),
        "worker_errors": fetch_errors,
    }
    _flight_finish(cfg, flight, res, "ckpt_restore")
    return res
