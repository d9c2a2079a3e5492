"""Streamed pod ingest (``tpubench/workloads/pod_ingest_stream.py``): a
sequence of objects through fetch → stage → gather, with the fetch of
object k+1 running while object k is staged and gathered.

``pod_ingest`` measures one object with its stages apart; this workload
ingests a stream of objects as a training job consumes a dataset. Two
sets of page-locked shard buffers alternate: a background thread fetches
object k+1's shard into set ``(k+1) % 2`` while the main loop copies
object k's out of set ``k % 2`` and gathers it over the process group.

* The fetch thread makes no CUDA call; the main loop waits on each
  stage's copy event inside the timed stage, so the copy out of a set is
  complete before the fetch of object k+2 writes into it.
* The sets are reused across objects of different sizes: every fetch
  zeroes its buffer's pad tail (``fetch_shard``, ``fetch_shards_mux``),
  and failed shards are zeroed, so no byte of an earlier object is
  gathered as padding.
* One ``reassemble`` on the first object's shape runs before the wall
  clock starts (NCCL's communicator set-up); an object of a new shape
  gets one more, uncounted call, as the reference compiles once per
  shape. A stream of N objects therefore launches ``tb_checksum`` N +
  (distinct shard shapes) times at one rank.
* The staged shard and the gather of an object are dropped at the end of
  its iteration: the stream holds one object in device memory.

The report: per-stage seconds (summed), wall time and the overlap
efficiency ``(fetch + stage + gather) / wall`` — 1.0 means no overlap, 2.0
perfect overlap.

Snapshots (``snapshot_path``) are written every 5 s and at the end;
``resume_from`` continues a stream at its snapshot's ``resume_point``,
the count of consecutive hole-free objects (an object delivered with
holes is fetched again). ``bytes`` counts complete objects only. The
format is ``tpubench``'s, so each package resumes the other's stream.
Several ranks: rank 0 keeps the bare paths, rank r uses ``<path>.p<r>``;
the ranks agree on the smallest resume point (a ``MIN`` all-reduce), and
every rank takes part in every object's hole totals, so no rank skips a
collective.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpubench_torch.config import BenchConfig, refuse_unported
from tpubench_torch.convert import stream_state
from tpubench_torch.device import resolve_device, synchronize
from tpubench_torch.dist.reassemble import (
    Pod,
    make_mesh,
    make_reassemble,
    pod_sum,
    shard_to_device_array,
)
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs.exporters import (
    PeriodicExporter,
    SnapshotWriter,
    cloud_exporter_from_config,
    load_snapshot,
)
from tpubench_torch.obs.flight import (
    adopt_op,
    flight_from_config,
    host_journal_path,
    transport_label,
)
from tpubench_torch.obs.profiling import annotate
from tpubench_torch.obs.telemetry import telemetry_from_config
from tpubench_torch.obs.tracing import trace_scope
from tpubench_torch.staging.device import new_slot
from tpubench_torch.storage import open_backend
from tpubench_torch.storage.base import StorageBackend
from tpubench_torch.workloads.common import (
    WorkerGroup,
    fetch_shard,
    fetch_shards_mux,
    global_hole_totals,
    mux_supported,
    zero_failed_shards,
)
from tpubench_torch.workloads.pod_ingest import MUX_RANGES_PER_RANK

_MOD = 1 << 32


@dataclass
class _ObjectPlan:
    name: str
    size: int
    table: ShardTable  # the gather's layout: one shard per rank
    # The mux route: the rank's shard as MUX_RANGES_PER_RANK whole ranges
    # of this finer table (as in pod_ingest).
    fine: Optional[ShardTable] = None


def _agree_resume_point(resume_point: int, pod: Pod) -> int:
    """The pod's resume point: the smallest of the ranks' (a rank whose
    snapshot is behind, or missing, makes every rank fetch the
    difference; ranks that started at different objects would leave
    collectives unmatched). One rank: identity."""
    if pod.size == 1:
        return resume_point
    t = torch.tensor([resume_point], dtype=torch.int64, device=pod.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=pod.group)
    return int(t.item())


class StreamedPodIngest:
    def __init__(
        self,
        cfg: BenchConfig,
        backend: StorageBackend,
        pod: Pod,
        n_objects: int,
        verify: bool = False,
        snapshot_path: Optional[str] = None,
        resume_from: Optional[str] = None,
    ):
        self.cfg = cfg
        self.backend = backend
        self.pod = pod
        self.n_objects = n_objects
        self.verify = verify
        self.snapshot_path = snapshot_path
        # The object sequence is deterministic (prefix + k), so a
        # snapshot's "objects_done = N" names the first N positions.
        self.resume_from = resume_from
        self._progress: dict = {"objects_done": 0, "bytes": 0}
        # Flight recorder: per-shard fetch records + one record per
        # streamed object (fetch → stage → gather), journaled per rank.
        self._flight = flight_from_config(cfg)
        self._tlabel = transport_label(cfg)

    def _plan(self, name: str, mux: bool) -> _ObjectPlan:
        lane, n = self.cfg.staging.lane, self.pod.size
        size = self.backend.stat(name).size
        if not mux:
            return _ObjectPlan(name, size, ShardTable.build(size, n, align=lane))
        fine = ShardTable.build(size, n * MUX_RANGES_PER_RANK, align=lane)
        table = ShardTable(size, n, lane, MUX_RANGES_PER_RANK * fine.shard_bytes)
        return _ObjectPlan(name, size, table, fine)

    def _fetch_local(self, plan: _ObjectPlan, buffer: np.ndarray,
                     parent_ctx=None) -> dict:
        """Fetch this rank's shard of ``plan`` into ``buffer`` (the set's
        host view, cut to the plan's shard); returns its holes."""
        rank, flight = self.pod.rank, self._flight
        if plan.fine is not None:
            k, fb = MUX_RANGES_PER_RANK, plan.fine.shard_bytes
            idx = [rank * k + j for j in range(k)]
            bufs = [buffer[j * fb:(j + 1) * fb] for j in range(k)]
            gres = fetch_shards_mux(self.backend, self.cfg, plan.name,
                                    plan.fine, idx, bufs)
            return zero_failed_shards(gres, plan.fine, bufs, idx)

        def fetch(_k: int, cancel) -> None:
            # parent_ctx (the object's span) makes the shard read its
            # child though this thread inherited no ambient context.
            with trace_scope(parent_ctx):
                op = (flight.worker(f"shard{rank}").begin(plan.name, self._tlabel)
                      if flight is not None else None)
                try:
                    fetch_shard(self.backend, plan.name, plan.table, rank,
                                buffer)
                except BaseException as e:
                    if op is not None:
                        op.finish(error=e)
                    raise
                if op is not None:
                    op.mark("body_complete")
                    op.finish(plan.table.shard(rank).length)

        gres = WorkerGroup(abort_on_error=self.cfg.workload.abort_on_error).run(
            1, fetch, name="stream-fetch"
        )
        # A failed shard is a zeroed, reported hole: with reused buffers
        # it would otherwise carry an earlier object's bytes.
        return zero_failed_shards(gres, plan.table, [buffer], [rank])

    def run(self) -> RunResult:
        cfg, pod = self.cfg, self.pod
        w = cfg.workload
        lane = cfg.staging.lane
        n, rank, dev = pod.size, pod.rank, pod.device

        names = [f"{w.object_name_prefix}{k % max(1, w.workers)}"
                 for k in range(self.n_objects)]
        mux = mux_supported(self.backend)
        plans = [self._plan(name, mux) for name in names]
        shard_bytes = max((p.table.shard_bytes for p in plans), default=lane)

        def rank_path(path: Optional[str]) -> Optional[str]:
            # Two ranks must never race on one checkpoint file.
            if not path or n == 1 or rank == 0:
                return path
            return f"{path}.p{rank}"

        snapshot_path = rank_path(self.snapshot_path)
        resume_path = rank_path(self.resume_from)

        # A torn or missing snapshot is a warning and a fresh start.
        prior = load_snapshot(resume_path) if resume_path else None
        # Objects delivered with holes do not advance resume_point;
        # objects_done counts them, and neither may regress.
        state = stream_state(prior or {})
        prior_done, prior_bytes = state["objects_done"], state["bytes"]
        prior_resume = _agree_resume_point(state["resume_point"], pod)
        start_k = min(prior_resume, self.n_objects)
        # > n_objects when a prior run got further.
        resume_point = max(prior_resume, start_k)
        size_prefix = [0]
        for p in plans:
            size_prefix.append(size_prefix[-1] + p.size)

        def complete_bytes() -> int:
            if prior is not None and resume_point > self.n_objects:
                # A prior run saw more of the stream than this one can.
                return prior_bytes
            # Never below the prior checkpoint's count.
            return max(prior_bytes,
                       size_prefix[min(resume_point, self.n_objects)])

        self._progress = {
            "objects_done": max(start_k, prior_done),
            "resume_point": resume_point,
            "bytes": complete_bytes(),
        }

        # Two page-locked host sets: fetch into one while the other stages.
        pinned = dev.type == "cuda"
        slots = [new_slot((shard_bytes,), pinned) for _ in range(2)]
        host = [s.numpy() for s in slots]
        reassemble = make_reassemble(pod)

        # Warm the first object's shape before the wall clock starts:
        # NCCL's set-up would otherwise land in the first gather.
        warmed_rows = set()
        if start_k < self.n_objects:
            rows0 = plans[start_k].table.shard_bytes // lane
            warm = shard_to_device_array([slots[0][: rows0 * lane]], pod, lane)
            warm.event.synchronize()  # set 0 is the first fetch's
            reassemble(warm)
            synchronize(dev)
            warmed_rows.add(rows0)
            del warm

        fetch_s = stage_s = gather_s = 0.0
        total_bytes = 0
        checks_ok = True
        object_checksums: list[int] = []
        # object index → {"shards", "bytes", "global"} (pod_ingest's leaf).
        object_holes: dict[int, dict] = {}

        snap_ctx = (
            SnapshotWriter(lambda: dict(self._progress), snapshot_path,
                           interval_s=5.0, process_index=rank)
            if snapshot_path else None
        )
        flight = self._flight
        flight_path = (
            host_journal_path(cfg.obs.flight_journal, rank, n)
            if flight is not None and cfg.obs.flight_journal else None
        )
        flight_ctx = (
            PeriodicExporter(
                lambda: flight.write_journal(
                    flight_path,
                    extra={"workload": "pod_ingest_stream", "n_chips": n,
                           "chips_global": True},
                    max_bytes=cfg.obs.journal_max_bytes,
                ),
                interval_s=5.0,
            )
            if flight_path else None
        )
        tel = telemetry_from_config(cfg)
        tel_summary = None
        if tel is not None:
            tel.resource["workload"] = "pod_ingest_stream"
            tel.set_chips(n)
            if flight is not None:
                tel.attach_flight(flight)
            tel.start()
        # Stream progress gauges every metrics_interval_s, and a final
        # flush.
        cloud_exp = cloud_exporter_from_config(cfg)
        cloud_periodic = None

        def flush_progress() -> None:  # t_wall0 is set below
            p = dict(self._progress)
            elapsed = time.perf_counter() - t_wall0
            cloud_exp.export_point("objects_done", float(p.get("objects_done", 0)))
            cloud_exp.export_point("bytes_ingested", float(p.get("bytes", 0)))
            cloud_exp.export_point(
                "ingest_gbps",
                (p.get("bytes", 0) / 1e9) / elapsed if elapsed > 0 else 0.0,
            )

        def timed_fetch(k: int):
            # The pool thread is reused across objects while the main loop
            # finishes each object's op: clear a stale op first, or object
            # k+1 would parent under object k.
            adopt_op(None)
            op = (flight.worker("stream").begin(plans[k].name, self._tlabel,
                                                kind="object")
                  if flight is not None else None)
            t0 = time.perf_counter()
            plan = plans[k]
            with annotate(f"fetch/obj{k}"):
                # On failure the op stays unfinished: the main loop is the
                # "stream" ring's one appender; the error aborts the run.
                holes = self._fetch_local(
                    plan, host[k % 2][: plan.table.shard_bytes],
                    parent_ctx=op.trace_context() if op is not None else None,
                )
            if op is not None:
                op.mark("body_complete")
                adopt_op(None)
            return time.perf_counter() - t0, holes, op

        pool = ThreadPoolExecutor(max_workers=1)
        t_wall0 = time.perf_counter()
        try:
            if snap_ctx:
                snap_ctx.__enter__()
            if flight_ctx:
                flight_ctx.__enter__()
            if cloud_exp is not None:
                cloud_periodic = PeriodicExporter(
                    flush_progress, cfg.obs.metrics_interval_s
                ).start()
            pending = (pool.submit(timed_fetch, start_k)
                       if start_k < self.n_objects else None)
            for k in range(start_k, self.n_objects):
                dt, holes, obj_op = pending.result()
                fetch_s += dt
                # Every rank, every object: the pod-wide hole totals.
                ghole = global_hole_totals(holes, pod)
                if ghole["shards"]:
                    object_holes[k] = {**holes, "global": ghole}
                if k + 1 < self.n_objects:
                    pending = pool.submit(timed_fetch, k + 1)

                plan = plans[k]
                rows = plan.table.shard_bytes // lane
                t0 = time.perf_counter()
                with annotate(f"stage/obj{k}"):
                    staged = shard_to_device_array(
                        [slots[k % 2][: rows * lane]], pod, lane)
                    # The set is free for the fetch of object k+2 only
                    # once this copy is complete.
                    staged.event.synchronize()
                t1 = time.perf_counter()
                stage_s += t1 - t0
                if obj_op is not None:
                    obj_op.mark("hbm_staged")
                if rows not in warmed_rows:
                    reassemble(staged)  # a new shape: uncounted
                    synchronize(dev)
                    warmed_rows.add(rows)
                    t1 = time.perf_counter()
                with annotate(f"gather/obj{k}"):
                    gathered, csum = reassemble(staged)
                    synchronize(dev)
                gather_s += time.perf_counter() - t1
                if obj_op is not None:
                    obj_op.mark("gather_complete")
                    obj_op.finish(plan.size - ghole["bytes"])
                # Delivered bytes only, pod-wide.
                total_bytes += plan.size - ghole["bytes"]
                if resume_point == k and not ghole["shards"]:
                    resume_point = k + 1
                if self.verify:
                    # The device sum of the gathered pod array, per object,
                    # so a caller can hold it against the true object bytes
                    # (stale padding would show there, not here).
                    dev_sum = int(csum.item()) % _MOD
                    object_checksums.append(dev_sum)
                    local = int(host[k % 2][: rows * lane].sum(dtype=np.uint64))
                    checks_ok = checks_ok and dev_sum == pod_sum(local, pod)
                # One object in device memory at a time.
                del staged, gathered, csum
                self._progress = {
                    "objects_done": max(k + 1, prior_done),
                    "resume_point": resume_point,
                    "bytes": complete_bytes(),
                    "fetch_seconds": fetch_s,
                    "stage_seconds": stage_s,
                    "gather_seconds": gather_s,
                }
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            if snap_ctx:
                snap_ctx.__exit__(None, None, None)
            if flight_ctx:
                flight_ctx.__exit__(None, None, None)  # final journal flush
            if cloud_periodic is not None:
                cloud_periodic.close()  # final flush
                cloud_exp.close()
            if tel is not None:
                tel_summary = tel.close()
        wall = time.perf_counter() - t_wall0

        device_s = stage_s + gather_s
        res = RunResult(
            workload="pod_ingest_stream",
            config=cfg.to_dict(),
            bytes_total=total_bytes,
            wall_seconds=wall,
            gbps=(total_bytes / 1e9) / wall if wall > 0 else 0.0,
            gbps_per_chip=((total_bytes / 1e9) / wall / n) if wall > 0 else 0.0,
            n_chips=n,
            errors=sum(v["global"]["shards"] for v in object_holes.values())
            + (0 if checks_ok else 1),
        )
        if self.resume_from:
            res.extra["resume"] = {
                "from": resume_path,  # the file this rank read
                "objects_skipped": start_k,
                "prior_bytes": prior_bytes,
                "prior_found": prior is not None,
            }
        res.extra.update({
            "objects": self.n_objects,
            "objects_this_run": self.n_objects - start_k,
            "fetch_seconds": fetch_s,
            "stage_seconds": stage_s,
            "gather_seconds": gather_s,
            # > 1.0: the fetch overlapped device work.
            "overlap_efficiency": (fetch_s + device_s) / wall if wall > 0 else 0.0,
            "verified": checks_ok if self.verify else None,
            "object_checksums": object_checksums if self.verify else None,
            "holes_by_object": {str(k): v for k, v in object_holes.items()},
        })
        if cloud_exp is not None:
            res.extra["metrics_export"] = cloud_exp.summary(cloud_periodic)
        if tel_summary is not None:
            res.extra["telemetry"] = tel_summary
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if flight_path:
                res.extra["flight_journal"] = flight_path
        return res


def run_pod_ingest_stream(
    cfg: BenchConfig,
    n_objects: int,
    backend: Optional[StorageBackend] = None,
    verify: bool = False,
    snapshot_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    device="cuda",
    pod: Optional[Pod] = None,
) -> RunResult:
    """Stream ``n_objects`` objects on ``pod``: by default every rank of
    the process group this process joined, on ``device``. The group is
    the caller's (``cli.execute`` brings it up, one rank for a single
    process)."""
    resolve_device(device)
    refuse_unported(cfg)
    pod = pod or make_mesh(axis=cfg.dist.mesh_axis, device=device)
    owns = backend is None
    backend = backend or open_backend(cfg)
    try:
        return StreamedPodIngest(
            cfg, backend, pod, n_objects, verify=verify,
            snapshot_path=snapshot_path, resume_from=resume_from,
        ).run()
    finally:
        if owns:
            backend.close()
