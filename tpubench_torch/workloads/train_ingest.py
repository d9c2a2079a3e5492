"""``train-ingest`` — step-paced training-loop ingest with data-stall
accounting (``tpubench/workloads/train_ingest.py``).

Every other workload issues cold, demand-driven reads: fetch and
consumption never overlap, which is exactly the effect that dominates
real input pipelines. This workload emulates the consumer side of a
training job — a step loop that each step consumes a *batch* of chunks,
stages them to the card, then "computes" for a configurable synthetic
window — on top of the pipeline (host chunk cache + readahead
prefetcher), and measures what an input pipeline is for:

* **data-stall time per step** — the time the step loop spent blocked
  waiting for bytes that were not ready (p50/p99 per-step stall ms, and
  the stalled-step fraction over ``pipeline.stall_threshold_ms``);
* **cache hit ratio** — including the re-epoch pass, where a warm cache
  serves repeats without touching storage;
* **prefetch efficiency** — prefetched-and-used vs wasted bytes.

The A/B that matters: the same run with ``pipeline.readahead=0`` (cold,
demand-only) against readahead on. Both arms go through the same
cache/fetch code, so the delta is the overlap.

Chunks land in page-locked slabs (:mod:`tpubench_torch.mem`). On the
overlapped copy ring (``device_put``, depth > 1, no validation) each slab
is copied to the card in place (``DevicePutStager.submit_owned``) and its
lease goes back to the pool when the copy's event completes; the serial
ring (validation: ``tb_checksum`` per slot) and the landing ring
(``pallas``: ``tb_land`` per slot) fill their slots from the slab.

Step records land in the flight journal as ``kind="step"`` with
``stall_begin``/``stall_end`` bracketing the step's data wait; chunk
accesses carry ``cache_hit``/``cache_miss``/``prefetch_issue`` phases —
``report timeline`` attributes stalls from the same journal.

Pod path (``pipeline.pod``): each step's batch is one logical object;
each rank stages its own lane-aligned byte-range shard of it from a
page-locked buffer (one set per shard shape, kept across steps) and the
pod all-gathers the shards over NCCL, with the pod's checksum
(``tb_checksum``) — instead of the per-host slot ring. ``n_chips`` is
the pod's size: one rank per card here, where ``tpubench`` counts the
chips of its mesh.

Cooperative cache (``coop.enabled``, :mod:`tpubench_torch.pipeline.
coop`): demand and prefetch misses alike route through ``CoopCache.fetch``
— a chunk whose consistent-hash owner is a peer comes over the peer
channel instead of from origin, and the result carries the
``pipeline.coop`` stamp. The lockstep channel (``coop.channel="ici"``,
the pod's all-gather) needs the plan-synchronized pod path
(``--pipeline-pod --readahead 0``) and never demotes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from tpubench_torch.config import (
    BenchConfig,
    refuse_unported,
    validate_pipeline_config,
)
from tpubench_torch.device import DeviceLike, resolve_device, synchronize
from tpubench_torch.dist.reassemble import (
    make_mesh,
    make_reassemble,
    shard_to_device_array,
)
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.mem.slab import (
    CopyMeter,
    SlabLease,
    SlabPool,
    payload_view,
    release_payload,
)
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.metrics.recorder import LatencyRecorder
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs import tracing as _tracing
from tpubench_torch.obs.flight import (
    flight_from_config,
    rank_journal_path,
    transport_label,
)
from tpubench_torch.obs.profiling import (
    StepProfiler,
    annotate,
    parse_profile_steps,
)
from tpubench_torch.obs.telemetry import telemetry_from_config
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.pipeline.coop import coop_from_config
from tpubench_torch.pipeline.prefetch import Prefetcher, fetch_chunk
from tpubench_torch.staging.device import make_sink_factory, new_slot
from tpubench_torch.staging.stats import staging_extra
from tpubench_torch.storage import collect_tail_stats, open_backend
from tpubench_torch.storage.base import StorageBackend, iter_ranges
from tpubench_torch.tune.controller import (
    prefetch_workers_ceiling as _pf_ceiling,
)


def build_plan(cfg: BenchConfig, backend: StorageBackend) -> list[ChunkKey]:
    """One epoch's ordered chunk access plan: ``steps × batch_shards``
    chunk keys walked object-by-object (wrapping when the dataset is
    smaller than an epoch), each keyed by the object's CURRENT
    generation — an overwritten object yields new keys, and the cache
    invalidates the stale generation's chunks on first sight."""
    w, p = cfg.workload, cfg.pipeline
    chunk = p.chunk_bytes or w.granule_bytes
    n_objects = max(w.workers, w.threads, 1)
    needed = p.steps * p.batch_shards
    plan: list[ChunkKey] = []
    obj_chunks: list[list[ChunkKey]] = []
    for i in range(n_objects):
        name = f"{w.object_name_prefix}{i}"
        meta = backend.stat(name)
        obj_chunks.append([
            ChunkKey(w.bucket, name, meta.generation, start, length)
            for start, length in iter_ranges(meta.size, chunk)
        ])
        if sum(len(c) for c in obj_chunks) >= needed:
            break
    flat = [k for chunks in obj_chunks for k in chunks]
    if not flat:
        raise ValueError("train-ingest: dataset is empty (object_size=0?)")
    while len(plan) < needed:
        plan.extend(flat[: needed - len(plan)])
    return plan


def run_train_ingest(
    cfg: BenchConfig, backend: Optional[StorageBackend] = None,
    device: DeviceLike = "cuda",
) -> RunResult:
    """Run train-ingest on ``device`` (``"cpu"`` runs the plain versions
    of the kernels without CUDA; CUDA asked for and missing raises). The
    pod path needs a joined process group (``cli.execute`` brings up a
    one-rank group for a single process)."""
    resolve_device(device)
    refuse_unported(cfg)
    validate_pipeline_config(cfg.pipeline, staging=cfg.staging)
    p = cfg.pipeline
    chunk = p.chunk_bytes or cfg.workload.granule_bytes
    if p.readahead > 0 and p.cache_bytes < chunk:
        # Covers cache_bytes=0 through cache_bytes<chunk alike (this is
        # the ONLY guard — validate_pipeline_config runs for every
        # subcommand and must not reject non-pipeline workloads): every
        # prefetched chunk would hit the cache's oversize-skip path, be
        # counted as waste, and re-fetch on demand — ~2x the cold arm's
        # backend reads, silently. The effective chunk size is only
        # known here (chunk_bytes=0 defers to granule_bytes).
        raise SystemExit(
            f"pipeline.cache_bytes={p.cache_bytes} is smaller than one "
            f"chunk ({chunk} B) with readahead={p.readahead}: no "
            "prefetched chunk can ever be cached — raise --cache-bytes "
            "or set --readahead 0 (the cold arm)"
        )
    if p.readahead > 0 and 0 < p.readahead_bytes < chunk:
        # Sibling misconfiguration: a prefetch byte budget below one
        # chunk means advance() can never schedule anything — the
        # "readahead=N" arm would silently run cold and the A/B would
        # compare cold vs cold under different labels.
        raise SystemExit(
            f"pipeline.readahead_bytes={p.readahead_bytes} is smaller "
            f"than one chunk ({chunk} B): the prefetcher can never "
            "schedule a fetch — raise --readahead-bytes or drop it "
            "(0 = depth-bounded)"
        )
    if p.slab_pool and 0 < p.slab_bytes < chunk:
        # A slab that cannot hold one chunk makes every lease fail: the
        # run would degrade to errors, not to the bytes path. Rejected
        # here because the effective chunk size is only known now.
        raise SystemExit(
            f"pipeline.slab_bytes={p.slab_bytes} is smaller than one "
            f"chunk ({chunk} B): no chunk can be leased — raise "
            "--slab-bytes (or 0 = auto: one chunk per slab)"
        )
    if cfg.coop.enabled and cfg.coop.channel == "ici" and not (
        p.pod and p.readahead == 0
    ):
        # A lockstep (ici) channel moves bytes by COLLECTIVES every host
        # must enter together, in the same order: only the
        # plan-synchronized pod demand path qualifies. Asynchronous
        # prefetch workers — or per-host cache divergence seeded by
        # readahead — desynchronize the broadcasts and hang the pod, so
        # refuse loudly instead (before any channel is built).
        raise SystemExit(
            "coop: the ici (lockstep) channel requires the "
            "plan-synchronized pod path (--pipeline-pod) with "
            "--readahead 0; use the request/reply channel for "
            "asynchronous consumers"
        )
    owns_backend = backend is None
    backend = backend or open_backend(cfg)
    try:
        return _TrainIngest(cfg, backend, device).run()
    finally:
        if owns_backend:
            backend.close()


class _TrainIngest:
    def __init__(self, cfg: BenchConfig, backend: StorageBackend,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.backend = backend
        self.device = device
        # Pod path: one page-locked host buffer per shard shape, built at
        # the warm-up (and for a short final batch), reused every step.
        self._shard_bufs: dict = {}

    # ------------------------------------------------------------ staging --
    def _make_stager(self):
        """Per-run staging sink (the slot ring ``staging.mode`` selects),
        or None for staging mode "none" / the pod path (which stages per
        step through dist.shard/reassemble)."""
        if self.cfg.staging.mode == "none" or self.cfg.pipeline.pod:
            return None
        factory = make_sink_factory(self.cfg, device=self.device)
        return factory(0) if factory is not None else None

    def _pod_setup(self):
        pod = make_mesh(axis=self.cfg.dist.mesh_axis, device=self.device)
        return pod, make_reassemble(pod)

    def _shard_buffer(self, shard_bytes: int):
        """The page-locked (on CUDA) host buffer of one shard shape:
        ``(tensor, flat ndarray)``. Reusable across steps because every
        stage waits on its copy before returning."""
        buf = self._shard_bufs.get(shard_bytes)
        if buf is None:
            lane = self.cfg.staging.lane
            t = new_slot((shard_bytes // lane, lane),
                         pinned=torch.device(self.device).type == "cuda")
            buf = self._shard_bufs[shard_bytes] = (t, t.numpy().reshape(-1))
        return buf

    def _pod_stage_gather(self, pod, reassemble, datas: list):
        """Pod path for one step: the batch's bytes are one logical object
        split into lane-aligned byte-range shards, one per rank; this rank
        copies its own range out of the payloads (bytes or slab leases)
        into its shard buffer, stages it, and the pod all-gathers.
        Returns (staged, gather-complete) ``perf_counter_ns``."""
        lane = self.cfg.staging.lane
        total = sum(len(d) for d in datas)
        table = ShardTable.build(total, pod.size, align=lane)
        sh = table.shard(pod.rank)
        slot, flat = self._shard_buffer(table.shard_bytes)
        # Copy [sh.start, sh.start + sh.length) of the concatenated
        # payloads; the pad past it is zero, so the pod sum sees only
        # real bytes.
        off = pos = 0
        hi = sh.start + sh.length
        for d in datas:
            n = len(d)
            lo, up = max(off, sh.start), min(off + n, hi)
            if lo < up:
                flat[pos : pos + up - lo] = np.frombuffer(
                    payload_view(d), dtype=np.uint8
                )[lo - off : up - off]
                pos += up - lo
            off += n
        flat[pos:] = 0
        with annotate("train_ingest/stage"):
            staged = shard_to_device_array([slot], pod, lane)
            staged.event.synchronize()
        staged_ns = time.perf_counter_ns()
        with annotate("train_ingest/gather"):
            reassemble(staged)
            synchronize(pod.device)
        return staged_ns, time.perf_counter_ns()

    # ---------------------------------------------------------------- run --
    def run(self) -> RunResult:
        cfg, w, p = self.cfg, self.cfg.workload, self.cfg.pipeline
        plan_epoch = build_plan(cfg, self.backend)
        plan = plan_epoch * p.epochs
        batch = p.batch_shards
        total_steps = p.steps * p.epochs
        cache = ChunkCache(p.cache_bytes)
        # Zero-copy slab datapath (tpubench_torch/mem): chunks are leased
        # from a page-locked slab pool, readinto'd once off the wire,
        # cached and staged in place — the CopyMeter proves it (copies
        # stamp below). The pool is built (and page-locked) here, before
        # the timed window.
        meter = CopyMeter()
        pool: Optional[SlabPool] = None
        if p.slab_pool:
            chunk_eff = p.chunk_bytes or w.granule_bytes
            slab_bytes = p.slab_bytes or chunk_eff
            n_slabs = p.pool_slabs
            if not n_slabs:
                # Auto-size: the resident working set (cache budget in
                # CHUNKS — the cache accounts payload length, not slab
                # size — but never more than the plan's unique chunks) +
                # the readahead window + one step's batch + in-flight
                # fetch headroom. Overflow leases cover estimation error.
                resident = min(
                    p.cache_bytes // max(1, chunk_eff), len(set(plan))
                )
                n_slabs = min(
                    8192,
                    max(1, resident + p.readahead + batch
                        + p.prefetch_workers + 2),
                )
            pool = SlabPool(slab_bytes, n_slabs, device=self.device)
        tlabel = transport_label(cfg)
        flight = flight_from_config(cfg)
        consumer_wf = flight.worker("consumer") if flight is not None else None
        step_wf = flight.worker("steps") if flight is not None else None

        # Cooperative chunk cache (pipeline/coop.py): misses whose
        # consistent-hash owner is a peer resolve over the peer channel
        # instead of origin; demand and prefetch misses alike route through
        # coop.fetch, so pod-wide single-flight covers both. None when
        # cfg.coop is off — the per-host baseline arm.
        def origin_fetch(key: ChunkKey):
            return fetch_chunk(self.backend, key, pool=pool, meter=meter)

        coop = coop_from_config(
            cfg, cache, origin_fetch, pool=pool, meter=meter, flight=flight,
            device=self.device,
        )
        routed_fetch = coop.fetch if coop is not None else origin_fetch

        step_rec = LatencyRecorder("step")
        stall_rec = LatencyRecorder("stall")
        fetch_rec = LatencyRecorder("read")
        stalled_steps = 0
        consumed_bytes = 0
        compute_s = p.step_compute_ms / 1e3

        # Live telemetry (obs/telemetry.py): registry fed record-by-record
        # off the flight tap, demand-fetch latency sampled each tick, and
        # the journal streamed so `tpubench top` can watch the run.
        jpath_stream = None
        if cfg.obs.flight_journal:
            jpath_stream = rank_journal_path(cfg)
        tel = telemetry_from_config(cfg)
        if tel is not None:
            tel.resource["workload"] = "train_ingest"
            if flight is not None:
                tel.attach_flight(flight)
                if jpath_stream:
                    tel.stream_journal(
                        flight, jpath_stream,
                        extra_fn=lambda: {"workload": "train_ingest"},
                        max_bytes=cfg.obs.journal_max_bytes,
                    )
            tel.attach_recorders([fetch_rec])
            tel.start()

        # Step-windowed torch.profiler capture (obs/profiling.py): owns
        # the trace for this workload (the CLI's whole-run wrap steps
        # aside); defaults to the full step loop when no window is set.
        prof_window = parse_profile_steps(cfg.obs.profile_steps) \
            or (0, total_steps - 1)
        profiler = StepProfiler(
            cfg.obs.profile_dir, prof_window[0], prof_window[1],
            device=self.device,
        )

        stager = self._make_stager()
        pod = reassemble = None
        if p.pod:
            pod, reassemble = self._pod_setup()
            # Warm-up at a real full batch (batch × chunk): the first
            # collective pays NCCL's communicator set-up, and the shard
            # buffer of the full-batch shape is page-locked here, so no
            # step pays either (a short final batch builds its own buffer
            # once).
            chunk = p.chunk_bytes or w.granule_bytes
            self._pod_stage_gather(pod, reassemble, [bytes(batch * chunk)])

        pf: Optional[Prefetcher] = None
        controller = None
        tune_stats = None
        tel_summary = None
        tune_on = getattr(cfg, "tune", None) is not None and cfg.tune.enabled
        activation = (
            flight.activate() if flight is not None
            else contextlib.nullcontext()
        )
        t_run0 = time.perf_counter_ns()
        sink_stats: dict = {}
        # Safety net for the per-step adopt/restore pairs below: any
        # abort path that escapes a step between its adopt and restore
        # (a staging error surfacing at enqueue, a stall-guard raise)
        # must not leave a dead step's trace position installed on this
        # thread — every later trace in the process would parent under
        # it (the pod_ingest leak class).
        run_prev_ctx = _tracing.current_trace()
        try:
            with activation:
                if p.readahead > 0:
                    pf = Prefetcher(
                        self.backend, cache, plan,
                        workers=p.prefetch_workers,
                        depth=p.readahead,
                        byte_budget=p.readahead_bytes,
                        transport=tlabel,
                        pool=pool, meter=meter,
                        fetch_fn=routed_fetch if coop is not None else None,
                        # Tuning pre-spawns headroom so the
                        # prefetch_workers knob can grow the live pool
                        # (ceiling shared with the sweep axes).
                        max_workers=(
                            _pf_ceiling(p.prefetch_workers)
                            if tune_on else 0
                        ),
                    )
                    pf.advance(0)
                if tune_on:
                    controller = _build_train_ingest_controller(
                        cfg, fetch_rec, lambda: consumed_bytes,
                        self.backend, pf, len(plan), flight, stager,
                        coop=coop,
                    )
                    if controller is not None:
                        controller.start()
                step_t0 = time.perf_counter_ns()
                for step in range(total_steps):
                    profiler.on_step_begin(step)
                    lo = step * batch
                    keys = plan[lo : lo + batch]
                    op = (
                        step_wf.begin(f"step{step}", tlabel,
                                      install=False, kind="step")
                        if step_wf is not None else None
                    )
                    # The step is its trace's ROOT: every record the
                    # consumer begins inside it (cache hits, demand
                    # misses, peer hops, synchronous stage marks)
                    # parents under the step span — "workload step →
                    # demand read" is the tree's first edge. install=
                    # False keeps the step op out of the phase channel
                    # (reads own it), so the trace position is adopted
                    # explicitly and restored when the step ends.
                    step_prev_ctx = _tracing.current_trace()
                    if op is not None:
                        _tracing.adopt_trace(op.trace_context())
                    stall_ns = 0
                    first_block_ns = last_block_ns = None
                    # Chunk payloads: bytes (legacy arm) or SlabLease
                    # (zero-copy arm). Every entry carries this step's
                    # consumer reference, released after staging.
                    datas: list = []
                    for key in keys:
                        data = cache.get(key)
                        if data is not None:
                            if consumer_wf is not None:
                                cop = consumer_wf.begin(
                                    key.object, tlabel, kind="cache"
                                )
                                cop.mark("cache_hit")
                                cop.finish(len(data))
                        else:
                            cop = (
                                consumer_wf.begin(key.object, tlabel)
                                if consumer_wf is not None else None
                            )
                            t0 = time.perf_counter_ns()
                            if cop is not None:
                                cop.mark("cache_miss", t0)
                            try:
                                data, source = cache.get_or_fetch_info(
                                    key,
                                    lambda k=key: routed_fetch(k),
                                )
                            except BaseException as e:
                                # errgroup semantics (read.py parity): a
                                # demand fetch that still fails after the
                                # whole retry/tail stack aborts the run —
                                # the exception IS the error report.
                                if cop is not None:
                                    cop.finish(error=e)
                                if op is not None:
                                    op.finish(error=e)
                                _tracing.adopt_trace(step_prev_ctx)
                                raise
                            t1 = time.perf_counter_ns()
                            if source == "hit":
                                # Raced hit: a prefetch landed the chunk
                                # between the get() probe and this call.
                                # No wait happened — no stall marks, no
                                # ~0 ms sample in the read histogram,
                                # and the would-be miss record becomes a
                                # cache-hit record (abandon drops it
                                # without appending).
                                if cop is not None:
                                    cop.abandon()
                                    # enqueue_ns=t0: the record spans the
                                    # access from probe to hit — begin()'s
                                    # default "now" stamp would postdate
                                    # t1 and break phase monotonicity.
                                    hop = consumer_wf.begin(
                                        key.object, tlabel, kind="cache",
                                        enqueue_ns=t0,
                                    )
                                    hop.mark("cache_hit", t1)
                                    hop.finish(len(data))
                            else:
                                stall_ns += t1 - t0
                                if first_block_ns is None:
                                    first_block_ns = t0
                                last_block_ns = t1
                                fetch_rec.record_ns(t1 - t0)
                                if cop is not None:
                                    cop.mark("body_complete", t1)
                                    # Bytes credit the fetch OWNER only:
                                    # a coalesced wait consumed bytes
                                    # some other record (the in-flight
                                    # prefetch) already carries — the
                                    # chaos scorecard sums read records,
                                    # and one backend read must count
                                    # once.
                                    cop.finish(
                                        len(data)
                                        if source == "fetched" else 0
                                    )
                        datas.append(data)
                    if op is not None and first_block_ns is not None:
                        op.mark("stall_begin", first_block_ns)
                        op.mark("stall_end", last_block_ns)
                    # ---- stage the batch -------------------------------
                    step_bytes = sum(len(d) for d in datas)
                    if p.pod:
                        staged_ns, gathered_ns = self._pod_stage_gather(
                            pod, reassemble, datas
                        )
                        if op is not None:
                            op.mark("hbm_staged", staged_ns)
                            op.mark("gather_complete", gathered_ns)
                    elif stager is not None:
                        overlapped = getattr(stager, "overlapped", False)
                        can_own = hasattr(stager, "submit_owned")
                        for i, data in enumerate(datas):
                            if (overlapped and can_own
                                    and isinstance(data, SlabLease)):
                                # Overlapped direct staging: the copy
                                # reads straight out of the page-locked
                                # slab — no slot copy — and THIS STEP'S
                                # consumer reference rides with it,
                                # released by the window's reaper only
                                # when the copy's event completes (never
                                # at submit): the step thread does not
                                # block on the copy.
                                stager.submit_owned(data)
                                datas[i] = None
                            else:
                                # The slab view stages IN PLACE: the
                                # sink's slot fill reads straight out of
                                # the slab (no bytes() in between).
                                stager.submit(payload_view(data))
                        if op is not None and not overlapped:
                            # Synchronous staging only: an overlapped
                            # submit returns before the bytes land, so
                            # the step record carries no hbm_staged — the
                            # window's per-transfer stage records stamp
                            # it at true completion (reaper-side).
                            op.mark("hbm_staged")
                    consumed_bytes += step_bytes
                    # Drop the consumer references staging used
                    # synchronously (handed-off leases release at
                    # transfer completion instead) so evicted slabs
                    # retire.
                    for data in datas:
                        if data is not None:
                            release_payload(data)
                    stall_rec.record_ns(stall_ns)
                    if stall_ns > p.stall_threshold_ms * 1e6:
                        stalled_steps += 1
                    # Top the readahead window up BEFORE the compute
                    # window: the prefetcher works while the step
                    # "trains" — that overlap is the whole point.
                    if pf is not None:
                        pf.advance(lo + batch)
                    if (coop is not None and cfg.coop.demote
                            and not coop.lockstep
                            and flight is not None):
                        # Straggler demotion off the run's own per-host
                        # flight tables + locally-observed per-owner
                        # transfer tails (rate-limited inside). NEVER
                        # under a lockstep channel: demotion mutates the
                        # per-host ring from per-host signals, and hosts
                        # whose rings disagree enter different broadcasts
                        # — a hung or mis-sliced collective. Lockstep pods
                        # keep a static ring.
                        coop.maybe_refresh_demotions(flight)
                    if compute_s:
                        time.sleep(compute_s)
                    if op is not None:
                        op.finish(step_bytes)
                    _tracing.adopt_trace(step_prev_ctx)
                    profiler.on_step_end(step)
                    now = time.perf_counter_ns()
                    step_rec.record_ns(now - step_t0)
                    step_t0 = now
        finally:
            _tracing.adopt_trace(run_prev_ctx)
            profiler.close()
            if controller is not None:
                tune_stats = controller.stop()
            if pf is not None:
                pf.close()
            if coop is not None:
                coop.close()
            if stager is not None:
                sink_stats = stager.finish() or {}
            if tel is not None:
                # stager.finish() above drained the window's reaper, so
                # every stage record has landed: the registry is final.
                # Closed HERE (not after result assembly) so the HTTP
                # server and tick thread never outlive a failed run.
                _blk = staging_extra([sink_stats]) if sink_stats else None
                if p.pod and pod is not None:
                    tel.set_chips(pod.size)
                else:
                    tel.set_chips(int(sink_stats.get("n_chips", 1) or 1))
                tel_summary = tel.close(
                    final_extra={"staging": _blk} if _blk else None
                )
        wall = (time.perf_counter_ns() - t_run0) / 1e9

        # ------------------------------------------------------- result ----
        stall_arr = stall_rec.as_ns_array()
        pipe_extra = {
            "cache": cache.stats(),
            "prefetch": pf.stats() if pf is not None else None,
            "stall": {
                "steps": total_steps,
                "stalled_steps": stalled_steps,
                "stalled_fraction": (
                    stalled_steps / total_steps if total_steps else 0.0
                ),
                "threshold_ms": p.stall_threshold_ms,
                "total_stall_ms": float(stall_arr.sum() / 1e6),
                "p50_ms": float(np.percentile(stall_arr, 50) / 1e6)
                if stall_arr.size else 0.0,
                "p99_ms": float(np.percentile(stall_arr, 99) / 1e6)
                if stall_arr.size else 0.0,
            },
            "plan": {
                "epochs": p.epochs,
                "steps_per_epoch": p.steps,
                "batch_shards": batch,
                "chunks": len(plan),
                "unique_chunks": len(set(plan)),
                "chunk_bytes": p.chunk_bytes or w.granule_bytes,
            },
        }
        if coop is not None:
            pipe_extra["coop"] = coop.stats()
        # Copies-per-byte: the zero-copy datapath's proof (and the A/B's
        # headline axis) — host-RAM writes of chunk payload per delivered
        # byte; 1.0 = written once off the wire, never copied again.
        copies = meter.stats()
        copies["mode"] = "slab" if pool is not None else "bytes"
        if pool is not None:
            # Teardown order is load-bearing: releasing the cache's lease
            # references BEFORE closing the pool makes leaked_slabs a
            # true leak signal (a resident cache entry is not a leak).
            cache.close()
            pool.close()
            copies["pool"] = pool.stats()
            # Page-locking the pool, outside the timed window.
            pipe_extra["pool_pin_seconds"] = pool.pin_seconds
        pipe_extra["copies"] = copies
        summaries = {}
        for name, rec in (
            ("step", step_rec), ("stall", stall_rec), ("read", fetch_rec),
        ):
            if len(rec):
                summaries[name] = summarize_ns(rec.as_ns_array())
        stage_rec = sink_stats.get("stage_recorder")
        if stage_rec is not None and len(stage_rec):
            summaries["stage"] = stage_rec.summarize()
        if p.pod and pod is not None:
            # Pod path has no stager stats: the batch was staged across
            # the whole pod (pod_ingest parity — per-chip bandwidth must
            # divide by the pod's size, not default to 1).
            n_chips = pod.size
        else:
            n_chips = max(1, int(sink_stats.get("n_chips", 1)))
        gbps = (consumed_bytes / 1e9) / wall if wall > 0 else 0.0
        # Demand-path failures abort the run (errgroup semantics), so a
        # RunResult only exists for runs whose consumption succeeded;
        # prefetch errors are advisory (the demand path re-fetched) but
        # still degradation — surface them as the run's error count, the
        # same way read.py reports recovered worker failure domains.
        errors = pipe_extra["prefetch"]["errors"] if pf is not None else 0
        res = RunResult(
            workload="train_ingest",
            config=cfg.to_dict(),
            bytes_total=consumed_bytes,
            wall_seconds=wall,
            gbps=gbps,
            gbps_per_chip=gbps / n_chips,
            n_chips=n_chips,
            summaries=summaries,
            errors=errors,
        )
        res.extra["pipeline"] = pipe_extra
        if tune_stats is not None:
            res.extra["tune"] = tune_stats
        if tel_summary is not None:
            res.extra["telemetry"] = tel_summary
        prof_info = profiler.info()
        if prof_info is not None:
            res.extra["profile"] = prof_info
        if sink_stats.get("staged_bytes"):
            res.extra["staged_bytes"] = sink_stats["staged_bytes"]
        if "checksum_ok" in sink_stats:
            # The validating and landing rings' device sum of the landed
            # bytes against the host's (as read stamps it).
            for k in ("checksum_ok", "checksum_device", "checksum_host"):
                res.extra[k] = sink_stats[k]
        staging_block = staging_extra([sink_stats])
        if staging_block is not None:
            res.extra["staging"] = staging_block
        tail_stats = collect_tail_stats(self.backend)
        if tail_stats:
            res.extra["tail"] = tail_stats
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if jpath_stream:
                res.extra["flight_journal"] = flight.write_journal(
                    jpath_stream,
                    extra={
                        "workload": "train_ingest",
                        "pipeline_copies": pipe_extra["copies"],
                        "n_chips": n_chips,
                        # Pod path stamps the pod-global chip count (the
                        # same number on every host); the local stager
                        # stamp is per-host.
                        "chips_global": bool(p.pod and pod is not None),
                    },
                    max_bytes=cfg.obs.journal_max_bytes,
                )
        return res


def _build_train_ingest_controller(cfg, fetch_rec, bytes_fn, backend, pf,
                                   plan_len, flight, stager=None, coop=None):
    """Tune controller for train-ingest: live knobs are the prefetcher's
    readahead depth / byte budget / worker fan-out (Prefetcher.reclamp /
    set_workers), the hedge delay, the overlapped copy ring's in-flight
    depth (stager.set_depth) and the cooperative cache's serve budget and
    routing switch (``peer_budget_bytes``, ``coop``; neither under a
    lockstep channel); goodput is windowed consumed bytes, the p99
    guardrail watches demand-fetch latency."""
    from tpubench_torch.storage.tail import HedgedBackend, find_tail_layer
    from tpubench_torch.tune.controller import (
        Knob,
        RecorderSampler,
        TuneController,
        hedge_delay_knob,
        readahead_ceiling,
        staging_depth_ceiling,
    )

    p = cfg.pipeline
    wanted = set(cfg.tune.knobs)
    knobs = []
    if "readahead" in wanted and pf is not None:
        hi = min(readahead_ceiling(p.readahead), max(1, plan_len))
        knobs.append(Knob(
            "readahead", p.readahead,
            lambda v: pf.reclamp(depth=v),
            lo=1, hi=hi, mode="mul",
        ))
    if "readahead_bytes" in wanted and pf is not None \
            and p.readahead_bytes > 0:
        chunk = p.chunk_bytes or cfg.workload.granule_bytes
        knobs.append(Knob(
            "readahead_bytes", p.readahead_bytes,
            lambda v: pf.reclamp(byte_budget=v),
            lo=chunk, hi=8 * p.readahead_bytes, mode="mul",
        ))
    if "prefetch_workers" in wanted and pf is not None:
        hi = pf.stats()["workers_max"]
        if hi > 1:
            knobs.append(Knob(
                "prefetch_workers", pf.active_workers, pf.set_workers,
                lo=1, hi=hi, mode="add",
            ))
    if "hedge_delay_s" in wanted and cfg.transport.tail.hedge:
        hb = find_tail_layer(backend, HedgedBackend)
        if hb is not None:
            knobs.append(hedge_delay_knob(
                cfg.transport.tail.hedge_delay_s, hb.set_hedge_delay,
            ))
    if "staging_depth" in wanted and stager is not None \
            and getattr(stager, "overlapped", False) \
            and hasattr(stager, "set_depth"):
        # In-flight leases come out of the slab pool: an explicitly
        # sized pool caps how far a grow probe may drive the window.
        pool_cap = p.pool_slabs if (p.slab_pool and p.slab_bytes > 0) else 0
        knobs.append(Knob(
            "staging_depth", stager.depth, stager.set_depth,
            lo=1, hi=staging_depth_ceiling(stager.depth, pool_cap),
            mode="mul",
        ))
    if coop is not None and coop.lockstep:
        # Per-host controllers diverge: one host parking at coop=0 stops
        # entering the collectives the others still wait in (a hung pod),
        # and the serve budget is meaningless on the broadcast path.
        # Lockstep routing is not a live knob.
        coop = None
    if "peer_budget_bytes" in wanted and coop is not None \
            and coop.peer_budget_bytes > 0:
        # A configured serve budget is live-resizable; 0 (unbounded) has
        # no meaningful probe neighborhood, so the knob stays inert.
        chunk = p.chunk_bytes or cfg.workload.granule_bytes
        knobs.append(Knob(
            "peer_budget_bytes", coop.peer_budget_bytes,
            coop.set_peer_budget,
            lo=chunk, hi=8 * coop.peer_budget_bytes, mode="mul",
        ))
    if "coop" in wanted and coop is not None:
        # Binary routing knob: the controller may discover that on this
        # pod/workload the peer round-trip loses to origin and park the
        # run at coop=0 (set_enabled takes truthy ints).
        knobs.append(Knob(
            "coop", int(coop.enabled), coop.set_enabled,
            lo=0, hi=1, mode="add",
        ))
    if not knobs:
        return None
    sampler = RecorderSampler([fetch_rec], bytes_fn)
    ring = flight.worker("tune") if flight is not None else None
    return TuneController(cfg.tune, knobs, sampler, flight_ring=ring)


# -------------------------------------------------------------- rendering --


def format_pipeline_scorecard(pipe: dict) -> str:
    """Human rendering of ``extra["pipeline"]`` (printed by the CLI and
    by ``report`` on train-ingest result files): ``tpubench``'s text."""
    stall = pipe.get("stall", {})
    cache = pipe.get("cache", {})
    pf = pipe.get("prefetch")
    plan = pipe.get("plan", {})
    lines = [
        "== ingest-pipeline scorecard ==",
        (
            f"  steps={stall.get('steps', 0)} "
            f"(epochs={plan.get('epochs', '?')}"
            f"×{plan.get('steps_per_epoch', '?')}, "
            f"batch={plan.get('batch_shards', '?')} chunks)"
        ),
        (
            f"  data stalls: stalled_steps={stall.get('stalled_steps', 0)} "
            f"({stall.get('stalled_fraction', 0.0):.1%} of steps over "
            f"{stall.get('threshold_ms', 0)} ms)  "
            f"p50={stall.get('p50_ms', 0.0):.2f} ms  "
            f"p99={stall.get('p99_ms', 0.0):.2f} ms  "
            f"total={stall.get('total_stall_ms', 0.0):.1f} ms"
        ),
    ]
    hr = cache.get("hit_ratio")
    lines.append(
        f"  cache: hits={cache.get('hits', 0)} "
        f"misses={cache.get('misses', 0)} "
        f"coalesced={cache.get('coalesced', 0)} "
        f"hit_ratio={f'{hr:.1%}' if hr is not None else 'n/a'} "
        f"evictions={cache.get('evictions', 0)} "
        f"resident={cache.get('resident_bytes', 0)}B"
        + (
            f" gen_invalidations={cache['generation_invalidations']}"
            if cache.get("generation_invalidations") else ""
        )
    )
    co = pipe.get("coop")
    if co:
        phr = co.get("peer_hit_ratio")
        est = co.get("per_host_origin_estimate_bytes", 0)
        ob = co.get("origin_bytes", 0)
        saved = (1.0 - ob / est) if est else None
        line = (
            f"  coop: hosts={co.get('active_hosts', 0)}"
            f"/{co.get('hosts', 0)} "
            f"peer_hits={co.get('peer_hits', 0)} "
            f"misses={co.get('peer_misses', 0)} "
            f"hit_ratio={f'{phr:.1%}' if phr is not None else 'n/a'} "
            f"pod_coalesced={co.get('pod_coalesced', 0)}  "
            f"origin={ob}B vs per-host-est={est}B"
            + (f" (saved {saved:.1%})" if saved else "")
        )
        if co.get("transfer_p50_ms") is not None:
            line += (
                f"  transfer p50={co['transfer_p50_ms']:.2f} ms "
                f"p99={co['transfer_p99_ms']:.2f} ms"
            )
        if co.get("demotions") or co.get("restores"):
            line += (
                f"  demotions={co.get('demotions', 0)}"
                f"/restores={co.get('restores', 0)}"
            )
        if co.get("budget_rejects"):
            line += f"  budget_rejects={co['budget_rejects']}"
        lines.append(line)
    if pf:
        eff = pf.get("efficiency")
        lines.append(
            f"  prefetch: issued={pf.get('issued', 0)} "
            f"completed={pf.get('completed', 0)} "
            f"skipped={pf.get('skipped', 0)} "
            f"cancelled={pf.get('cancelled', 0)} "
            f"errors={pf.get('errors', 0)}  "
            f"used={pf.get('used_bytes', 0)}B "
            f"wasted={pf.get('wasted_bytes', 0)}B "
            f"efficiency={f'{eff:.1%}' if eff is not None else 'n/a'}"
        )
    else:
        lines.append("  prefetch: off (cold demand reads)")
    cp = pipe.get("copies")
    if cp:
        cpb = cp.get("copies_per_byte")
        line = (
            f"  copies: mode={cp.get('mode', '?')} "
            f"{f'{cpb:.2f}/byte' if cpb is not None else 'n/a'} "
            f"(landed={cp.get('landed_bytes', 0)}B "
            f"copied={cp.get('copied_bytes', 0)}B)"
        )
        pl = cp.get("pool")
        if pl:
            line += (
                f"  pool: slabs={pl.get('slabs', 0)}"
                f"×{pl.get('slab_bytes', 0)}B "
                f"{'pinned' if pl.get('native') else 'bytearray'} "
                f"peak={pl.get('peak_leased', 0)} "
                f"overflow={pl.get('overflow_leases', 0)} "
                f"leaked={pl.get('leaked_slabs', 0)}"
            )
        lines.append(line)
    return "\n".join(lines)
