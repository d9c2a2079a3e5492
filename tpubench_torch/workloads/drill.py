"""``drill`` — the production incident drill: restore-while-serving on
the elastic pod, with delta checkpoint saves (a copy of
``tpubench/workloads/drill.py``).

The composed scenario production actually fears, built from the serve,
membership, coop, lifecycle and storm planes. A threaded hermetic pod
serves open-loop multi-tenant QoS traffic (arrivals plane, admission
queue, coop cache); at ``drill.kill_at_s`` the membership plane KILLS a
host (RAM gone, no goodbye); at ``drill.join_at_s`` a cold replacement
joins under the victim's id and runs a checkpoint restore THROUGH the
shared admission queue — and, on the coop arm, through the coop cache —
so restore reads, peer traffic, and gold-class fetches genuinely contend
for admission slots, cache byte budgets, and (with
``drill.meta_rate_rps``) metadata quota. Periodic checkpoint DELTA saves
(lifecycle/delta.py: per-shard dirty tracking,
``ifGenerationMatch``-guarded CAS, classified 412 full-save fallback)
ride under the same traffic on ``drill.save_interval_s``.

Restore identity is first-class QoS: restore reads carry their own
class tag (``drill.restore_class``) end-to-end — priority in the
admission heap, an owner slot in the cache byte-budget split, their own
ledger/recorder in the scorecard — never a masquerading tenant.

Restore correctness under concurrent saves: each shard's chunk keys are
built at a STAT-PINNED generation, so a delta save landing a new
generation mid-shard surfaces as the pipeline's non-transient
"generation changed under the plan" error (pipeline/prefetch.py) — a
TORN read, counted and re-read at the new generation (bounded by
``drill.restore_retries``), then crc-verified against the generation's
published crc32 (the DeltaTracker map). Byte-identity is proven, not
assumed.

The drill scorecard (``extra["drill"]``) is the robustness headline:
gold SLO during the restore window vs steady state, time-to-restore vs
time-to-rewarm, origin-byte amplification (restore bytes + serve misses
vs checkpoint size), save-pass dispositions (dirty/uploaded/skipped/CAS
conflicts), per-phase blame via the ``delta_commit``/``shard_restored``
flight phases. ``run_drill_sweep`` steps the save interval and locates
the knee. Journals carry a drill replay stamp so ``record``
makes the whole incident a named, replayable scenario.

The drill does no device work, in ``tpubench`` as here: the pod's slab
pools are unpinned host memory (``SlabPool(..., device="cpu")``,
``tpubench``'s ``use_native=False``) and restored shards stay in host
RAM. :func:`run_drill` still resolves its ``device`` as every entry
point does, so CUDA asked for and missing raises. The open loop sleeps
to each arrival's due time (``serve._Pacer``, ROADMAP C.8).
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Optional

from tpubench_torch.config import (
    BenchConfig,
    parse_sleep_scale,
    validate_drill_config,
    validate_serve_config,
)
from tpubench_torch.device import resolve_device
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.metrics.recorder import LatencyRecorder
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs.flight import (
    flight_from_config,
    rank_journal_path,
    transport_label,
)
from tpubench_torch.obs.telemetry import telemetry_from_config
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.pipeline.prefetch import fetch_chunk
from tpubench_torch.serve.qos import (
    AdmissionQueue,
    ClassLedger,
    Request,
    Tenant,
    class_budget_split,
    find_knee,
)
from tpubench_torch.storage import open_backend
from tpubench_torch.storage.base import StorageBackend
from tpubench_torch.workloads.arrivals import scaled_gaps
from tpubench_torch.workloads.serve import (
    _Pacer,
    _ShedLog,
    _in_windows,
    _merge_windows,
    build_schedule,
    membership_scorecard,
    serve_scorecard,
)

# Push attempts per restore chunk through the admission queue before the
# driver stops re-offering it and fetches direct from origin (counted as
# forced_direct — loud in the scorecard, never a hang).
_MAX_CHUNK_PUSHES = 16


def _payload_bytes(data) -> bytes:
    """Immutable snapshot of a chunk payload (bytes | memoryview |
    SlabLease) — the restore rendezvous needs bytes that outlive the
    worker's ``release_payload``."""
    if hasattr(data, "tobytes"):
        return data.tobytes()
    return bytes(data)


class _RestoreChunk:
    """One in-flight restore read: the driver's rendezvous with whichever
    serve worker (or shed path) resolves it."""

    __slots__ = ("key", "index", "event", "data", "shed", "error")

    def __init__(self, key: ChunkKey):
        self.key = key
        self.index = -1
        self.event = threading.Event()
        self.data: Optional[bytes] = None
        self.shed = False
        self.error: Optional[BaseException] = None


def run_drill(cfg: BenchConfig, backend: Optional[StorageBackend] = None,
              tracer=None, replay_source: Optional[dict] = None,
              save_interval_s: Optional[float] = None,
              device="cuda") -> RunResult:
    """One incident drill at the configured shape (``save_interval_s``
    is the sweep's per-point override). ``device`` is resolved as every
    entry point resolves it (``"cpu"`` runs without CUDA); nothing is
    staged on it."""
    resolve_device(device)
    validate_serve_config(cfg.serve)
    validate_drill_config(cfg.drill, cfg.serve)
    owns_backend = backend is None
    backend = backend or open_backend(cfg, tracer=tracer)
    try:
        return _Drill(cfg, backend, replay_source=replay_source,
                      save_interval_s=save_interval_s).run()
    finally:
        if owns_backend:
            backend.close()


class _Drill:
    """The composed incident-drill engine — the _ElasticServe shape
    (same pod construction, worker discipline, virtual-time event plan)
    plus the lifecycle arms: baseline save, periodic delta saver,
    scripted kill + cold join, the restore driver, the optional
    meta-storm mix, and the drill scorecard."""

    def __init__(self, cfg: BenchConfig, backend: StorageBackend,
                 replay_source: Optional[dict] = None,
                 save_interval_s: Optional[float] = None):
        self.cfg = cfg
        self.backend = backend
        self.replay_source = replay_source
        self.save_interval_s = (
            cfg.drill.save_interval_s if save_interval_s is None
            else save_interval_s
        )

    def run(self) -> RunResult:  # noqa: PLR0915 — the composed scenario
        from tpubench_torch.dist.membership import ElasticFabric, remap_stats
        from tpubench_torch.lifecycle.delta import DeltaTracker, delta_save
        from tpubench_torch.lifecycle.manifest import build_manifest
        from tpubench_torch.mem.slab import CopyMeter, SlabPool, release_payload
        from tpubench_torch.pipeline.coop import CoopCache, LoopbackChannel
        from tpubench_torch.storage.base import StorageError

        cfg, sc, dc, lc = self.cfg, self.cfg.serve, self.cfg.drill, \
            self.cfg.lifecycle
        backend = self.backend
        victim = dc.victim if dc.victim >= 0 else sc.hosts - 1
        rcls = dc.restore_class
        chunk = sc.chunk_bytes or cfg.workload.granule_bytes
        tlabel = transport_label(cfg)
        scale = parse_sleep_scale("drill arrival gaps")
        flight = flight_from_config(cfg)

        # ---- baseline checkpoint: the state the joiner must restore --
        manifest = build_manifest(lc.prefix, lc.objects, lc.object_bytes)
        tracker = DeltaTracker(manifest)
        save_ring = flight.worker("save") if flight is not None else None
        part_rec = LatencyRecorder("save_part")
        baseline = delta_save(
            backend, tracker, lc.part_bytes, delta=False,
            ring=save_ring, transport_label=tlabel,
            part_recorder=part_rec,
        )
        checkpoint_bytes = sum(s.size for s in manifest.objects)

        objects = backend.list(cfg.workload.object_name_prefix)
        schedule = build_schedule(cfg, backend, None, objects=objects)
        gaps = scaled_gaps([r.arrival_s for r in schedule], scale)

        # ---- QoS surfaces: serving classes + the restore class -------
        qos = sc.qos
        restore_spec = {
            "name": rcls, "share": 0.0, "weight": dc.restore_weight,
            "deadline_ms": dc.restore_deadline_ms,
            "priority": dc.restore_priority,
        }
        all_classes = list(sc.classes) + [restore_spec]
        budgets = class_budget_split(all_classes, cfg.pipeline.cache_bytes) \
            if qos else None
        restore_tenant = Tenant(
            name=f"{rcls}-0", cls=rcls, priority=dc.restore_priority,
            weight=dc.restore_weight, deadline_ms=dc.restore_deadline_ms,
            seed=0,
        )

        shed_log = _ShedLog(flight, tlabel)
        outcome: list = [None] * len(schedule)
        pending: dict[int, _RestoreChunk] = {}
        pending_lock = threading.Lock()

        def _restore_pending(req: Request) -> Optional[_RestoreChunk]:
            with pending_lock:
                return pending.get(req.index)

        def on_shed(req: Request, reason: str) -> None:
            if req.tenant.cls == rcls:
                rc = _restore_pending(req)
                if rc is not None:
                    rc.shed = True
                    rc.event.set()
            else:
                outcome[req.index] = False
            shed_log(req, reason)

        queue = AdmissionQueue(
            cap=sc.admission_cap or sc.workers, qos=qos,
            queue_limit=(sc.queue_limit or 8 * sc.workers) if qos else 0,
            on_shed=on_shed,
        )
        worker_flights = [
            flight.worker(f"serve-{i}") if flight is not None else None
            for i in range(sc.workers)
        ]

        # ---- the pod (the _ElasticServe construction) ----------------
        vnow = [0.0]
        fabric = ElasticFabric(
            sc.hosts, vnodes=cfg.coop.vnodes, clock=lambda: vnow[0],
            flight_ring=(
                flight.worker("member") if flight is not None else None
            ),
        )
        pc = cfg.pipeline
        use_pool = pc.slab_pool and chunk > 0
        slab_bytes = max(chunk, pc.slab_bytes)
        pool_slabs = pc.pool_slabs or 64
        hosts: dict[int, dict] = {}
        retired: list[dict] = []  # replaced host entries (leak accounting)

        def build_host(h: int) -> dict:
            pool = (
                SlabPool(slab_bytes, pool_slabs, device="cpu")
                if use_pool else None
            )
            meter = CopyMeter()
            cache = ChunkCache(pc.cache_bytes, owner_budgets=budgets)

            def origin_fetch(key, _pool=pool, _meter=meter):
                return fetch_chunk(backend, key, pool=_pool, meter=_meter)

            coop = CoopCache(
                cache,
                host_id=h,
                ring=fabric.ring,
                channel=LoopbackChannel(fabric.broker, h),
                origin_fetch=origin_fetch,
                pool=pool,
                meter=meter,
                enabled=True,
                peer_budget_bytes=cfg.coop.peer_budget_bytes,
                retry_cfg=cfg.transport.retry,
                flight_recorder=flight,
            )
            fabric.add_host(coop)
            return {"coop": coop, "cache": cache, "pool": pool,
                    "meter": meter, "origin": origin_fetch}

        for h in range(sc.hosts):
            hosts[h] = build_host(h)

        # ---- the incident plan + the user's extra timeline -----------
        member_plan: list = [
            (dc.kill_at_s, "kill_host", victim),
            (dc.join_at_s, "drill_join", victim),
        ]
        windows: list = [
            [dc.kill_at_s, dc.kill_at_s + sc.resize_window_s],
            [dc.join_at_s, dc.join_at_s + sc.resize_window_s],
        ]
        for t0, t1, spec in sc.membership_timeline:
            (action, host), = spec.items()
            t0, t1 = float(t0), float(t1)
            if action == "pause_host":
                member_plan.append((t0, "pause_host", int(host)))
                member_plan.append((t1, "resume_host", int(host)))
                windows.append([t0, t1 + sc.resize_window_s])
            else:
                member_plan.append((t0, action, int(host)))
                windows.append([t0, t0 + sc.resize_window_s])
        member_plan.sort(key=lambda e: e[0])
        windows = _merge_windows(windows)

        uniq_keys = list({r.key for r in schedule})
        events_out: list = []
        snapshots: list = []

        classes = sorted(
            all_classes, key=lambda c: int(c.get("priority", 0))
        )
        ledgers = {str(c["name"]): ClassLedger() for c in classes}
        recorders = {
            str(c["name"]): LatencyRecorder(f"request_{c['name']}")
            for c in classes
        }
        agg_rec = LatencyRecorder("request")
        ledger_lock = threading.Lock()
        tenant_bytes: dict[str, int] = {}
        completed_bytes = [0]
        failovers = [0]
        no_live_host_errors = [0]
        direct_origin_bytes = [0]

        for req in schedule:
            ledgers[req.tenant.cls].arrivals += 1

        def take_snapshot(t: float) -> None:
            agg = fabric.aggregate()
            with ledger_lock:
                agg["completed"] = sum(
                    led.completed for led in ledgers.values()
                )
                agg["direct_origin_bytes"] = direct_origin_bytes[0]
            snapshots.append((t, agg))

        # ---- restore driver ------------------------------------------
        restore_ring = (
            flight.worker("restore") if flight is not None else None
        )
        restore_stats = {
            "requested": False, "completed": False, "verified": False,
            "shards": len(manifest.objects), "shards_restored": 0,
            "bytes": 0, "chunks": 0, "torn_rereads": 0,
            "shed_repushes": 0, "forced_direct": 0, "errors": 0,
            "started_at_s": None, "finished_at_s": None,
            "time_to_restore_s": None, "via_coop": dc.restore_via_coop,
        }
        restore_done = threading.Event()
        stop_flag = threading.Event()
        rindex = [len(schedule)]  # restore request indices extend the
        # schedule's (outcome[] never sees them — on_shed/worker branch
        # on the restore class first)

        def _push_restore(key: ChunkKey) -> _RestoreChunk:
            rc = _RestoreChunk(key)
            with pending_lock:
                idx = rindex[0]
                rindex[0] += 1
                rc.index = idx
                pending[idx] = rc
            req = Request(
                tenant=restore_tenant, key=key, arrival_s=vnow[0],
                index=idx, host=victim,
            )
            with ledger_lock:
                ledgers[rcls].arrivals += 1
            req.enqueue_ns = time.perf_counter_ns()
            try:
                queue.push(req)
            except Exception:  # noqa: BLE001 — queue closed at the bell
                rc.shed = True
                rc.event.set()
            return rc

        def _restore_shard(spec) -> bool:
            """Restore one shard at a stat-pinned generation; returns
            True when its bytes verified against the published crc."""
            for _attempt in range(dc.restore_retries + 1):
                if stop_flag.is_set():
                    return False
                try:
                    meta = backend.stat(spec.name)
                except StorageError as e:
                    if e.transient:
                        continue  # costs one attempt, never spins
                    restore_stats["errors"] += 1
                    return False
                gen = meta.generation
                keys = [
                    ChunkKey(cfg.workload.bucket, spec.name, gen, start,
                             min(chunk, spec.size - start))
                    for start in range(0, spec.size, chunk)
                ]
                buf = bytearray(spec.size)
                torn = False
                sem = threading.BoundedSemaphore(dc.restore_inflight)
                inflight: list[tuple[_RestoreChunk, int]] = []
                ilock = threading.Lock()

                def _retire(rc: _RestoreChunk) -> None:
                    with pending_lock:
                        pending.pop(rc.index, None)

                def drain_one() -> bool:
                    """Wait out the oldest in-flight chunk; re-push on
                    shed (bounded), direct-fetch past the bound. Every
                    exit releases the inflight slot and retires the
                    rendezvous entry. Returns False on torn generation
                    (caller abandons the attempt and re-stats)."""
                    with ilock:
                        rc, pushes = inflight.pop(0)
                    try:
                        while True:
                            while not rc.event.wait(timeout=0.25):
                                if stop_flag.is_set():
                                    return True
                            _retire(rc)
                            if rc.error is not None:
                                err = rc.error
                                if (isinstance(err, StorageError)
                                        and "generation" in str(err)):
                                    return False  # torn: re-stat
                                restore_stats["errors"] += 1
                                return True
                            if rc.shed:
                                if pushes >= _MAX_CHUNK_PUSHES \
                                        or stop_flag.is_set():
                                    restore_stats["forced_direct"] += 1
                                    try:
                                        data = fetch_chunk(backend, rc.key)
                                    except StorageError:
                                        return False
                                    with ledger_lock:
                                        direct_origin_bytes[0] += len(data)
                                    buf[rc.key.start:rc.key.start
                                        + len(data)] = _payload_bytes(data)
                                    release_payload(data)
                                    return True
                                restore_stats["shed_repushes"] += 1
                                rc = _push_restore(rc.key)
                                pushes += 1
                                continue
                            buf[rc.key.start:rc.key.start
                                + len(rc.data)] = rc.data
                            restore_stats["chunks"] += 1
                            return True
                    finally:
                        _retire(rc)
                        sem.release()

                ok = True
                for key in keys:
                    while not sem.acquire(blocking=False):
                        # The window is full: wait out its oldest chunk,
                        # which frees a slot. (``tpubench`` waits on the
                        # semaphore alone, which only a drain releases,
                        # so a shard of more chunks than the window never
                        # restores: ROADMAP C.9.)
                        if stop_flag.is_set():
                            return False
                        if not drain_one():
                            ok = False
                            break
                    if not ok:
                        break
                    with ilock:
                        inflight.append((_push_restore(key), 0))
                    # Opportunistically reap ahead of the window edge.
                    while True:
                        with ilock:
                            ready = (inflight
                                     and inflight[0][0].event.is_set())
                        if not ready:
                            break
                        if not drain_one():
                            ok = False
                            break
                    if not ok:
                        break
                while ok:
                    with ilock:
                        empty = not inflight
                    if empty:
                        break
                    if not drain_one():
                        ok = False
                if not ok or stop_flag.is_set():
                    # Abandoned attempt: retire any still-in-flight
                    # rendezvous entries (their workers complete the
                    # reads as ordinary restore-class requests).
                    with ilock:
                        leftovers = list(inflight)
                        inflight.clear()
                    for rc, _ in leftovers:
                        _retire(rc)
                    if not stop_flag.is_set():
                        restore_stats["torn_rereads"] += 1
                        continue
                    return False
                crc = zlib.crc32(bytes(buf)) & 0xFFFFFFFF
                want = tracker.crc_for(spec.name, gen)
                if want is None or crc != want:
                    # Foreign/raced generation or torn assembly: the
                    # byte-identity check failed — re-stat and re-read.
                    restore_stats["torn_rereads"] += 1
                    continue
                restore_stats["bytes"] += spec.size
                restore_stats["shards_restored"] += 1
                if restore_ring is not None:
                    op = restore_ring.begin(spec.name, tlabel,
                                            kind="object")
                    op.note("restore_shard", generation=gen,
                            size=spec.size)
                    op.mark("shard_restored")
                    op.finish(0)
                return True
            restore_stats["errors"] += 1
            return False

        def restore_driver() -> None:
            restore_stats["requested"] = True
            restore_stats["started_at_s"] = vnow[0]
            t0 = time.perf_counter_ns()
            ok = True
            try:
                for spec in manifest.objects:
                    if not _restore_shard(spec):
                        ok = False
                        if stop_flag.is_set():
                            break
            except Exception:  # noqa: BLE001 — a dead restore is a drill
                # RESULT (scored as unverified), never a hung run
                restore_stats["errors"] += 1
                ok = False
            finally:
                restore_stats["time_to_restore_s"] = (
                    (time.perf_counter_ns() - t0) / 1e9
                )
                restore_stats["finished_at_s"] = vnow[0]
                restore_stats["completed"] = (
                    restore_stats["shards_restored"]
                    == restore_stats["shards"]
                )
                restore_stats["verified"] = (
                    ok and restore_stats["completed"]
                )
                restore_done.set()

        restore_thread = threading.Thread(
            target=restore_driver, name="drill-restore", daemon=True,
        )

        # ---- delta saver (rides virtual time) ------------------------
        save_passes: list[dict] = []
        saver_stop = threading.Event()
        dirty_rng = random.Random(lc.seed + 17)

        def saver() -> None:
            interval = self.save_interval_s
            if interval <= 0:
                return
            next_t = interval
            while not saver_stop.is_set():
                if vnow[0] >= next_t:
                    tracker.mutate(dirty_rng, dc.dirty_fraction)
                    try:
                        save_passes.append(delta_save(
                            backend, tracker, lc.part_bytes,
                            delta=dc.delta_saves, ring=save_ring,
                            transport_label=tlabel,
                            part_recorder=part_rec,
                        ))
                    except Exception:  # noqa: BLE001 — a failed pass is
                        # data (delta_save already classifies per-shard
                        # errors; total failure counts as a zero pass)
                        save_passes.append({"errors": 1})
                    next_t += interval
                else:
                    saver_stop.wait(0.005)

        saver_thread = threading.Thread(
            target=saver, name="drill-saver", daemon=True,
        )

        # ---- concurrent metadata storm (shared ledger) ---------------
        storm_out: dict = {}
        storm_thread = None
        if dc.meta_rate_rps > 0:
            from tpubench_torch.lifecycle.storm import StormLedger
            from tpubench_torch.workloads.meta_storm import (
                _storm_point,
                populate_meta_objects,
            )

            meta_names = populate_meta_objects(
                backend, lc.prefix, lc.meta_objects, lc.meta_object_bytes,
            )
            storm_ledger = StormLedger()

            def storm() -> None:
                try:
                    storm_out["result"] = _storm_point(
                        cfg, backend, meta_names, dc.meta_rate_rps,
                        flight, tlabel, ledger=storm_ledger,
                    )
                except Exception as e:  # noqa: BLE001 — storm failure
                    # degrades the drill's metadata arm, never the run
                    storm_out["error"] = repr(e)

            storm_thread = threading.Thread(
                target=storm, name="drill-storm", daemon=True,
            )

        # ---- membership event application ----------------------------
        def apply_event(t: float, action: str, host: int) -> None:
            vnow[0] = max(vnow[0], t)
            before = fabric.owners_of(uniq_keys)
            handoff = None
            if action == "kill_host":
                ok = fabric.kill_host(host)
            elif action == "drill_join":
                # The cold replacement: a FRESH cache + coop under the
                # victim's id (its RAM died with it), registered with
                # the fabric, then a membership join — and the restore
                # driver starts the moment the joiner is live.
                retired.append(hosts[host])
                hosts[host] = build_host(host)
                ok = fabric.rejoin_host(host)
                restore_thread.start()
            elif action == "leave_host":
                handoff = fabric.leave_host(host)
                ok = handoff is not None
            elif action == "pause_host":
                ok = fabric.pause_host(host)
            elif action == "resume_host":
                ok = fabric.resume_host(host)
            elif action == "rejoin_host":
                ok = fabric.rejoin_host(host)
            else:  # unreachable under validate_membership_timeline
                ok = False
            ev = {
                "t_s": t, "action": action, "host": host, "applied": ok,
                "epoch": fabric.membership.epoch,
            }
            ev.update(remap_stats(
                uniq_keys, before, fabric.owners_of(uniq_keys)
            ))
            if handoff is not None:
                ev["handoff"] = handoff
            events_out.append(ev)
            take_snapshot(t)

        # ---- telemetry -----------------------------------------------
        jpath_stream = None
        if cfg.obs.flight_journal:
            jpath_stream = rank_journal_path(cfg)
        tel = telemetry_from_config(cfg)
        tel_summary = None
        if tel is not None:
            tel.resource["workload"] = "drill"
            if flight is not None:
                tel.attach_flight(flight)
                if jpath_stream:
                    tel.stream_journal(
                        flight, jpath_stream,
                        extra_fn=lambda: {"workload": "drill"},
                        max_bytes=cfg.obs.journal_max_bytes,
                    )
            tel.attach_recorders([agg_rec])
            tel.start()

        # ---- the service worker (the _ElasticServe discipline, plus
        # the restore rendezvous and the coop-vs-direct restore arm) ---
        def worker(i: int) -> None:
            wf = worker_flights[i]
            while True:
                req = queue.pop()
                if req is None:
                    return
                cls = req.tenant.cls
                is_restore = cls == rcls
                t_pop = time.perf_counter_ns()
                op = None
                try:
                    host = req.host
                    if not fabric.is_dispatchable(host):
                        live = sorted(fabric.live_hosts())
                        if not live:
                            with ledger_lock:
                                no_live_host_errors[0] += 1
                            raise StorageError(
                                "no live hosts in the pod",
                                transient=False,
                            )
                        host = live[req.index % len(live)]
                        with ledger_lock:
                            failovers[0] += 1
                    entry = hosts[host]
                    cache, coop = entry["cache"], entry["coop"]
                    data = cache.get(req.key)
                    if data is not None:
                        source = "hit"
                        if wf is not None:
                            op = wf.begin(
                                req.key.object, tlabel, kind="cache",
                                enqueue_ns=req.enqueue_ns,
                            )
                            op.mark("cache_hit")
                    else:
                        if wf is not None:
                            op = wf.begin(
                                req.key.object, tlabel,
                                enqueue_ns=req.enqueue_ns,
                            )
                            op.mark("cache_miss", t_pop)
                        if is_restore and not dc.restore_via_coop:
                            # Direct-to-origin arm: the restore read
                            # bypasses coop routing (no peer hits, no
                            # pod single-flight) but still holds an
                            # admission slot and a cache budget — the
                            # A/B isolates the coop's contribution.
                            def _direct(k=req.key, e=entry):
                                d = e["origin"](k)
                                with ledger_lock:
                                    direct_origin_bytes[0] += len(d)
                                return d

                            fetcher = _direct
                        else:
                            fetcher = (
                                lambda k=req.key, c=coop: c.fetch(k)
                            )
                        data, source = cache.get_or_fetch_info(
                            req.key, fetcher,
                            owner=cls if qos else None,
                        )
                        if op is not None:
                            if source == "hit":
                                # Raced hit (the serve discipline): the
                                # would-be miss record becomes a cache
                                # record so the fetcher stays the only
                                # byte-carrying one.
                                op.abandon()
                                op = wf.begin(
                                    req.key.object, tlabel, kind="cache",
                                    enqueue_ns=req.enqueue_ns,
                                )
                                op.mark("cache_hit")
                            else:
                                op.mark("body_complete")
                    done_ns = time.perf_counter_ns()
                    met = done_ns <= req.deadline_ns
                    nbytes = len(data)
                    if is_restore:
                        rc = _restore_pending(req)
                        if rc is not None:
                            rc.data = _payload_bytes(data)
                            rc.event.set()
                    release_payload(data)
                    if op is not None:
                        op.note(
                            "serve_req", cls=cls, outcome="completed",
                            deadline_met=met, host=host,
                        )
                        op.finish(
                            nbytes if source in ("hit", "fetched") else 0
                        )
                    lat_ns = done_ns - req.enqueue_ns
                    with ledger_lock:
                        led = ledgers[cls]
                        led.completed += 1
                        led.bytes += nbytes
                        if met:
                            led.deadline_met += 1
                        tenant_bytes[req.tenant.name] = (
                            tenant_bytes.get(req.tenant.name, 0) + nbytes
                        )
                        completed_bytes[0] += nbytes
                    if not is_restore:
                        outcome[req.index] = bool(met)
                    recorders[cls].record_ns(lat_ns)
                    agg_rec.record_ns(lat_ns)
                except Exception as e:  # noqa: BLE001 — per-request domain
                    if op is not None:
                        op.finish(error=e)
                    if is_restore:
                        rc = _restore_pending(req)
                        if rc is not None:
                            rc.error = e
                            rc.event.set()
                    else:
                        outcome[req.index] = False
                    with ledger_lock:
                        ledgers[cls].errors += 1
                finally:
                    queue.done()

        threads = [
            threading.Thread(target=worker, args=(i,),
                             name=f"drill-{i}", daemon=True)
            for i in range(sc.workers)
        ]
        activation = flight.activate() if flight is not None else None
        t0 = time.perf_counter_ns()
        try:
            if activation is not None:
                activation.__enter__()
            for t in threads:
                t.start()
            saver_thread.start()
            if storm_thread is not None:
                storm_thread.start()
            take_snapshot(0.0)
            # ---- the open loop, incident interleaved -----------------
            mp_i = 0
            snap_every = max(1, len(schedule) // 64)
            rr = 0
            pacer = _Pacer()
            for req, gap in zip(schedule, gaps):
                while (mp_i < len(member_plan)
                       and member_plan[mp_i][0] <= req.arrival_s):
                    apply_event(*member_plan[mp_i])
                    mp_i += 1
                pacer.wait(gap)
                vnow[0] = max(vnow[0], req.arrival_s)
                live = sorted(fabric.live_hosts())
                req.host = live[rr % len(live)] if live else -1
                rr += 1
                req.enqueue_ns = time.perf_counter_ns()
                queue.push(req)
                if rr % snap_every == 0:
                    take_snapshot(req.arrival_s)
            while mp_i < len(member_plan):
                apply_event(*member_plan[mp_i])
                mp_i += 1
            vnow[0] = max(vnow[0], sc.duration_s)
            # Grace: serve drain + the restore's own completion bound.
            grace_s = max(1.0, 2.0 * scale)
            t_end_ns = time.perf_counter_ns() + int(grace_s * 1e9)
            while (queue.queued or queue.in_service) \
                    and time.perf_counter_ns() < t_end_ns:
                time.sleep(0.005)
            if restore_stats["requested"]:
                restore_done.wait(timeout=max(5.0, 10.0 * scale))
        finally:
            stop_flag.set()
            saver_stop.set()
            drained = queue.close()
            for t in threads:
                t.join(timeout=5.0)
            saver_thread.join(timeout=5.0)
            if restore_stats["requested"]:
                restore_thread.join(timeout=5.0)
            if storm_thread is not None:
                storm_thread.join(timeout=max(5.0, 10.0 * scale))
            take_snapshot(max(vnow[0], sc.duration_s))
            if activation is not None:
                activation.__exit__(None, None, None)
            if tel is not None:
                tel.set_chips(1)
                tel_summary = tel.close()
        wall = (time.perf_counter_ns() - t0) / 1e9

        # ---- teardown: every host entry ever built (leak detection) --
        per_host = []
        pool_leaks = 0
        fabric.close()
        for h, entry in sorted(hosts.items()):
            stats = {"host": h, "coop": entry["coop"].stats(),
                     "cache": entry["cache"].stats(),
                     "copies": entry["meter"].stats()}
            entry["cache"].close()
            if entry["pool"] is not None:
                ps = entry["pool"].close()
                pool_leaks += ps.get("leaked_slabs", 0)
                stats["pool"] = ps
            per_host.append(stats)
        for entry in retired:
            entry["cache"].close()
            if entry["pool"] is not None:
                ps = entry["pool"].close()
                pool_leaks += ps.get("leaked_slabs", 0)

        qstats = queue.stats()
        qstats["drained_at_close"] = drained
        for reason, by_cls in qstats["shed"].items():
            for cls, n in by_cls.items():
                if cls in ledgers:
                    ledgers[cls].shed += n

        serve_extra = serve_scorecard(
            sc, schedule, ledgers, recorders, tenant_bytes, qstats,
            wall, completed_bytes[0], classes,
        )
        membership = membership_scorecard(
            sc, schedule, outcome, events_out, windows, snapshots,
            per_host, failovers[0], no_live_host_errors[0], pool_leaks,
            [c for c in classes if str(c["name"]) != rcls], fabric,
        )
        drill_extra = self._drill_scorecard(
            schedule, outcome, restore_stats, save_passes, baseline,
            checkpoint_bytes, snapshots, direct_origin_bytes[0],
            events_out, storm_out, part_rec,
        )

        summaries = {}
        if len(agg_rec):
            summaries["request"] = summarize_ns(agg_rec.as_ns_array())
        for cls, rec in recorders.items():
            if len(rec):
                summaries[f"request_{cls}"] = summarize_ns(
                    rec.as_ns_array()
                )
        gbps = (completed_bytes[0] / 1e9) / wall if wall > 0 else 0.0
        errors = sum(led.errors for led in ledgers.values())
        res = RunResult(
            workload="drill",
            config=cfg.to_dict(),
            bytes_total=completed_bytes[0],
            wall_seconds=wall,
            gbps=gbps,
            gbps_per_chip=gbps,
            n_chips=1,
            summaries=summaries,
            errors=errors,
        )
        res.extra["serve"] = serve_extra
        res.extra["membership"] = membership
        res.extra["drill"] = drill_extra
        if tel_summary is not None:
            res.extra["telemetry"] = tel_summary
        from tpubench_torch.storage.tail import collect_tail_stats

        tail_stats = collect_tail_stats(backend)
        if tail_stats:
            res.extra["tail"] = tail_stats
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if jpath_stream:
                from tpubench_torch.replay.bundle import (
                    drill_replay_plan,
                    journal_replay_stamp,
                )

                s = summaries.get("request")
                # A replayed drill re-stamps the ORIGINAL bundle's
                # drill block (plan/shape rebuild identically; the
                # baseline must stay the original's) so record →
                # replay → record converges.
                src_drill = (self.replay_source or {}).get("drill")
                res.extra["flight_journal"] = flight.write_journal(
                    jpath_stream,
                    extra={
                        "workload": "drill", "n_chips": 1,
                        "replay": journal_replay_stamp(
                            cfg, schedule, objects, serve_extra,
                            rate_rps=sc.rate_rps,
                            membership=membership,
                            drill=src_drill or drill_replay_plan(
                                cfg, drill_extra, self.save_interval_s,
                            ),
                            errors=errors,
                            p99_ms=s.p99_ms if s is not None else None,
                            source=self.replay_source,
                        ),
                    },
                    max_bytes=cfg.obs.journal_max_bytes,
                )
        return res

    # --------------------------------------------------- scorecard ----
    def _drill_scorecard(self, schedule, outcome, restore_stats,
                         save_passes, baseline, checkpoint_bytes,
                         snapshots, direct_bytes, events_out, storm_out,
                         part_rec) -> dict:
        sc, dc = self.cfg.serve, self.cfg.drill

        # Gold SLO during the restore window vs steady state — by
        # ARRIVAL time (the membership-scorecard convention). The
        # restore window is [join, restore completion] in virtual time;
        # an unfinished restore extends it to end-of-run.
        r_end = restore_stats["finished_at_s"]
        w_end = (
            r_end if (r_end is not None and restore_stats["completed"])
            else sc.duration_s
        )
        # At least the resize window wide: a fast restore would
        # otherwise leave the SLO cell with no arrivals to judge.
        window = [(
            dc.join_at_s,
            max(w_end, dc.join_at_s + sc.resize_window_s),
        )]
        tally: dict = {}
        for req in schedule:
            seg = "restore_window" \
                if _in_windows(req.arrival_s, window) else "steady"
            met, tot = tally.get((seg, req.tenant.cls), (0, 0))
            tally[(seg, req.tenant.cls)] = (
                met + (1 if outcome[req.index] else 0), tot + 1
            )
        slo: dict = {"restore_window": {}, "steady": {}}
        for c in sc.classes:
            cls = str(c["name"])
            for seg in ("restore_window", "steady"):
                met, tot = tally.get((seg, cls), (0, 0))
                slo[seg][cls] = (met / tot) if tot else None

        # Origin-byte amplification: what the incident actually cost in
        # origin reads (coop-counted origin fetches + direct restore
        # fetches) against the checkpoint's own size.
        def value_at(t: float, key: str) -> int:
            v = 0
            for st, agg in snapshots:
                if st <= t:
                    v = agg.get(key, 0)
                else:
                    break
            return v

        last = snapshots[-1][1] if snapshots else {}
        origin_total = (last.get("origin_bytes", 0)
                        + last.get("direct_origin_bytes", 0))
        w0, w1 = window[0]
        w1c = min(w1, sc.duration_s)
        restore_window_origin = (
            (value_at(w1c, "origin_bytes")
             + value_at(w1c, "direct_origin_bytes"))
            - (value_at(w0, "origin_bytes")
               + value_at(w0, "direct_origin_bytes"))
        ) if snapshots else 0

        # Save-pass aggregation (the delta ledger the acceptance test
        # asserts against: delta passes upload ONLY dirty shards).
        agg_saves = {
            "passes": len(save_passes),
            "interval_s": (
                self.save_interval_s if self.save_interval_s > 0
                else None
            ),
            "delta": dc.delta_saves,
            "uploaded_shards": 0, "dirty_shards": 0, "skipped_clean": 0,
            "cas_conflicts": 0, "full_fallbacks": 0,
            "bytes_uploaded": 0, "errors": 0,
        }
        for p in save_passes:
            for k in ("uploaded_shards", "dirty_shards", "skipped_clean",
                      "cas_conflicts", "full_fallbacks", "bytes_uploaded",
                      "errors"):
                agg_saves[k] += p.get(k, 0)

        # Time-to-rewarm for the kill event (the membership scorecard
        # computed it onto the event dict) vs time-to-restore.
        rewarm = None
        for ev in events_out:
            if ev["action"] == "kill_host":
                rewarm = ev.get("time_to_rewarm_s")
                break

        part = None
        if len(part_rec):
            p = summarize_ns(part_rec.as_ns_array())
            part = {"p50_ms": p.p50_ms, "p99_ms": p.p99_ms,
                    "count": len(part_rec)}
        meta = None
        if storm_out:
            r = storm_out.get("result")
            meta = {"error": storm_out["error"]} \
                if "error" in storm_out else {
                    k: r[k] for k in (
                        "ops", "completed", "errors", "offered_rps",
                        "achieved_rps", "p50_ms", "p99_ms",
                    )
                }

        restore = dict(restore_stats)
        return {
            "arm": {
                "restore_via_coop": dc.restore_via_coop,
                "delta_saves": dc.delta_saves,
            },
            "incident": {
                "kill_at_s": dc.kill_at_s, "join_at_s": dc.join_at_s,
                "victim": (dc.victim if dc.victim >= 0
                           else sc.hosts - 1),
            },
            "restore_class": dc.restore_class,
            "restore": restore,
            "saves": agg_saves,
            "baseline_save": baseline,
            "gold_slo": slo,
            "restore_window_s": [w0, w1c],
            "time_to_rewarm_s": rewarm,
            "amplification": {
                "checkpoint_bytes": checkpoint_bytes,
                "restore_bytes": restore_stats["bytes"],
                "restore_window_origin_bytes": restore_window_origin,
                "origin_bytes_total": origin_total,
                "ratio": (origin_total / checkpoint_bytes)
                if checkpoint_bytes else None,
            },
            "save_part_latency": part,
            "meta": meta,
        }


def run_drill_sweep(cfg: BenchConfig, tracer=None,
                    device="cuda") -> RunResult:
    """``drill --drill-sweep``: step the save interval through
    ``drill.sweep_points × save_interval_s`` and emit the save-rate-vs-
    latency curve with the knee identified — where saving more often
    starts costing the gold SLO. Each point opens its own backend, as in
    ``tpubench`` (its checkpoint starts from generation 1)."""
    resolve_device(device)
    validate_serve_config(cfg.serve)
    validate_drill_config(cfg.drill, cfg.serve)
    points = []
    results = []
    base = cfg.drill.save_interval_s or 1.0
    # Largest interval first: the knee detector walks points in
    # ASCENDING offered (save) rate and compares against the lightest
    # point's p99.
    for i, mult in enumerate(
        sorted(cfg.drill.sweep_points, reverse=True)
    ):
        c = BenchConfig.from_dict(cfg.to_dict())
        # Per-point endpoint churn off (the serve-sweep policy): one
        # sweep must not bind N telemetry ports.
        c.telemetry.port = -1
        c.telemetry.enabled = False
        c.telemetry.otlp = False
        if c.obs.flight_journal:
            c.obs.flight_journal = f"{c.obs.flight_journal}.pt{i}"
        interval = base * float(mult)
        res = run_drill(c, tracer=tracer, save_interval_s=interval,
                        device=device)
        d = res.extra["drill"]
        sv = res.extra["serve"]
        gold = next(
            (str(cc["name"]) for cc in sorted(
                cfg.serve.classes,
                key=lambda cc: int(cc.get("priority", 0)),
            )), None,
        )
        gold_cls = sv["classes"].get(gold, {}) if gold else {}
        passes = d["saves"]["passes"]
        points.append({
            "save_interval_s": interval,
            # The knee detector's axes: offered load is the SAVE rate
            # (passes/s grows as the interval shrinks), achieved is the
            # save passes the run actually landed, latency is the gold
            # class's own p99 under that save pressure.
            "offered_rps": 1.0 / interval if interval > 0 else 0.0,
            "achieved_rps": (
                passes / cfg.serve.duration_s
                if cfg.serve.duration_s > 0 else None
            ),
            "p99_ms": gold_cls.get("p99_ms"),
            "goodput_gbps": sv.get("goodput_gbps", 0.0),
            "gold_slo_restore_window": (
                d["gold_slo"]["restore_window"].get(gold)
                if gold else None
            ),
            "time_to_restore_s": d["restore"]["time_to_restore_s"],
            "save_passes": passes,
            "bytes_uploaded": d["saves"]["bytes_uploaded"],
            "cas_conflicts": d["saves"]["cas_conflicts"],
        })
        results.append(res)
    knee = find_knee(points)
    out = results[-1]
    out.extra["drill_sweep"] = {"points": points, "knee": knee}
    return out


# ----------------------------------------------------------- rendering ----
def format_drill_scorecard(d: dict) -> str:
    """Human rendering of ``extra["drill"]`` — shared by the CLI and
    ``report``; ``tpubench``'s text line for line."""
    arm = d.get("arm") or {}
    inc = d.get("incident") or {}
    rst = d.get("restore") or {}
    sv = d.get("saves") or {}
    amp = d.get("amplification") or {}
    lines = [
        "  incident drill scorecard "
        f"[restore {'via coop' if arm.get('restore_via_coop') else 'direct'}"
        f", {'delta' if arm.get('delta_saves') else 'full'} saves]:",
        f"    kill host {inc.get('victim')} @ {inc.get('kill_at_s')}s  "
        f"cold join @ {inc.get('join_at_s')}s  "
        f"restore class={d.get('restore_class')!r}",
    ]
    ttr = rst.get("time_to_restore_s")
    rewarm = d.get("time_to_rewarm_s")
    lines.append(
        f"    time-to-restore="
        f"{'%.3f s' % ttr if ttr is not None else '—'}  "
        f"time-to-rewarm="
        f"{'%.3f s' % rewarm if rewarm is not None else '—'}  "
        f"verified={rst.get('verified')}  "
        f"shards={rst.get('shards_restored')}/{rst.get('shards')}"
    )
    lines.append(
        f"    restore: chunks={rst.get('chunks', 0)}  "
        f"torn_rereads={rst.get('torn_rereads', 0)}  "
        f"shed_repushes={rst.get('shed_repushes', 0)}  "
        f"forced_direct={rst.get('forced_direct', 0)}  "
        f"errors={rst.get('errors', 0)}"
    )
    slo = d.get("gold_slo") or {}
    for seg in ("restore_window", "steady"):
        cells = []
        for cls, v in sorted((slo.get(seg) or {}).items()):
            cells.append(
                f"{cls}={'%.1f%%' % (100 * v) if v is not None else '—'}"
            )
        lines.append(f"    slo[{seg}]: " + "  ".join(cells))
    lines.append(
        f"    saves: passes={sv.get('passes', 0)} "
        f"(interval={sv.get('interval_s')}s)  "
        f"uploaded={sv.get('uploaded_shards', 0)}  "
        f"dirty={sv.get('dirty_shards', 0)}  "
        f"skipped_clean={sv.get('skipped_clean', 0)}"
    )
    lines.append(
        f"    cas_conflicts={sv.get('cas_conflicts', 0)}  "
        f"full_fallbacks={sv.get('full_fallbacks', 0)}  "
        f"save_bytes={sv.get('bytes_uploaded', 0)}  "
        f"save_errors={sv.get('errors', 0)}"
    )
    ratio = amp.get("ratio")
    lines.append(
        f"    amplification: checkpoint={amp.get('checkpoint_bytes', 0)}  "
        f"restore={amp.get('restore_bytes', 0)}  "
        f"origin_total={amp.get('origin_bytes_total', 0)}  "
        f"ratio={'%.2fx' % ratio if ratio is not None else '—'}"
    )
    meta = d.get("meta")
    if meta:
        if "error" in meta:
            lines.append(f"    meta-storm: failed ({meta['error']})")
        else:
            lines.append(
                f"    meta-storm: ops={meta.get('ops', 0)}  "
                f"completed={meta.get('completed', 0)}  "
                f"errors={meta.get('errors', 0)}  "
                f"p99={meta.get('p99_ms', 0.0):.2f} ms"
            )
    return "\n".join(lines)


def format_drill_sweep(ds: dict) -> str:
    """Human rendering of ``extra["drill_sweep"]``."""
    lines = ["  save-interval sweep:"]
    for p in ds.get("points", []):
        slo = p.get("gold_slo_restore_window")
        lines.append(
            f"    interval={p['save_interval_s']:.3g}s  "
            f"passes={p.get('save_passes', 0)}  "
            f"save_bytes={p.get('bytes_uploaded', 0)}  "
            f"gold_slo_restore="
            f"{'%.1f%%' % (100 * slo) if slo is not None else '—'}  "
            f"p99={p.get('p99_ms') or 0.0:.2f} ms"
        )
    knee = ds.get("knee")
    if knee:
        lines.append(
            f"    knee @ save rate {knee.get('offered_rps', 0.0):.3g}/s "
            f"({knee.get('reason', '')})"
        )
    return "\n".join(lines)
