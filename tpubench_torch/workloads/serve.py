"""``serve`` — open-loop multi-tenant traffic plane (a copy of
``tpubench/workloads/serve.py``).

Every other workload is closed-loop: a fixed worker pool pulls
as fast as it can, so the measured operating point is always "saturated
by construction" and there is no knee to find. Production ingest is the
opposite regime — requests arrive from many tenants on their own
schedule whether or not the system keeps up — and the questions that
matter are open-loop questions: where is the saturation knee, what does
p99 do as offered load approaches it, who gets hurt past it, and does
QoS actually protect the tenants that paid for protection.

Mechanics (the full stack, nothing stubbed):

* a pre-generated **arrival schedule** (``workloads/arrivals``: Poisson,
  bursty MMPP, diurnal, replayed trace — seeded, replayable) assigns
  each arrival to one of thousands of synthetic tenants in weighted
  priority classes, each tenant drawing chunks from a shared Zipf hot
  set;
* a **dispatcher** replays the schedule in real time (gaps scaled by the
  shared ``TPUBENCH_BENCH_SLEEP_SCALE`` contract, floored so bursts stay
  bursts) into the :class:`~tpubench_torch.serve.qos.AdmissionQueue` —
  priority admission with a LIVE cap (the native executor's runnable-queue
  admission hook, tune-actuatable) and deadline-aware shedding under overload;
* **service workers** resolve each request through the chunk cache
  (weighted per-class budgets + single-flight) and the full
  ``open_backend`` stack (hedge/watchdog/breaker/retry compose under
  serve exactly as under every other workload), with optional readahead
  over the schedule (per-class prefetch byte budgets);
* the **scorecard** (``extra["serve"]``) reports per-class SLO
  attainment, p50/p99, shed counts by reason, Jain fairness over
  weight-normalized per-tenant goodput, and goodput-under-overload;
  ``run_serve_sweep`` steps offered load and locates the knee
  (``serve.qos.find_knee``).

The serve plane does no device work in ``tpubench`` and none here: it
never stages, and the elastic pod's slab pools are unpinned host memory
(``SlabPool(..., device="cpu")``, ``tpubench``'s ``use_native=False``).
:func:`run_serve` still resolves its ``device`` as every entry point
does, so CUDA asked for and missing raises.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from tpubench_torch.config import (
    BenchConfig,
    parse_sleep_scale,
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
from tpubench_torch.pipeline.cache import ChunkCache
from tpubench_torch.pipeline.prefetch import Prefetcher, fetch_chunk
from tpubench_torch.serve.qos import (
    AdmissionQueue,
    ClassLedger,
    Request,
    build_tenants,
    class_budget_split,
    find_knee,
    jain_index,
)
from tpubench_torch.storage import open_backend
from tpubench_torch.storage.base import StorageBackend
from tpubench_torch.workloads.arrivals import (
    load_trace,
    make_arrivals,
    scaled_gaps,
    zipf_keys_weights,
)


def build_schedule(cfg: BenchConfig, backend: StorageBackend,
                   rate_rps: Optional[float] = None,
                   objects: Optional[list] = None) -> list[Request]:
    """The run's merged open-loop schedule: arrival timestamps from the
    configured process, each assigned to a tenant (class-share-weighted)
    and to one chunk of that tenant's Zipf stream. Deterministic for a
    given seed — the replayed-trace property every arrival kind gets.
    ``objects`` lets the caller pass an already-fetched listing (the
    replay stamp must describe the SAME population the schedule was
    built over, never a re-listing that could race a mutating store)."""
    sc = cfg.serve
    w = cfg.workload
    chunk = sc.chunk_bytes or w.granule_bytes
    if objects is None:
        objects = backend.list(w.object_name_prefix)
    if not objects:
        raise SystemExit(
            f"serve: no objects under prefix {w.object_name_prefix!r} "
            "(run `tpubench prepare` or use --protocol fake)"
        )
    tenants = build_tenants(sc.classes, sc.tenants, seed=sc.seed)
    times = make_arrivals(
        sc.arrival, rate_rps if rate_rps is not None else sc.rate_rps,
        sc.duration_s, seed=sc.seed,
        burst_factor=sc.burst_factor, burst_fraction=sc.burst_fraction,
        burst_cycle_s=sc.burst_cycle_s,
        diurnal_period_s=sc.diurnal_period_s,
        trace=load_trace(sc.trace_path) if sc.arrival == "trace" else None,
    )
    # Tenant assignment: class share split evenly over the class's
    # tenants (traffic share and population share use the same knob).
    by_cls: dict[str, list[int]] = {}
    for i, t in enumerate(tenants):
        by_cls.setdefault(t.cls, []).append(i)
    probs = np.zeros(len(tenants), dtype=np.float64)
    share_total = sum(float(c["share"]) for c in sc.classes)
    for c in sc.classes:
        members = by_cls.get(str(c["name"]), [])
        if not members:
            continue
        per = (float(c["share"]) / share_total) / len(members)
        for i in members:
            probs[i] = per
    probs /= probs.sum()
    rng = np.random.Generator(np.random.Philox(sc.seed + 1))
    assign = rng.choice(len(tenants), size=len(times), p=probs)
    # Per-tenant Zipf chunk streams over the SHARED object set: keys
    # and the weight vector are enumerated ONCE (zipf_keys_weights) and
    # only the per-tenant rng draws differ — per-tenant zipf_plan calls
    # would redo O(chunks) setup per tenant for identical data.
    keys, weights = zipf_keys_weights(
        objects, chunk, bucket=w.bucket, alpha=sc.alpha
    )
    counts = np.bincount(assign, minlength=len(tenants))
    streams = {}
    for i, n in enumerate(counts):
        if n:
            trng = np.random.Generator(np.random.Philox(tenants[i].seed))
            streams[i] = iter(
                trng.choice(len(keys), size=int(n), p=weights)
            )
    return [
        Request(
            tenant=tenants[ti], key=keys[next(streams[ti])],
            arrival_s=float(t), index=idx,
        )
        for idx, (t, ti) in enumerate(zip(times, assign))
    ]


class _Pacer:
    """Sleeps to each arrival's due time: the dispatch's start plus the
    running sum of the scaled gaps. ``tpubench`` sleeps each gap from the
    previous push, so on a host whose short sleeps overshoot the
    overshoots add up and the schedule runs slow (any sleep under 1 ms
    took about 1.1 ms on one H100 host, where a 3,200/s schedule was
    offered at about 1,200/s). Where sleeps are exact both replay the
    same times; where they are not, this one pushes the arrivals that
    fell due during an overshoot at once, keeping the offered load."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._due = 0.0

    def wait(self, gap: float) -> None:
        self._due += gap
        left = self._t0 + self._due - time.perf_counter()
        if left > 0:
            time.sleep(left)


class _ShedLog:
    """Serialized flight-note emitter for sheds: shed callbacks fire on
    whichever thread shed (dispatcher push, worker pop, drain), and a
    WorkerFlight ring is single-appender by contract — one small lock
    keeps the breadcrumb path honest."""

    def __init__(self, flight, tlabel: str):
        self._ring = flight.worker("shed") if flight is not None else None
        self._tlabel = tlabel
        self._lock = threading.Lock()

    def __call__(self, req: Request, reason: str) -> None:
        if self._ring is None:
            return
        try:
            with self._lock:
                op = self._ring.begin(
                    req.key.object, self._tlabel, install=False,
                )
                op.note(
                    "shed", cls=req.tenant.cls, reason=reason,
                )
                op.note(
                    "serve_req", cls=req.tenant.cls, outcome="shed",
                )
                op.finish(0)
        except Exception:  # noqa: BLE001 — breadcrumbs must not shed twice
            pass


def run_serve(cfg: BenchConfig, backend: Optional[StorageBackend] = None,
              rate_rps: Optional[float] = None, tracer=None,
              replay_source: Optional[dict] = None,
              device="cuda") -> RunResult:
    """One open-loop serve run at the configured offered load (or
    ``rate_rps``, the sweep's per-point override). ``serve.hosts > 1``
    fans the same schedule across an N-host elastic pod
    (:class:`_ElasticServe`) whose membership may change mid-run.
    ``replay_source`` (set by a replay run) is the identity of the
    bundle this run re-drives; it passes through into the journal's
    replay stamp so re-recording a replay reproduces the ORIGINAL
    bundle. ``device`` is resolved as every entry point resolves it
    (``"cpu"`` runs without CUDA; CUDA asked for and missing raises);
    nothing is staged on it."""
    resolve_device(device)
    validate_serve_config(cfg.serve)
    owns_backend = backend is None
    backend = backend or open_backend(cfg, tracer=tracer)
    try:
        if cfg.serve.hosts > 1:
            return _ElasticServe(cfg, backend, rate_rps,
                                 replay_source=replay_source).run()
        return _Serve(cfg, backend, rate_rps,
                      replay_source=replay_source).run()
    finally:
        if owns_backend:
            backend.close()


class _Serve:
    def __init__(self, cfg: BenchConfig, backend: StorageBackend,
                 rate_rps: Optional[float],
                 replay_source: Optional[dict] = None):
        self.cfg = cfg
        self.backend = backend
        self.rate_rps = rate_rps
        self.replay_source = replay_source

    def run(self) -> RunResult:
        cfg, sc = self.cfg, self.cfg.serve
        chunk = sc.chunk_bytes or cfg.workload.granule_bytes
        objects = self.backend.list(cfg.workload.object_name_prefix)
        schedule = build_schedule(cfg, self.backend, self.rate_rps,
                                  objects=objects)
        tlabel = transport_label(cfg)
        scale = parse_sleep_scale("serve arrival gaps")
        gaps = scaled_gaps([r.arrival_s for r in schedule], scale)

        qos = sc.qos
        budgets = class_budget_split(sc.classes, cfg.pipeline.cache_bytes) \
            if qos else None
        cache = ChunkCache(cfg.pipeline.cache_bytes, owner_budgets=budgets)
        flight = flight_from_config(cfg)
        shed_log = _ShedLog(flight, tlabel)
        queue = AdmissionQueue(
            cap=sc.admission_cap or sc.workers, qos=qos,
            queue_limit=(sc.queue_limit or 8 * sc.workers) if qos else 0,
            on_shed=shed_log,
        )
        worker_flights = [
            flight.worker(f"serve-{i}") if flight is not None else None
            for i in range(sc.workers)
        ]

        # Per-class ledgers + latency recorders; classes sorted by
        # priority so "the high-priority class" is ledger order 0.
        classes = sorted(
            sc.classes, key=lambda c: int(c.get("priority", 0))
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

        for req in schedule:
            ledgers[req.tenant.cls].arrivals += 1

        # Readahead over the schedule (serve IS a replayed trace — the
        # plan is known ahead, train-ingest style), with per-class byte
        # budgets so one class can't monopolize the window.
        pf: Optional[Prefetcher] = None
        if sc.readahead > 0:
            plan = [r.key for r in schedule]
            owners = [r.tenant.cls for r in schedule] if qos else None
            pf_budgets = class_budget_split(
                sc.classes, sc.readahead * chunk
            ) if qos else None
            pf = Prefetcher(
                self.backend, cache, plan,
                workers=cfg.pipeline.prefetch_workers,
                depth=sc.readahead,
                byte_budget=cfg.pipeline.readahead_bytes,
                transport=tlabel,
                owners=owners, owner_budgets=pf_budgets,
            )
            pf.advance(0)

        # Live telemetry (read.py wiring): flight tap + journal stream.
        jpath_stream = None
        if cfg.obs.flight_journal:
            jpath_stream = rank_journal_path(cfg)
        tel = telemetry_from_config(cfg)
        tel_summary = None
        if tel is not None:
            tel.resource["workload"] = "serve"
            if flight is not None:
                tel.attach_flight(flight)
                if jpath_stream:
                    tel.stream_journal(
                        flight, jpath_stream,
                        extra_fn=lambda: {"workload": "serve"},
                        max_bytes=cfg.obs.journal_max_bytes,
                    )
            tel.attach_recorders([agg_rec])
            tel.start()

        def worker(i: int) -> None:
            wf = worker_flights[i]
            while True:
                req = queue.pop()
                if req is None:
                    return
                cls = req.tenant.cls
                t_pop = time.perf_counter_ns()
                op = None
                try:
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
                        data, source = cache.get_or_fetch_info(
                            req.key,
                            lambda k=req.key: fetch_chunk(self.backend, k),
                            owner=cls if qos else None,
                        )
                        if op is not None:
                            if source == "hit":
                                # Raced hit: a prefetch (or concurrent
                                # worker) landed the chunk between the
                                # get() probe and this call — the
                                # would-be miss record becomes a cache
                                # record (train-ingest discipline), so
                                # the FETCHER's read record stays the
                                # only byte-carrying one.
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
                    if op is not None:
                        # Storage-byte credit follows the owner-only
                        # discipline (goodput_summary sums kind="read"
                        # bytes; one backend read must count once):
                        # coalesced waits finish with 0, raced hits are
                        # cache records, plain hits took the cache
                        # branch above.
                        op.note(
                            "serve_req", cls=cls, outcome="completed",
                            deadline_met=met,
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
                    recorders[cls].record_ns(lat_ns)
                    agg_rec.record_ns(lat_ns)
                except Exception as e:  # noqa: BLE001 — per-request domain
                    # Open-loop serving has per-request failure domains:
                    # one tenant's failed fetch (post-retry) is an error
                    # in its ledger, never a run abort. Exception, NOT
                    # BaseException (the coop serve() discipline):
                    # KeyboardInterrupt/SystemExit must stop the worker,
                    # never count as a tenant error.
                    if op is not None:
                        op.finish(error=e)
                    with ledger_lock:
                        ledgers[cls].errors += 1
                finally:
                    queue.done()

        # Tune controller (the chaos+autotuner composition): the LIVE
        # admission cap is the "workers" knob, readahead/prefetch ride
        # their usual knobs, and the p99 guardrail samples the HIGHEST-
        # priority class's recorder — the controller defends the gold
        # SLO while chasing aggregate goodput.
        controller = None
        tune_stats = None
        tune_on = getattr(cfg, "tune", None) is not None and cfg.tune.enabled
        if tune_on:
            controller = _build_serve_controller(
                cfg, queue, pf, recorders[str(classes[0]["name"])],
                lambda: completed_bytes[0], flight,
            )

        threads = [
            threading.Thread(target=worker, args=(i,), name=f"serve-{i}",
                             daemon=True)
            for i in range(sc.workers)
        ]
        activation = flight.activate() if flight is not None else None
        t0 = time.perf_counter_ns()
        try:
            if activation is not None:
                activation.__enter__()
            for t in threads:
                t.start()
            if controller is not None:
                controller.start()
            # ---- the open loop: replay the schedule in real time ----
            pacer = _Pacer()
            for req, gap in zip(schedule, gaps):
                pacer.wait(gap)
                req.enqueue_ns = time.perf_counter_ns()
                if pf is not None:
                    pf.advance(req.index)
                queue.push(req)  # queue-overload sheds note via on_shed
            # Grace: let in-flight work drain, bounded — an overloaded
            # queue must not extend the run forever (that would be
            # closed-loop completion semantics sneaking back in).
            grace_s = max(1.0, 2.0 * scale)
            t_end = time.monotonic() + grace_s
            while (queue.queued or queue.in_service) \
                    and time.monotonic() < t_end:
                time.sleep(0.005)
        finally:
            drained = queue.close()  # leftovers shed as "drain"
            for t in threads:
                t.join(timeout=5.0)
            if controller is not None:
                tune_stats = controller.stop()
            if pf is not None:
                pf.close()
            if activation is not None:
                activation.__exit__(None, None, None)
            if tel is not None:
                tel.set_chips(1)
                tel_summary = tel.close()
        wall = (time.perf_counter_ns() - t0) / 1e9
        cache.close()

        # Merge the queue's shed ledger into the per-class ledgers
        # (shed-during-drain — `drained` leftovers at the bell — is a
        # real SLO miss and counts like any other shed).
        qstats = queue.stats()
        qstats["drained_at_close"] = drained
        for reason, by_cls in qstats["shed"].items():
            for cls, n in by_cls.items():
                if cls in ledgers:
                    ledgers[cls].shed += n

        serve_extra = self._scorecard(
            schedule, ledgers, recorders, tenant_bytes, qstats,
            wall, completed_bytes[0], classes,
        )
        if pf is not None:
            serve_extra["prefetch"] = pf.stats()
        serve_extra["cache"] = cache.stats()

        summaries = {}
        if len(agg_rec):
            summaries["request"] = summarize_ns(agg_rec.as_ns_array())
        for cls, rec in recorders.items():
            if len(rec):
                summaries[f"request_{cls}"] = summarize_ns(rec.as_ns_array())
        gbps = (completed_bytes[0] / 1e9) / wall if wall > 0 else 0.0
        errors = sum(led.errors for led in ledgers.values())
        res = RunResult(
            workload="serve",
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
        if tune_stats is not None:
            res.extra["tune"] = tune_stats
        if tel_summary is not None:
            res.extra["telemetry"] = tel_summary
        from tpubench_torch.storage.tail import collect_tail_stats

        tail_stats = collect_tail_stats(self.backend)
        if tail_stats:
            res.extra["tail"] = tail_stats
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if jpath_stream:
                from tpubench_torch.replay.bundle import journal_replay_stamp

                s = summaries.get("request")
                res.extra["flight_journal"] = flight.write_journal(
                    jpath_stream,
                    extra={
                        "workload": "serve", "n_chips": 1,
                        # The replay stamp: everything recording a bundle
                        # needs to rebuild this run as a bundle. Rate is
                        # the EFFECTIVE offered load (sweep points
                        # override the config's).
                        "replay": journal_replay_stamp(
                            cfg, schedule, objects, serve_extra,
                            rate_rps=(
                                self.rate_rps
                                if self.rate_rps is not None
                                else sc.rate_rps
                            ),
                            errors=errors,
                            p99_ms=s.p99_ms if s is not None else None,
                            source=self.replay_source,
                        ),
                    },
                    max_bytes=cfg.obs.journal_max_bytes,
                )
        return res

    def _scorecard(self, schedule, ledgers, recorders, tenant_bytes,
                   qstats, wall, completed_bytes, classes) -> dict:
        return serve_scorecard(
            self.cfg.serve, schedule, ledgers, recorders, tenant_bytes,
            qstats, wall, completed_bytes, classes,
        )


def serve_scorecard(sc, schedule, ledgers, recorders, tenant_bytes,
                    qstats, wall, completed_bytes, classes) -> dict:
    """The per-class serve scorecard (``extra["serve"]``), shared by the
    single-host and elastic-pod planes — the A/B between them must never
    come from scorecard-math drift."""
    per_class = {}
    for c in classes:
        cls = str(c["name"])
        led = ledgers[cls]
        rec = recorders[cls]
        arr = rec.as_ns_array()
        per_class[cls] = {
            "priority": int(c.get("priority", 0)),
            "weight": float(c.get("weight", 1.0)),
            "deadline_ms": float(c["deadline_ms"]),
            "arrivals": led.arrivals,
            "completed": led.completed,
            "deadline_met": led.deadline_met,
            "shed": led.shed,
            "errors": led.errors,
            "bytes": led.bytes,
            "slo_attainment": led.slo_attainment(),
            "p50_ms": float(np.percentile(arr, 50) / 1e6)
            if arr.size else None,
            "p99_ms": float(np.percentile(arr, 99) / 1e6)
            if arr.size else None,
        }
    # Jain fairness over weight-normalized per-TENANT goodput:
    # tenants that sent traffic compete; a starved tenant's 0 is a
    # legitimate unfairness sample (zero-completed ≠ excluded).
    # Weights come off the schedule's own Request objects — never a
    # build_tenants re-derivation that must stay bit-identical.
    weights = {r.tenant.name: r.tenant.weight for r in schedule}
    norm = [
        tenant_bytes.get(name, 0) / w
        for name, w in sorted(weights.items())
    ]
    arrivals = len(schedule)
    completed = sum(led.completed for led in ledgers.values())
    shed = sum(led.shed for led in ledgers.values())
    return {
        "qos": sc.qos,
        "arrival": sc.arrival,
        "tenants": sc.tenants,
        "active_tenants": len(weights),
        "duration_s": sc.duration_s,
        "wall_s": wall,
        "offered_rps": arrivals / wall if wall > 0 else None,
        "achieved_rps": completed / wall if wall > 0 else None,
        "arrivals": arrivals,
        "completed": completed,
        "shed": shed,
        "shed_by_reason": qstats["shed"],
        "goodput_gbps": (completed_bytes / 1e9) / wall
        if wall > 0 else 0.0,
        "jain_fairness": jain_index(norm),
        "queue": {
            k: qstats[k] for k in (
                "cap", "queue_limit", "peak_queue", "peak_in_service",
            )
        },
        "classes": per_class,
    }


def _merge_windows(windows: list) -> list:
    """Merge overlapping [t0, t1] intervals (the resize windows the
    scorecard brackets events with)."""
    out: list = []
    for w0, w1 in sorted(windows):
        if out and w0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], w1)
        else:
            out.append([w0, w1])
    return out


def _in_windows(t: float, windows: list) -> bool:
    return any(w0 <= t < w1 for w0, w1 in windows)


class _ElasticServe:
    """The serve plane fanned across an N-host hermetic threaded pod
    with ELASTIC membership: every miss routes through coop-cache
    consistent-hash ownership over a shared loopback fabric, and the
    ``serve.membership_timeline`` changes the pod's shape mid-run —
    hosts die (``kill_host``: no goodbye, peers fall back to origin
    through the PeerMissError/retry composition), leave cooperatively
    (``leave_host``: the warm-handoff protocol drains the departing
    owner's hot set to the chunks' new owners over the peer channel),
    stall (``pause_host``: transient peer errors for the window) and
    come back clean (``rejoin_host``). Membership events ride the
    dispatcher's own schedule walk (virtual time), so runs replay
    bit-identically for a seed; the resize scorecard lands in
    ``extra["membership"]``.

    In-flight requests against a dead host FAIL OVER at pop time (the
    worker re-targets a live host) — the admission queue never wedges
    on a death. Dispatch targets only live hosts; the pod completing
    with zero live hosts is the (counted) degenerate error case."""

    def __init__(self, cfg: BenchConfig, backend: StorageBackend,
                 rate_rps: Optional[float],
                 replay_source: Optional[dict] = None):
        self.cfg = cfg
        self.backend = backend
        self.rate_rps = rate_rps
        self.replay_source = replay_source

    def run(self) -> RunResult:
        # Lazy elastic-plane imports: the single-host serve path (and
        # `report`, which imports this module for rendering)
        # must not pay for them.
        from tpubench_torch.dist.membership import ElasticFabric, remap_stats
        from tpubench_torch.mem.slab import (
            CopyMeter,
            SlabPool,
            release_payload,
        )
        from tpubench_torch.pipeline.coop import CoopCache, LoopbackChannel
        from tpubench_torch.storage.base import StorageError

        cfg, sc = self.cfg, self.cfg.serve
        if getattr(cfg, "tune", None) is not None and cfg.tune.enabled:
            # Loud, not silent: the serve tune controller actuates the
            # single-host plane's knobs — running it disconnected would
            # hand a tuning user arms that never moved.
            raise SystemExit(
                "serve: --tune does not compose with the elastic pod "
                "(serve.hosts > 1) yet — run the autotuner on the "
                "single-host plane"
            )
        chunk = sc.chunk_bytes or cfg.workload.granule_bytes
        objects = self.backend.list(cfg.workload.object_name_prefix)
        schedule = build_schedule(cfg, self.backend, self.rate_rps,
                                  objects=objects)
        tlabel = transport_label(cfg)
        scale = parse_sleep_scale("serve arrival gaps")
        gaps = scaled_gaps([r.arrival_s for r in schedule], scale)

        qos = sc.qos
        budgets = class_budget_split(sc.classes, cfg.pipeline.cache_bytes) \
            if qos else None
        flight = flight_from_config(cfg)
        shed_log = _ShedLog(flight, tlabel)

        # Per-request SLO outcome, indexed by schedule position: True =
        # completed within deadline, False = late/shed/error, None =
        # never resolved (counts as a miss). The resize-vs-steady SLO
        # split is computed from this against the event windows.
        outcome: list = [None] * len(schedule)

        def on_shed(req: Request, reason: str) -> None:
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

        # ---- the pod: N hosts over one membership-aware fabric ------
        vnow = [0.0]  # virtual schedule time, driven by the dispatcher
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
        for h in range(sc.hosts):
            pool = (
                SlabPool(slab_bytes, pool_slabs, device="cpu")
                if use_pool else None
            )
            meter = CopyMeter()
            cache = ChunkCache(pc.cache_bytes, owner_budgets=budgets)

            def origin_fetch(key, _pool=pool, _meter=meter):
                return fetch_chunk(
                    self.backend, key, pool=_pool, meter=_meter
                )

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
            hosts[h] = {"coop": coop, "cache": cache, "pool": pool,
                        "meter": meter}

        # ---- membership plan + resize windows (virtual seconds) -----
        member_plan: list = []  # (t, action, host)
        windows: list = []
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
        snapshots: list = []  # (t_virtual, aggregate-counter dict)

        classes = sorted(
            sc.classes, key=lambda c: int(c.get("priority", 0))
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

        for req in schedule:
            ledgers[req.tenant.cls].arrivals += 1

        def take_snapshot(t: float) -> None:
            agg = fabric.aggregate()
            with ledger_lock:
                agg["completed"] = sum(
                    led.completed for led in ledgers.values()
                )
            snapshots.append((t, agg))

        def apply_event(t: float, action: str, host: int) -> None:
            vnow[0] = max(vnow[0], t)
            before = fabric.owners_of(uniq_keys)
            handoff = None
            if action == "kill_host":
                ok = fabric.kill_host(host)
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

        # ---- telemetry (the single-host wiring) ---------------------
        jpath_stream = None
        if cfg.obs.flight_journal:
            jpath_stream = rank_journal_path(cfg)
        tel = telemetry_from_config(cfg)
        tel_summary = None
        if tel is not None:
            tel.resource["workload"] = "serve"
            if flight is not None:
                tel.attach_flight(flight)
                if jpath_stream:
                    tel.stream_journal(
                        flight, jpath_stream,
                        extra_fn=lambda: {"workload": "serve"},
                        max_bytes=cfg.obs.journal_max_bytes,
                    )
            tel.attach_recorders([agg_rec])
            tel.start()

        def worker(i: int) -> None:
            wf = worker_flights[i]
            while True:
                req = queue.pop()
                if req is None:
                    return
                cls = req.tenant.cls
                t_pop = time.perf_counter_ns()
                op = None
                try:
                    host = req.host
                    if not fabric.is_dispatchable(host):
                        # The assigned front end died/paused while this
                        # request sat queued: fail over to a live host
                        # instead of wedging or erroring — exactly what
                        # a pod front door does.
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
                        data, source = cache.get_or_fetch_info(
                            req.key,
                            lambda k=req.key, c=coop: c.fetch(k),
                            owner=cls if qos else None,
                        )
                        if op is not None:
                            if source == "hit":
                                # Raced hit (the single-host plane's
                                # discipline): the would-be miss record
                                # becomes a cache record so the fetcher
                                # stays the only byte-carrying one.
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
                    release_payload(data)  # consumer lease ref, if any
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
                    outcome[req.index] = bool(met)
                    recorders[cls].record_ns(lat_ns)
                    agg_rec.record_ns(lat_ns)
                except Exception as e:  # noqa: BLE001 — per-request domain
                    # The single-host plane's rule: one tenant's failed
                    # fetch is its ledger's error, never a run abort;
                    # KeyboardInterrupt/SystemExit still stop the run.
                    if op is not None:
                        op.finish(error=e)
                    outcome[req.index] = False
                    with ledger_lock:
                        ledgers[req.tenant.cls].errors += 1
                finally:
                    queue.done()

        threads = [
            threading.Thread(target=worker, args=(i,),
                             name=f"serve-{i}", daemon=True)
            for i in range(sc.workers)
        ]
        activation = flight.activate() if flight is not None else None
        t0 = time.perf_counter_ns()
        try:
            if activation is not None:
                activation.__enter__()
            for t in threads:
                t.start()
            take_snapshot(0.0)
            # ---- the open loop, with membership events interleaved --
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
            while mp_i < len(member_plan):  # events past the last arrival
                apply_event(*member_plan[mp_i])
                mp_i += 1
            grace_s = max(1.0, 2.0 * scale)
            t_end = time.monotonic() + grace_s
            while (queue.queued or queue.in_service) \
                    and time.monotonic() < t_end:
                time.sleep(0.005)
        finally:
            drained = queue.close()
            for t in threads:
                t.join(timeout=5.0)
            take_snapshot(max(vnow[0], sc.duration_s))
            if activation is not None:
                activation.__exit__(None, None, None)
            if tel is not None:
                tel.set_chips(1)
                tel_summary = tel.close()
        wall = (time.perf_counter_ns() - t0) / 1e9

        # ---- teardown: coops, caches, pools (leak detection) --------
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
        membership = self._membership_scorecard(
            schedule, outcome, events_out, windows, snapshots, per_host,
            failovers[0], no_live_host_errors[0], pool_leaks, classes,
            fabric,
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
            workload="serve",
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
        if tel_summary is not None:
            res.extra["telemetry"] = tel_summary
        from tpubench_torch.storage.tail import collect_tail_stats

        tail_stats = collect_tail_stats(self.backend)
        if tail_stats:
            res.extra["tail"] = tail_stats
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if jpath_stream:
                from tpubench_torch.replay.bundle import journal_replay_stamp

                s = summaries.get("request")
                res.extra["flight_journal"] = flight.write_journal(
                    jpath_stream,
                    extra={
                        "workload": "serve", "n_chips": 1,
                        # The single-host plane's stamp, plus the
                        # membership scorecard so the bundle baseline
                        # carries rewarm/failover numbers.
                        "replay": journal_replay_stamp(
                            cfg, schedule, objects, serve_extra,
                            rate_rps=(
                                self.rate_rps
                                if self.rate_rps is not None
                                else sc.rate_rps
                            ),
                            membership=membership,
                            errors=errors,
                            p99_ms=s.p99_ms if s is not None else None,
                            source=self.replay_source,
                        ),
                    },
                    max_bytes=cfg.obs.journal_max_bytes,
                )
        return res

    # ----------------------------------------------------- scorecard --
    def _membership_scorecard(self, schedule, outcome, events_out,
                              windows, snapshots, per_host, failovers,
                              no_live_host_errors, pool_leaks, classes,
                              fabric) -> dict:
        return membership_scorecard(
            self.cfg.serve, schedule, outcome, events_out, windows,
            snapshots, per_host, failovers, no_live_host_errors,
            pool_leaks, classes, fabric,
        )


def membership_scorecard(sc, schedule, outcome, events_out,
                         windows, snapshots, per_host, failovers,
                         no_live_host_errors, pool_leaks, classes,
                         fabric) -> dict:
    """The resize scorecard (``extra["membership"]``), shared by the
    elastic serve plane and (in ``tpubench``) the incident drill —
    their A/B must never come from scorecard-math drift."""
    # Per-class SLO, resize windows vs steady state — by ARRIVAL
        # time (the open-loop convention: the system owns everything
        # that arrived in the window, including what it shed).
    split: dict = {"resize": {}, "steady": {}}
    counts = {"resize": 0, "steady": 0}
    tally: dict = {}
    for req in schedule:
        seg = "resize" if _in_windows(req.arrival_s, windows) \
            else "steady"
        counts[seg] += 1
        met, tot = tally.get((seg, req.tenant.cls), (0, 0))
        tally[(seg, req.tenant.cls)] = (
            met + (1 if outcome[req.index] else 0), tot + 1
        )
    for c in classes:
        cls = str(c["name"])
        for seg in ("resize", "steady"):
            met, tot = tally.get((seg, cls), (0, 0))
            split[seg][cls] = (met / tot) if tot else None

    # Counter series helpers over the (virtual-time, aggregate)
    # snapshots: value at t = the last snapshot at or before t.
    def value_at(t: float, key: str) -> int:
        v = 0
        for st, agg in snapshots:
            if st <= t:
                v = agg.get(key, 0)
            else:
                break
        return v

    total_origin = snapshots[-1][1].get("origin_bytes", 0) \
        if snapshots else 0
    # Clip windows to the run's virtual span for the byte/length
    # split: an event near the bell opens a window that extends
    # past end-of-run, and charging that phantom tail would both
    # shrink steady_len and inflate steady_rate_bps — exactly the
    # comparison this block exists to keep honest.
    clipped = [
        (min(w0, sc.duration_s), min(w1, sc.duration_s))
        for w0, w1 in windows
    ]
    window_origin = sum(
        value_at(w1, "origin_bytes") - value_at(w0, "origin_bytes")
        for w0, w1 in clipped
    )
    window_len = sum(w1 - w0 for w0, w1 in clipped)
    steady_len = max(0.0, sc.duration_s - window_len)
    steady_origin = max(0, total_origin - window_origin)
    steady_rate = steady_origin / steady_len if steady_len > 0 \
        else None

    # Time-to-rewarm per view-changing event: first post-event
    # snapshot window whose peer-hit ratio is back to >= 90% of the
    # cumulative pre-event ratio.
    def ratio(agg: dict) -> Optional[float]:
        req = agg.get("peer_requests", 0)
        return agg.get("peer_hits", 0) / req if req else None

    for ev in events_out:
        if ev["action"] not in (
            "kill_host", "leave_host", "pause_host",
        ):
            continue
        te = ev["t_s"]
        pre = None
        for st, agg in snapshots:
            if st <= te:
                pre = ratio(agg)
            else:
                break
        ev["pre_event_peer_hit_ratio"] = pre
        rewarm = None
        if pre:
            prev = None
            for st, agg in snapshots:
                if st < te:
                    continue
                if prev is not None:
                    dreq = (agg.get("peer_requests", 0)
                            - prev[1].get("peer_requests", 0))
                    dhit = (agg.get("peer_hits", 0)
                            - prev[1].get("peer_hits", 0))
                    if dreq > 0 and dhit / dreq >= 0.9 * pre:
                        rewarm = max(0.0, st - te)
                        break
                prev = (st, agg)
        ev["time_to_rewarm_s"] = rewarm

    agg = fabric.aggregate()
    final_ratio = ratio(agg)
    return {
        "hosts": sc.hosts,
        "epoch": agg["epoch"],
        "resize_window_s": sc.resize_window_s,
        "events": events_out,
        "windows_s": [list(w) for w in windows],
        "slo": split,
        "arrivals": counts,
        "origin_bytes": {
            "total": total_origin,
            "resize_windows": window_origin,
            "steady": steady_origin,
            "steady_rate_bps": steady_rate,
        },
        "handoff": {
            "out_chunks": agg["handoff_out_chunks"],
            "out_bytes": agg["handoff_out_bytes"],
            "in_chunks": agg["handoff_in_chunks"],
            "in_bytes": agg["handoff_in_bytes"],
            "rejects": agg["handoff_rejects"],
        },
        "peer_hit_ratio": final_ratio,
        "pod_coalesced": agg["pod_coalesced"],
        "failovers": failovers,
        "no_live_host_errors": no_live_host_errors,
        "pool_leaked_slabs": pool_leaks,
        "per_host": per_host,
    }


def _build_serve_controller(cfg, queue, pf, guard_rec, bytes_fn, flight):
    """Serve-plane tune controller: admission cap (the "workers" knob —
    the executor's admission hook, live via AdmissionQueue.set_cap), readahead depth and
    prefetch fan-out; objective is aggregate goodput, guardrail is the
    HIGHEST-priority class's p99."""
    from tpubench_torch.tune.controller import (
        Knob,
        RecorderSampler,
        TuneController,
        readahead_ceiling,
    )

    wanted = set(cfg.tune.knobs)
    knobs = []
    if "workers" in wanted:
        knobs.append(Knob(
            "workers", queue.cap, queue.set_cap,
            lo=1, hi=max(2, cfg.serve.workers), mode="mul",
        ))
    if "readahead" in wanted and pf is not None:
        knobs.append(Knob(
            "readahead", cfg.serve.readahead,
            lambda v: pf.reclamp(depth=v),
            lo=1, hi=readahead_ceiling(cfg.serve.readahead), mode="mul",
        ))
    if "prefetch_workers" in wanted and pf is not None:
        hi = pf.stats()["workers_max"]
        if hi > 1:
            knobs.append(Knob(
                "prefetch_workers", pf.active_workers, pf.set_workers,
                lo=1, hi=hi, mode="add",
            ))
    if not knobs:
        return None
    sampler = RecorderSampler([guard_rec], bytes_fn)
    ring = flight.worker("tune") if flight is not None else None
    return TuneController(cfg.tune, knobs, sampler, flight_ring=ring)


def run_serve_sweep(cfg: BenchConfig, tracer=None,
                    backend: Optional[StorageBackend] = None,
                    device="cuda") -> RunResult:
    """``serve --serve-sweep``: step offered load through
    ``serve.sweep_points × rate_rps`` and emit the latency-vs-load curve
    with the saturation knee identified (p99 inflection / goodput
    saturation) — the Pulsar-methodology sweep, hermetic on the fake
    backend. ``backend`` (one store for every point, as ``run_tune``
    takes one; ``tpubench`` opens one per point) and ``device`` pass to
    each point's :func:`run_serve`."""
    resolve_device(device)
    validate_serve_config(cfg.serve)
    points = []
    results = []
    for mult in cfg.serve.sweep_points:
        c = BenchConfig.from_dict(cfg.to_dict())
        if cfg.serve.sweep_duration_s > 0:
            c.serve.duration_s = cfg.serve.sweep_duration_s
        # Per-point endpoint churn off (the tune-sweep policy): one
        # sweep must not bind N telemetry ports.
        c.telemetry.port = -1
        c.telemetry.enabled = False
        c.telemetry.otlp = False
        if c.obs.flight_journal:
            # One journal PER POINT (.pt<i> suffix): every point writes
            # the same configured path otherwise, and the sweep's
            # journal would silently hold only the heaviest point.
            c.obs.flight_journal = f"{c.obs.flight_journal}.pt{len(points)}"
        res = run_serve(
            c, backend=backend, rate_rps=cfg.serve.rate_rps * mult,
            tracer=tracer, device=device,
        )
        sv = res.extra["serve"]
        gold = min(
            sv["classes"].values(), key=lambda x: x["priority"]
        ) if sv["classes"] else {}
        s = res.summaries.get("request")
        points.append({
            "multiplier": mult,
            "offered_rps": sv["offered_rps"],
            "achieved_rps": sv["achieved_rps"],
            "goodput_gbps": sv["goodput_gbps"],
            "p99_ms": s.p99_ms if s is not None else None,
            "gold_p99_ms": gold.get("p99_ms"),
            "gold_slo_attainment": gold.get("slo_attainment"),
            "shed": sv["shed"],
            "jain_fairness": sv["jain_fairness"],
        })
        results.append(res)
    knee = find_knee(points)
    # The sweep's RunResult carries the heaviest point's latencies plus
    # the whole curve; `report` renders curve + knee.
    last = results[-1]
    res = RunResult(
        workload="serve",
        config=cfg.to_dict(),
        bytes_total=sum(r.bytes_total for r in results),
        wall_seconds=sum(r.wall_seconds for r in results),
        gbps=last.gbps,
        gbps_per_chip=last.gbps,
        n_chips=1,
        summaries=last.summaries,
        errors=sum(r.errors for r in results),
    )
    res.extra["serve"] = {
        "qos": cfg.serve.qos,
        "sweep": {
            "base_rate_rps": cfg.serve.rate_rps,
            "points": points,
            "knee": knee,
        },
    }
    return res


# -------------------------------------------------------------- rendering --


def format_serve_scorecard(sv: dict) -> str:
    """Human rendering of ``extra["serve"]`` (CLI + ``report``)."""
    sweep = sv.get("sweep")
    if sweep:
        lines = ["== serve load sweep =="]
        lines.append(
            f"  base rate={sweep.get('base_rate_rps', 0):.0f} rps  "
            f"qos={'on' if sv.get('qos') else 'off'}"
        )
        lines.append(
            "  offered_rps  achieved_rps  goodput  p99_ms  gold_p99  shed"
        )
        for p in sweep.get("points", ()):
            lines.append(
                f"  {p.get('offered_rps') or 0:11.1f}"
                f"  {p.get('achieved_rps') or 0:12.1f}"
                f"  {p.get('goodput_gbps') or 0:7.4f}"
                f"  {p.get('p99_ms') or 0:6.1f}"
                f"  {p.get('gold_p99_ms') or 0:8.1f}"
                f"  {p.get('shed', 0):4d}"
            )
        knee = sweep.get("knee")
        if knee:
            lines.append(
                f"  knee: {knee['offered_rps']:.1f} rps "
                f"({knee['reason']}, point {knee['index']})"
            )
        else:
            lines.append("  knee: not reached in this sweep")
        return "\n".join(lines)
    lines = [
        "== serve scorecard ==",
        (
            f"  qos={'on' if sv.get('qos') else 'off'} "
            f"arrival={sv.get('arrival', '?')} "
            f"tenants={sv.get('active_tenants', 0)}"
            f"/{sv.get('tenants', 0)}  "
            f"offered={sv.get('offered_rps') or 0:.1f} rps "
            f"achieved={sv.get('achieved_rps') or 0:.1f} rps "
            f"goodput={sv.get('goodput_gbps', 0.0):.4f} GB/s"
        ),
        (
            f"  arrivals={sv.get('arrivals', 0)} "
            f"completed={sv.get('completed', 0)} "
            f"shed={sv.get('shed', 0)} "
            + (
                f"jain={sv['jain_fairness']:.3f}"
                if sv.get("jain_fairness") is not None else "jain=n/a"
            )
        ),
    ]
    for cls, st in (sv.get("classes") or {}).items():
        slo = st.get("slo_attainment")
        p99 = st.get("p99_ms")
        lines.append(
            f"  [{cls}] prio={st.get('priority')} "
            f"deadline={st.get('deadline_ms', 0):.0f}ms "
            f"arrivals={st.get('arrivals', 0)} "
            f"completed={st.get('completed', 0)} "
            f"shed={st.get('shed', 0)} "
            f"slo={f'{slo:.1%}' if slo is not None else 'n/a'} "
            f"p99={f'{p99:.1f}ms' if p99 is not None else 'n/a'}"
        )
    q = sv.get("queue")
    if q:
        lines.append(
            f"  queue: cap={q.get('cap')} limit={q.get('queue_limit')} "
            f"peak={q.get('peak_queue')} "
            f"peak_in_service={q.get('peak_in_service')}"
        )
    return "\n".join(lines)


def format_membership_scorecard(mb: dict) -> str:
    """Human rendering of ``extra["membership"]`` — the resize scorecard
    (CLI + ``report``)."""
    lines = [
        "== membership resize scorecard ==",
        (
            f"  pod: {mb.get('hosts', 0)} hosts  "
            f"final epoch={mb.get('epoch', 0)}  "
            f"failovers={mb.get('failovers', 0)}  "
            f"leaked_slabs={mb.get('pool_leaked_slabs', 0)}"
        ),
    ]
    for ev in mb.get("events", ()):
        extra = ""
        ho = ev.get("handoff")
        if ho:
            extra = (
                f"  handoff={ho.get('chunks', 0)} chunks/"
                f"{ho.get('bytes', 0)}B"
            )
        rw = ev.get("time_to_rewarm_s")
        if rw is not None:
            extra += f"  rewarm={rw:.2f}s"
        lines.append(
            f"  [t={ev.get('t_s', 0.0):.2f}s] {ev.get('action')} "
            f"host {ev.get('host')} -> epoch {ev.get('epoch')} "
            f"(remap {ev.get('remap_fraction', 0.0):.1%} = "
            f"{ev.get('remap_bytes', 0)}B){extra}"
        )
    slo = mb.get("slo") or {}
    for seg in ("resize", "steady"):
        cells = []
        for cls, v in (slo.get(seg) or {}).items():
            cells.append(
                f"{cls}={v:.1%}" if v is not None else f"{cls}=n/a"
            )
        arr = (mb.get("arrivals") or {}).get(seg, 0)
        lines.append(
            f"  SLO {seg:<6} ({arr} arrivals): " + " ".join(cells)
        )
    ob = mb.get("origin_bytes") or {}
    lines.append(
        f"  origin bytes: resize_windows={ob.get('resize_windows', 0)} "
        f"steady={ob.get('steady', 0)} total={ob.get('total', 0)}"
    )
    ho = mb.get("handoff") or {}
    phr = mb.get("peer_hit_ratio")
    lines.append(
        f"  handoff: out={ho.get('out_chunks', 0)} chunks/"
        f"{ho.get('out_bytes', 0)}B in={ho.get('in_chunks', 0)} chunks/"
        f"{ho.get('in_bytes', 0)}B rejects={ho.get('rejects', 0)}  "
        + (
            f"peer_hit={phr:.1%}" if phr is not None else "peer_hit=n/a"
        )
    )
    return "\n".join(lines)
