"""``chaos`` — scripted fault timelines and the resilience scorecard (a
copy of ``tpubench/workloads/chaos.py``).

Runs a workload (read, pod-ingest, train-ingest or serve) against a
hermetic target while a time-phased :class:`~tpubench_torch.config.FaultConfig`
schedule turns faults on and off mid-run, then scores how ingest
*degraded and recovered*:

* **goodput retention** — goodput during the fault window as a fraction
  of the pre-fault baseline;
* **p99 inflation** — read p99 during the fault vs the baseline;
* **hedge win rate / wasted bytes, stall count, breaker open time** —
  what the tail-tolerance layer (storage/tail.py) actually did;
* **time-to-recover** — how long after the fault clears until windowed
  goodput is back to ≥90 % of baseline.

The per-read raw material is the flight recorder: every read is a
phase-stamped record (with hedge/stall/breaker events as notes), so the
scorecard is computed offline from the run's own flight journal — and
``report timeline`` attributes the same events per read.

Hermetic by construction: the fault plane only exists in the fake
backend and the fake servers, so chaos supports ``--protocol fake``
(in-process store), ``http`` (in-process HTTP/1.1 server), ``http``
+ ``--http2`` (in-process h2 server, native client) and ``grpc``
(in-process gRPC wire server). Wall-clock is bounded: every phase window
and time-shaped fault duration scales by ``TPUBENCH_BENCH_SLEEP_SCALE``
so CI can run a miniature timeline.

The arms run on ``device`` as their own commands do: read stages through
the ring ``staging.mode`` selects (``tpubench``'s chaos read discards its
bytes), pod-ingest stages and gathers its shards, train-ingest stages its
steps; serve does no device work. There is no host-RAM fallback.

:func:`spawn_hermetic_server` and :func:`hermetic_target` are the
in-process servers ``tune``, ``ckpt-save`` and ``ckpt-restore`` also run
against.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

from tpubench_torch.config import (
    BenchConfig,
    parse_sleep_scale,
    validate_fault_config,
)

# Fault fields that are durations (seconds): these scale with the
# timeline so a scaled-down run keeps the same *shape*.
_TIME_FIELDS = ("latency_s", "per_read_latency_s", "stall_s")


def _sleep_scale() -> float:
    """Validated ``TPUBENCH_BENCH_SLEEP_SCALE`` (the shared
    ``config.parse_sleep_scale``), applied here to every phase window and
    time-shaped fault duration; unset = 1."""
    return parse_sleep_scale("chaos timeline durations")


def scaled_fault_dict(fdict: dict, scale: float) -> dict:
    """A fault-config dict with every phase window and time-shaped fault
    duration scaled by ``scale`` — the ONE definition of "run this
    timeline under TPUBENCH_BENCH_SLEEP_SCALE", shared by chaos and the
    replay driver (a replayed incident must scale exactly the way the
    incident run did, or the timeline's shape drifts between them).
    Returns a new dict; never mutates the input (the caller's config —
    and a replay's bundle — must survive a second run unscaled)."""
    out = dict(fdict)
    phases = []
    for t0, t1, plan in out.get("phases") or ():
        p = dict(plan)
        for f in _TIME_FIELDS:
            if p.get(f):
                p[f] = p[f] * scale
        phases.append([float(t0) * scale, float(t1) * scale, p])
    out["phases"] = phases
    for f in _TIME_FIELDS:
        if out.get(f):
            out[f] = out[f] * scale
    return out


# ------------------------------------------------------------ scorecard ---


def _segment_stats(reads: list, lo: float, hi: float,
                   duration: float) -> dict:
    """One timeline segment over ``reads`` = [(t_start, t_end, dur_ms,
    bytes), ...], bucketed by COMPLETION time: goodput is bytes that
    actually arrived during the segment's wall window, and a read that
    began just before the fault and crawled through it carries its
    latency into the segment where it finally landed."""
    durs = sorted(r[2] for r in reads if lo <= r[1] < hi)
    total = sum(r[3] for r in reads if lo <= r[1] < hi)

    def pct(p: float) -> float:
        if not durs:
            return 0.0
        return durs[min(len(durs) - 1, int(p * len(durs)))]

    return {
        "reads": len(durs),
        "bytes": total,
        "seconds": round(duration, 6),
        "goodput_gbps": (total / 1e9 / duration) if duration > 0 else 0.0,
        "p50_ms": pct(0.50),
        "p99_ms": pct(0.99),
    }


def resilience_scorecard(
    records: list[dict],
    phases: list,
    epoch_ns: int,
    tail_stats: Optional[dict] = None,
    recover_frac: float = 0.9,
) -> dict:
    """Score a run's flight records against its fault timeline.

    ``phases`` are the (scaled) ``[t0, t1, plan]`` windows; the fault
    window scored is their bounding box. ``epoch_ns`` is the
    ``perf_counter_ns`` stamp taken when the schedule was armed, mapping
    record timestamps onto timeline seconds."""
    fault_t0 = min(p[0] for p in phases)
    fault_t1 = max(p[1] for p in phases)
    reads = []  # (t_start_s, t_end_s, dur_ms, bytes), timeline-relative
    failed = 0
    for r in records:
        if r.get("kind", "read") != "read":
            continue
        if r.get("error"):
            failed += 1
            continue
        ph = r.get("phases", {})
        end_ns = ph.get("body_complete") or max(ph.values())
        start_ns = ph.get("enqueue", end_ns)
        reads.append((
            (start_ns - epoch_ns) / 1e9,
            (end_ns - epoch_ns) / 1e9,
            (end_ns - start_ns) / 1e6,
            int(r.get("bytes", 0)),
        ))
    run_end = max((r[1] for r in reads), default=fault_t1)

    inf = float("inf")
    base_s = _segment_stats(reads, -inf, fault_t0, fault_t0)
    fault_s = _segment_stats(reads, fault_t0, fault_t1, fault_t1 - fault_t0)
    rec_s = _segment_stats(reads, fault_t1, inf,
                           max(0.0, run_end - fault_t1))
    recovery = [r for r in reads if r[1] >= fault_t1]  # by completion

    retention = None
    if base_s["goodput_gbps"] > 0:
        retention = fault_s["goodput_gbps"] / base_s["goodput_gbps"]
    p99_inflation = None
    if base_s["p99_ms"] > 0:
        p99_inflation = fault_s["p99_ms"] / base_s["p99_ms"]

    # Time-to-recover: the first sliding window after the fault clears
    # whose goodput is back to >= recover_frac of baseline. A run that
    # bounces back instantly scores 0.0; None = not recovered (or no
    # baseline to recover to) within the run.
    ttr = None
    base_rate = base_s["goodput_gbps"] * 1e9  # B/s
    if base_rate > 0 and recovery:
        tail_len = max(1e-9, run_end - fault_t1)
        w = min(max(0.05, tail_len / 4), max(0.05, fault_t0))
        step = w / 4
        s = fault_t1
        while s + w <= run_end + step:
            got = sum(r[3] for r in recovery if s <= r[1] < s + w)
            if got / w >= recover_frac * base_rate:
                ttr = s - fault_t1
                break
            s += step

    card: dict = {
        "fault_window_s": [fault_t0, fault_t1],
        "baseline": base_s,
        "fault": fault_s,
        "recovery": rec_s,
        "goodput_retention": retention,
        "p99_inflation": p99_inflation,
        "time_to_recover_s": ttr,
        "recover_frac": recover_frac,
        "failed_reads": failed,
        "run_end_s": run_end,
        # A timeline the run never reached is a mis-sized experiment —
        # flag it rather than report a vacuous recovery. Zero successful
        # reads is the degenerate case of exactly that.
        "timeline_covered": bool(reads) and run_end >= fault_t1,
    }
    tail_stats = tail_stats or {}
    hedge = dict(tail_stats.get("hedge", {}))
    if hedge:
        launched = hedge.get("hedges", 0)
        hedge["win_rate"] = (
            hedge.get("hedge_wins", 0) / launched if launched else None
        )
    card["hedge"] = hedge
    card["stalls"] = tail_stats.get("watchdog", {}).get("stalls", 0)
    breaker = tail_stats.get("breaker")
    if breaker:
        card["breaker"] = {
            "opens": breaker.get("opens", 0),
            "open_s": breaker.get("open_s", 0.0),
            "state": breaker.get("state"),
        }
    return card


def format_scorecard(chaos: dict) -> str:
    """Human rendering of ``extra["chaos"]`` (also used by ``report`` on
    chaos result files)."""
    sc = chaos.get("scorecard", {})
    t0, t1 = sc.get("fault_window_s", (0, 0))
    lines = [
        f"== resilience scorecard ({chaos.get('workload', 'read')}; "
        f"fault window {t0:.2f}s-{t1:.2f}s) ==",
    ]
    for seg in ("baseline", "fault", "recovery"):
        s = sc.get(seg, {})
        lines.append(
            f"  {seg:<9} reads={s.get('reads', 0):<5} "
            f"goodput={s.get('goodput_gbps', 0.0):.4f} GB/s  "
            f"p50={s.get('p50_ms', 0.0):.2f} ms  "
            f"p99={s.get('p99_ms', 0.0):.2f} ms"
        )
    ret = sc.get("goodput_retention")
    infl = sc.get("p99_inflation")
    ttr = sc.get("time_to_recover_s")
    lines.append(
        "  goodput retention: "
        + (f"{ret:.1%}" if ret is not None else "n/a (no baseline)")
    )
    lines.append(
        "  p99 inflation:     "
        + (f"{infl:.2f}x" if infl is not None else "n/a")
    )
    lines.append(
        "  time-to-recover:   "
        + (f"{ttr:.3f}s" if ttr is not None else
           "not recovered within run"
           if sc.get("timeline_covered") else "n/a (run ended mid-fault)")
    )
    hedge = sc.get("hedge") or {}
    if hedge:
        wr = hedge.get("win_rate")
        wr_cell = f"{wr:.1%}" if wr is not None else "n/a"
        lines.append(
            f"  hedges: launched={hedge.get('hedges', 0)} "
            f"wins={hedge.get('hedge_wins', 0)} "
            f"losses={hedge.get('hedge_losses', 0)} "
            f"win_rate={wr_cell} "
            f"wasted_bytes={hedge.get('wasted_bytes', 0)}"
        )
    lines.append(f"  stalls detected:   {sc.get('stalls', 0)}")
    br = sc.get("breaker")
    if br:
        lines.append(
            f"  breaker: opens={br['opens']} open_s={br['open_s']:.3f} "
            f"state={br['state']}"
        )
    lines.append(f"  failed reads:      {sc.get('failed_reads', 0)}")
    return "\n".join(lines)


# -------------------------------------------------------------- workload --


def spawn_hermetic_server(cfg: BenchConfig, fault_plan=None, store=None):
    """In-process fake server speaking the real wire protocol (HTTP/1.1,
    the h2 server under ``transport.http2``, or the gRPC wire server under
    ``--protocol grpc``), backed by a prepopulated fake store carrying
    ``fault_plan`` — server-side injection, so stalls, resets and
    truncation happen on the wire. ``store`` overrides the default
    population. Sets ``cfg.transport.endpoint`` (the caller restores it)
    and loads the C++ engine where the client path needs it, so first-use
    costs never land inside a measured window. Returns the started server
    (the caller stops it)."""
    from tpubench_torch.storage.fake import FakeBackend

    w = cfg.workload
    if store is None:
        store = FakeBackend.prepopulated(
            prefix=w.object_name_prefix,
            count=max(w.workers, w.threads),
            size=w.object_size,
            fault=fault_plan,
        )
    if cfg.transport.protocol == "grpc":
        from tpubench_torch.storage.fake_grpc_wire_server import (
            FakeGrpcWireServer,
        )

        server = FakeGrpcWireServer(backend=store).start()
        # DirectPath cannot apply to a loopback fake (caller restores cfg).
        cfg.transport.directpath = False
    elif cfg.transport.http2:
        from tpubench_torch.storage.fake_h2_server import FakeH2Server

        server = FakeH2Server(backend=store).start()
    else:
        from tpubench_torch.storage.fake_server import FakeGcsServer

        server = FakeGcsServer(backend=store).start()
    cfg.transport.endpoint = server.endpoint
    if cfg.transport.http2 or cfg.transport.native_receive:
        from tpubench_torch.native.engine import get_engine

        get_engine()
    return server


def _pod_rank() -> tuple[int, int]:
    """``(rank, world)`` of the joined process group; ``(0, 1)`` outside
    one."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def share_hermetic_server(cfg: BenchConfig, start):
    """One hermetic server for the pod, as ``tpubench``'s one process has
    one for its chips: rank 0 calls ``start()`` (which sets
    ``cfg.transport.endpoint``) and every rank takes its endpoint (a
    fault plan a rank is a different run). Returns the server on rank 0,
    ``None`` on the others; outside a group of several ranks, ``start()``.
    Call :func:`release_hermetic_server` on every rank before rank 0
    stops it."""
    import torch.distributed as dist

    rank, world = _pod_rank()
    if world == 1:
        return start()
    server = start() if rank == 0 else None
    box = [cfg.transport.endpoint]
    dist.broadcast_object_list(box, src=0)
    if rank:
        t = cfg.transport
        t.endpoint = box[0]
        if t.protocol == "grpc":
            t.directpath = False  # as spawn_hermetic_server sets it
        if t.http2 or t.native_receive:
            from tpubench_torch.native.engine import get_engine

            get_engine()
    return server


def release_hermetic_server() -> None:
    """Every rank of a pod that shares a hermetic server is done with it
    (rank 0 stops it after this returns)."""
    if _pod_rank()[1] > 1:
        from tpubench_torch.dist.bringup import barrier

        barrier()


@contextlib.contextmanager
def hermetic_target(cfg: BenchConfig, populated: bool = False,
                    shared: bool = False):
    """Hermetic-target guard for the lifecycle and drill CLI paths: under
    ``--protocol http``/``--protocol grpc`` with no endpoint, spawn the
    matching in-process fake server (carrying ``transport.fault`` when
    active, so upload faults are injected ON THE WIRE) and restore the
    touched transport fields on exit. Yields the server, or ``None`` when
    the run already has a target (an explicit endpoint, or a protocol like
    ``fake``/``local`` that needs no server).

    The server's store starts empty unless ``populated`` (``drill``,
    whose serve traffic reads the read workload's objects): ``tpubench``'s
    is always prepopulated with them (``workers`` × ``object_size``,
    4.8 GB at the defaults), which no checkpoint command reads.

    ``shared``: the ranks of the joined pod use one server, rank 0's
    (:func:`share_hermetic_server`)."""
    t = cfg.transport
    if t.protocol not in ("http", "grpc") or t.endpoint:
        yield None
        return
    from tpubench_torch.storage.fake import FakeBackend, FaultPlan

    plan = (
        FaultPlan(**dataclasses.asdict(t.fault)) if t.fault.active else None
    )
    restore = (t.endpoint, t.directpath)

    def start():
        return spawn_hermetic_server(
            cfg, fault_plan=plan,
            store=None if populated else FakeBackend(fault=plan))

    server = share_hermetic_server(cfg, start) if shared else start()
    try:
        yield server
        if shared:
            release_hermetic_server()
    finally:
        if server is not None:
            server.stop()
        t.endpoint, t.directpath = restore


def run_chaos(
    cfg: BenchConfig,
    timeline: Optional[list] = None,
    chaos_workload: str = "read",
    tracer=None,
    device="cuda",
):
    """Run ``chaos_workload`` under the scheduled fault timeline and
    return its RunResult with ``extra["chaos"]`` (the scorecard) stamped.

    ``timeline`` (``[[t0, t1, {fault fields}], ...]``) overrides
    ``cfg.transport.fault.phases``. The target is hermetic: the fake
    backend for ``--protocol fake``, an in-process fake GCS server for
    ``http`` (h1.1, or the h2 server with ``--http2``) or ``grpc``.
    ``tracer`` (owned and flush-on-exit-closed by the CLI's
    ``tracer_session``) instruments the read and serve workloads' spans;
    train-ingest/pod-ingest trace through their flight ops alone. The
    workload runs on ``device`` (``"cpu"`` runs without CUDA; CUDA asked
    for and missing raises before anything is armed). pod-ingest, and
    train-ingest's pod path, need a joined process group, as their own
    commands do."""
    from tpubench_torch.device import resolve_device

    resolve_device(device)
    fc = cfg.transport.fault
    if timeline is not None:
        fc.phases = timeline
    # Restored on exit (the caller may reuse cfg; a second run must not
    # inherit this run's stripped byte phases or its host events).
    restore_phases = list(fc.phases or ())
    restore_member_tl = list(cfg.serve.membership_timeline)
    # Host-level membership faults (kill_host / leave_host / pause_host
    # / rejoin_host) ride the SAME timeline as the byte-level fault
    # plan and compose with it — split them out before fault validation
    # (they are membership-plane events, not FaultPlan fields). They
    # are only meaningful under the elastic serve pod.
    from tpubench_torch.config import MEMBER_TIMELINE_ACTIONS

    member_phases = []
    byte_phases = []
    for i, ph in enumerate(fc.phases or ()):
        if (isinstance(ph, (list, tuple)) and len(ph) == 3
                and isinstance(ph[2], dict)
                and set(ph[2]) & set(MEMBER_TIMELINE_ACTIONS)):
            # Numeric window check HERE: member phases skip the byte-
            # level validate_fault_config below, and the full timeline
            # validator only runs later inside run_serve — a malformed
            # stamp must still die as a one-line SystemExit, never a
            # TypeError in the scaling arithmetic.
            try:
                t0, t1 = float(ph[0]), float(ph[1])
            except (TypeError, ValueError):
                raise SystemExit(
                    f"chaos: timeline[{i}]: host-fault window "
                    f"[{ph[0]!r}, {ph[1]!r}] must be numeric"
                ) from None
            member_phases.append([t0, t1, dict(ph[2])])
        else:
            byte_phases.append(ph)
    fc.phases = byte_phases
    if member_phases and chaos_workload != "serve":
        raise SystemExit(
            "chaos: host-level faults (kill_host/leave_host/pause_host/"
            "rejoin_host) compose with the elastic serve pod only — use "
            "--chaos-workload serve with --serve-hosts >= 2"
        )
    validate_fault_config(fc, "transport.fault")
    if not fc.phases and not member_phases:
        raise SystemExit(
            "chaos: no fault timeline — pass --chaos-timeline or the "
            "--chaos-fault/--chaos-start/--chaos-duration trio "
            "(fault.phases in a config file also works)"
        )
    proto = cfg.transport.protocol
    if proto not in ("fake", "http", "grpc") or (
        proto in ("http", "grpc") and cfg.transport.endpoint
    ):
        raise SystemExit(
            "chaos: hermetic protocols only (fake, http[--http2] or "
            "grpc against the in-process fake servers), not "
            f"{proto!r} with endpoint {cfg.transport.endpoint!r} — the "
            "fault plane lives in the fake backend/servers"
        )

    # Scale into a LOCAL fault dict — never back into cfg, which the
    # caller may reuse (a second run must not double-scale its timeline).
    scale = _sleep_scale()
    fdict = scaled_fault_dict(dataclasses.asdict(fc), scale)
    phases = fdict["phases"]
    # The serve plane scales its own (virtual) clock, so the membership
    # timeline passes through UNSCALED; the resilience scorecard maps
    # real record stamps onto scaled seconds, so its fault-window
    # bounding box takes the SCALED twin of each member window.
    score_phases = phases + [
        [t0 * scale, t1 * scale, dict(spec)]
        for t0, t1, spec in member_phases
    ]
    if member_phases:
        cfg.serve.membership_timeline = member_phases

    # Flight recorder is the scorecard's raw material: force it on, sized
    # to hold every read, journaled to disk (a temp path unless the run
    # already asked for one). Every cfg field touched here is restored on
    # exit — the caller's config must survive a second run unchanged
    # (the hedged-vs-plain A/B reuses one config).
    w = cfg.workload
    cfg_restore = {
        "endpoint": cfg.transport.endpoint,
        "directpath": cfg.transport.directpath,
        "flight_records": cfg.obs.flight_records,
        "flight_journal": cfg.obs.flight_journal,
        "journal_max_bytes": cfg.obs.journal_max_bytes,
    }
    # The scorecard segments a COMPLETE journal by completion time:
    # size-bounded rotation could silently drop the baseline window's
    # records and skew goodput-retention toward the fault window, so
    # rotation is off for the scorecard's own journal (restored below;
    # the ring was just sized to hold every expected read anyway).
    cfg.obs.journal_max_bytes = 0
    reads_expected = w.read_calls_per_worker
    if chaos_workload == "train-ingest":
        pl = cfg.pipeline
        reads_expected = pl.steps * pl.epochs * pl.batch_shards
    elif chaos_workload == "serve":
        reads_expected = int(cfg.serve.rate_rps * cfg.serve.duration_s)
    cfg.obs.flight_records = max(
        cfg.obs.flight_records, reads_expected * 2 + 64
    )
    tmp_journal = None
    if not cfg.obs.flight_journal:
        fd, tmp_journal = tempfile.mkstemp(prefix="tpubench-chaos-", suffix=".json")
        os.close(fd)
        cfg.obs.flight_journal = tmp_journal

    from tpubench_torch.storage.fake import FaultPlan

    server = None
    backend = None
    plan = FaultPlan(**fdict)
    try:
        # A pod's ranks (pod-ingest, train-ingest's pod path) share rank
        # 0's server and its armed plan; other arms measure each host.
        pod_arm = chaos_workload == "pod-ingest" or (
            chaos_workload == "train-ingest" and cfg.pipeline.pod)
        if proto in ("http", "grpc"):
            def start():
                return spawn_hermetic_server(cfg, fault_plan=plan)

            server = share_hermetic_server(cfg, start) if pod_arm else start()

        # Pre-build everything expensive (workload import, client
        # backend), then arm: timeline second 0 ≈ the first read, so the
        # baseline window actually measures reads, not bring-up. Both
        # workloads get the SAME armed plan (via the explicit backend),
        # so phase windows and scorecard segments share one epoch.
        if chaos_workload == "read":
            from tpubench_torch.staging.device import make_sink_factory
            from tpubench_torch.workloads.read import run_read

            def _runner(cfg, backend):
                # The CLI's tracer_session hands the tracer in; spans
                # recorded during the fault window are the chaos run's
                # per-read causal story (report trace on the journal).
                # The bytes land on the card through the configured ring.
                return run_read(
                    cfg, backend=backend, tracer=tracer, device=device,
                    sink_factory=make_sink_factory(cfg, device=device),
                )
        elif chaos_workload == "train-ingest":
            # The pipeline smoke path: fault schedules exercise the
            # prefetcher + cache; a blackhole window surfaces as
            # data-stall time in extra["pipeline"]["stall"] (and as
            # stall_begin/stall_end step phases in the journal), never
            # as a hang — demand reads ride the same tail-tolerance +
            # retry stack as every other workload.
            from tpubench_torch.workloads.train_ingest import (
                run_train_ingest,
            )

            def _runner(cfg, backend):
                return run_train_ingest(cfg, backend=backend, device=device)
        elif chaos_workload == "pod-ingest":
            from tpubench_torch.workloads.pod_ingest import run_pod_ingest

            def _runner(cfg, backend):
                return run_pod_ingest(cfg, backend=backend, device=device)
        elif chaos_workload == "serve":
            # The open-loop (optionally elastic) serve plane: byte-level
            # faults hit the shared origin through the fault plan while
            # host-level member_phases change the pod's shape — the
            # "pod that changes shape under live faulty traffic" cell.
            from tpubench_torch.workloads.serve import run_serve

            def _runner(cfg, backend):
                return run_serve(cfg, backend=backend, tracer=tracer,
                                 device=device)
        else:
            raise SystemExit(
                f"chaos: unknown workload {chaos_workload!r} "
                "(read|pod-ingest|train-ingest|serve)"
            )
        from tpubench_torch.storage import open_backend

        backend = open_backend(cfg, fault=plan if proto == "fake" else None)
        # One best-effort warm-up read before arming: connection setup,
        # TLS, stat caches and thread machinery must not be billed to
        # the timeline's baseline window.
        try:
            from tpubench_torch.storage.base import read_object_through

            read_object_through(
                backend.open_read(f"{w.object_name_prefix}0"),
                memoryview(bytearray(w.granule_bytes)),
            )
        except Exception:  # noqa: BLE001 — the run will surface it
            pass
        if pod_arm and _pod_rank()[1] > 1:
            # Every rank's second 0 is the same instant.
            from tpubench_torch.dist.bringup import barrier

            barrier()
        epoch_ns = time.perf_counter_ns()
        plan.arm()
        res = _runner(cfg, backend=backend)
        if pod_arm and proto in ("http", "grpc"):
            release_hermetic_server()

        jpath = res.extra.get("flight_journal") or cfg.obs.flight_journal
        with open(jpath) as f:
            records = json.load(f).get("records", [])
        if tmp_journal is not None:
            # The journal was only the scorecard's scratch input — don't
            # advertise a path that is about to be deleted.
            res.extra.pop("flight_journal", None)
        # Tail-tolerance counters: the read workload stamps them itself;
        # pod-ingest doesn't, but run_chaos holds the wrapped backend —
        # collect here so the scorecard never under-reports what the
        # hedging/watchdog/breaker machinery actually did.
        if "tail" not in res.extra:
            from tpubench_torch.storage.tail import collect_tail_stats

            ts = collect_tail_stats(backend)
            if ts:
                res.extra["tail"] = ts
        res.workload = "chaos"
        res.extra["chaos"] = {
            "workload": chaos_workload,
            "timeline": phases,
            "member_timeline": member_phases,
            "sleep_scale": scale,
            "scorecard": resilience_scorecard(
                records, score_phases, epoch_ns,
                tail_stats=res.extra.get("tail"),
            ),
        }
        return res
    finally:
        if backend is not None:
            backend.close()
        if server is not None:
            server.stop()
        if tmp_journal is not None:
            try:
                os.unlink(tmp_journal)
            except OSError:
                pass
        cfg.transport.endpoint = cfg_restore["endpoint"]
        cfg.transport.directpath = cfg_restore["directpath"]
        cfg.obs.flight_records = cfg_restore["flight_records"]
        cfg.obs.flight_journal = cfg_restore["flight_journal"]
        cfg.obs.journal_max_bytes = cfg_restore["journal_max_bytes"]
        cfg.transport.fault.phases = restore_phases
        cfg.serve.membership_timeline = restore_member_tl
