"""``replay`` — re-drive a recorded bundle through the stack (a copy of
``tpubench/replay/driver.py``).

The driver rebuilds a bundle's scenario hermetically and runs it through
whatever SYSTEM configuration the caller brought:

* **arrivals** ride the existing ``trace`` schedule kind (the recorded
  timeline lands in a temp trace file) at the recorded rate/duration/
  seed/tenant/class map, so every serve RNG stream — tenant map, class
  assignment, per-tenant Zipf draws — reproduces the original schedule
  exactly;
* the **object population** rebuilds via
  ``FakeBackend.from_population`` (names + sizes + generations from the
  bundle; contents from ``deterministic_bytes``), wrapped with the same
  tail-tolerance + retry layers ``open_backend`` applies everywhere;
* **faults** re-arm via :class:`FaultPlan`, scaled by the chaos plane's
  ``scaled_fault_dict`` discipline (same TPUBENCH_BENCH_SLEEP_SCALE
  contract, so a replayed incident keeps the incident's shape);
* **membership** entries feed ``_ElasticServe`` through
  ``serve.membership_timeline`` untouched.

Scenario knobs come FROM the bundle; system knobs (workers, QoS,
admission, readahead, cache, transport, coop) stay with the caller's
config — replaying under the original fingerprint is the regression
check, replaying under a different one is the A/B. The result carries
``extra["replay"]``: original vs replayed scorecards plus their diff.

Where ``tpubench`` swallows a failed warm-up read before arming the
fault plan, the port raises: a replay whose first read fails has no
baseline to stand on. Nothing is staged on a device; ``device`` is
resolved as every entry point resolves it.
"""

from __future__ import annotations

import json
import os
import tempfile

from tpubench_torch.config import (
    BenchConfig,
    FaultConfig,
    parse_sleep_scale,
    validate_fault_config,
)
from tpubench_torch.device import resolve_device
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.replay.bundle import (
    config_fingerprint,
    distill_baseline,
    distill_drill,
    drill_diff,
    scorecard_diff,
)


def _scenario_config(cfg: BenchConfig, bundle: dict,
                     trace_path: str) -> BenchConfig:
    """The replay run's config: the caller's SYSTEM half with the
    bundle's SCENARIO half written over it (a deep copy — the caller's
    config must survive, the serve A/B reuse discipline)."""
    rcfg = BenchConfig.from_dict(cfg.to_dict())
    sc = rcfg.serve
    sc.arrival = "trace"
    sc.trace_path = trace_path
    sc.rate_rps = float(bundle["rate_rps"])
    sc.duration_s = float(bundle["duration_s"])
    sc.seed = int(bundle["seed"])
    sc.tenants = int(bundle["tenants"])
    sc.alpha = float(bundle["alpha"])
    sc.chunk_bytes = int(bundle["chunk_bytes"])
    sc.classes = [dict(c) for c in bundle["classes"]]
    member = bundle.get("membership") or {}
    sc.hosts = int(member.get("hosts", 1))
    sc.membership_timeline = [
        [float(t0), float(t1), dict(spec)]
        for t0, t1, spec in member.get("timeline") or ()
    ]
    sc.resize_window_s = float(member.get("resize_window_s", 1.0))
    rcfg.workload.object_name_prefix = bundle["object_prefix"]
    rcfg.workload.bucket = bundle["bucket"]
    # The UNSCALED fault plan lands in the config (what the journal's
    # own replay stamp re-records); the ARMED plan is scaled below.
    rcfg.transport.fault = FaultConfig(**(bundle.get("fault") or {}))
    validate_fault_config(rcfg.transport.fault, "bundle fault")
    drill = bundle.get("drill") or None
    if drill:
        # The incident plan and checkpoint shape are scenario, not
        # system: a drill bundle replays the SAME kill/join/save/restore
        # script under the caller's stack. Unknown plan keys (newer
        # bundle) are refused by validate_bundle's field check upstream;
        # here only knobs this build knows are folded.
        dc = rcfg.drill
        for k, v in (drill.get("plan") or {}).items():
            if hasattr(dc, k):
                setattr(dc, k, v)
        lc = rcfg.lifecycle
        for k, v in (drill.get("checkpoint") or {}).items():
            if hasattr(lc, k):
                setattr(lc, k, v)
    return rcfg


def run_replay(cfg: BenchConfig, bundle: dict, tracer=None,
               device="cuda") -> RunResult:
    """Re-drive ``bundle`` under ``cfg``'s system knobs and stamp the
    replay-vs-original scorecard into ``extra["replay"]``. Hermetic by
    construction (the chaos rule): the fault plane and the recorded
    population live in the fake backend/servers, so only ``fake`` and
    endpoint-less ``http`` targets replay."""
    from tpubench_torch.storage import RetryingBackend, open_backend, wrap_tail
    from tpubench_torch.storage.base import ObjectMeta, read_object_through
    from tpubench_torch.storage.fake import FakeBackend, FaultPlan
    from tpubench_torch.workloads.chaos import (
        scaled_fault_dict,
        spawn_hermetic_server,
    )
    from tpubench_torch.workloads.serve import run_serve

    resolve_device(device)
    is_drill = bundle.get("workload") == "drill"

    proto = cfg.transport.protocol
    if proto not in ("fake", "http") or (
        proto == "http" and cfg.transport.endpoint
    ):
        raise SystemExit(
            "replay: hermetic protocols only (fake, or http[--http2] "
            f"against the in-process fake server), not {proto!r} with "
            f"endpoint {cfg.transport.endpoint!r} — the recorded "
            "population and fault plane live in the fake backend/servers"
        )

    objects = [
        ObjectMeta(str(name), int(size), int(gen))
        for name, size, gen in bundle["objects"]
    ]
    if not objects:
        raise SystemExit(
            f"replay: bundle {bundle.get('name')!r} records an empty "
            "object population — nothing to serve"
        )

    fd, trace_path = tempfile.mkstemp(
        prefix="tpubench-replay-", suffix=".json"
    )
    with os.fdopen(fd, "w") as f:
        json.dump(list(bundle["arrivals"]), f)
    rcfg = _scenario_config(cfg, bundle, trace_path)

    scale = parse_sleep_scale("replay timeline durations")
    plan = FaultPlan(
        **scaled_fault_dict(dict(bundle.get("fault") or {}), scale)
    )
    store = FakeBackend.from_population(objects, fault=plan)

    server = None
    backend = None
    try:
        if proto == "http":
            server = spawn_hermetic_server(rcfg, store=store)
            backend = open_backend(rcfg, tracer=tracer)
        else:
            # The open_backend wrapping, applied to the recorded
            # population: tail tolerance INSIDE retry, exactly as every
            # live run gets it — a replay must not skip the layers the
            # original served through.
            inner = wrap_tail(
                store, rcfg.transport.tail,
                chunk_bytes=rcfg.workload.granule_bytes,
            )
            backend = inner if rcfg.transport.retry.policy == "never" \
                else RetryingBackend(inner, rcfg.transport.retry)
        # Warm-up before arming (the chaos discipline): bring-up costs
        # must not land inside the replayed timeline's first seconds. A
        # failure raises here (``tpubench`` passes over it).
        read_object_through(
            backend.open_read(objects[0].name),
            memoryview(bytearray(min(objects[0].size,
                                     rcfg.workload.granule_bytes))),
        )
        plan.arm()
        replay_source = {
            "name": bundle["name"],
            "fingerprint": bundle["config_fingerprint"],
            "baseline": bundle["baseline"],
        }
        if is_drill:
            from tpubench_torch.workloads.drill import run_drill

            # The original drill block passes through so re-recording a
            # drill replay reproduces the ORIGINAL bundle (plan and
            # checkpoint shape rebuild identically anyway; the BASELINE
            # must be the original's, not the replay's).
            replay_source["drill"] = bundle.get("drill")

            res = run_drill(
                rcfg, backend=backend, tracer=tracer,
                replay_source=replay_source,
                save_interval_s=(
                    (bundle["drill"].get("plan") or {})
                    .get("save_interval_s")
                ),
                device=device,
            )
        else:
            res = run_serve(
                rcfg, backend=backend, tracer=tracer,
                replay_source=replay_source, device=device,
            )
    finally:
        if backend is not None:
            backend.close()
        if server is not None:
            server.stop()
        try:
            os.unlink(trace_path)
        except OSError:
            pass

    s = res.summaries.get("request")
    replayed = distill_baseline(
        res.extra["serve"], errors=res.errors,
        p99_ms=s.p99_ms if s is not None else None,
        membership=res.extra.get("membership"),
    )
    baseline = bundle.get("baseline") or {}
    fp = config_fingerprint(rcfg.to_dict())
    res.workload = "replay"
    res.extra["replay"] = {
        "bundle": bundle["name"],
        "fingerprint": fp,
        "original_fingerprint": bundle["config_fingerprint"],
        "config_match": fp == bundle["config_fingerprint"],
        "arrivals_match": (
            res.extra["serve"].get("arrivals") == len(bundle["arrivals"])
        ),
        "sleep_scale": scale,
        "baseline": baseline,
        "replayed": replayed,
        "diff": scorecard_diff(baseline, replayed),
    }
    if is_drill:
        drill_baseline = (bundle.get("drill") or {}).get("baseline") or {}
        drill_replayed = distill_drill(res.extra.get("drill") or {})
        res.extra["replay"]["drill"] = {
            "baseline": drill_baseline,
            "replayed": drill_replayed,
            "diff": drill_diff(drill_baseline, drill_replayed),
        }
    return res
