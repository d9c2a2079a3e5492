"""Replay stamps (the stamp half of ``tpubench/replay/bundle.py``, copied).

A serve run stamps a ``replay`` block into its flight journal: the
arrival timeline, the object population, the fault timeline, the
membership plan, the tenant/class map, the system-half config
fingerprint and the run's distilled scorecard. That block is what
recording a bundle reads. Writing, loading and replaying bundles are not
ported yet (``ROADMAP.md`` A.7); the stamp is, so that a journal written
by the port holds the same ``replay`` block as one written by
``tpubench``.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional, Sequence

BUNDLE_FORMAT = "tpubench-bundle/1"

# Version of the bundle CONTENT contract (what journal_replay_stamp
# promises); the format string above is the envelope. A reader refuses
# stamps/bundles newer than this rather than misparse them.
BUNDLE_SCHEMA = 1

# ---------------------------------------------------------- fingerprint --


def _system_view(cfg_dict: dict) -> dict:
    """The SYSTEM half of a config — the knobs that shape how a scenario
    is served, not what the scenario is. Endpoint and fault are excluded
    (the endpoint is per-process ephemera; the fault plan is scenario,
    carried verbatim in the bundle), and only the serve knobs that are
    not scenario-owned count."""
    transport = dict(cfg_dict.get("transport") or {})
    transport.pop("endpoint", None)
    transport.pop("fault", None)
    serve = cfg_dict.get("serve") or {}
    return {
        "transport": transport,
        "pipeline": cfg_dict.get("pipeline"),
        "staging": cfg_dict.get("staging"),
        "coop": cfg_dict.get("coop"),
        "tune": cfg_dict.get("tune"),
        "serve_system": {
            k: serve.get(k)
            for k in (
                "workers", "qos", "admission_cap", "queue_limit",
                "readahead",
            )
        },
    }


def config_fingerprint(cfg_dict: dict) -> str:
    """Short stable digest of the system half of a config. Two runs with
    the same fingerprint served their scenario through the same stack —
    the replay scorecard's "identical config" precondition, and the
    A/B marker when a bundle is replayed under a different one."""
    payload = json.dumps(
        _system_view(cfg_dict), sort_keys=True, separators=(",", ":"),
    )
    return hashlib.blake2b(payload.encode(), digest_size=12).hexdigest()


# ------------------------------------------------------------- distilling --


def distill_baseline(
    serve_extra: dict,
    *,
    errors: int = 0,
    p99_ms: Optional[float] = None,
    membership: Optional[dict] = None,
) -> dict:
    """The replay-comparable core of a serve scorecard: the numbers a
    replay is judged against (and re-measures for itself). ``gold`` is
    the highest-priority class — the one QoS exists to protect."""
    classes = serve_extra.get("classes") or {}
    gold = min(
        classes.values(), key=lambda c: c.get("priority", 0)
    ) if classes else {}
    rewarm = None
    failovers = None
    if membership:
        rewarms = [
            ev.get("time_to_rewarm_s")
            for ev in membership.get("events", ())
            if ev.get("time_to_rewarm_s") is not None
        ]
        rewarm = max(rewarms) if rewarms else None
        failovers = membership.get("failovers")
    return {
        "arrivals": serve_extra.get("arrivals"),
        "completed": serve_extra.get("completed"),
        "shed": serve_extra.get("shed"),
        "errors": errors,
        "goodput_gbps": serve_extra.get("goodput_gbps"),
        "achieved_rps": serve_extra.get("achieved_rps"),
        "jain_fairness": serve_extra.get("jain_fairness"),
        "gold_slo": gold.get("slo_attainment"),
        "gold_p99_ms": gold.get("p99_ms"),
        "p99_ms": p99_ms,
        "rewarm_s": rewarm,
        "failovers": failovers,
    }


def journal_replay_stamp(
    cfg,
    schedule: Sequence,
    objects: Sequence,
    serve_extra: dict,
    *,
    rate_rps: float,
    membership: Optional[dict] = None,
    drill: Optional[dict] = None,
    errors: int = 0,
    p99_ms: Optional[float] = None,
    source: Optional[dict] = None,
) -> dict:
    """The ``replay`` block a serve run stamps into its flight journal —
    everything recording a bundle needs to rebuild the run as a bundle.
    ``objects`` MUST be the same list the schedule was built over (the
    population, not a re-listing that might race a mutating backend);
    ``rate_rps`` is the EFFECTIVE offered load (sweep points override
    the config's). ``drill`` (the drill plan; the drill workload is not
    ported yet, so the port's serve runs pass None) marks the run as an
    incident drill: the bundle carries the incident plan and checkpoint
    shape alongside the serve scenario. ``source`` is set by replay runs: the bundle identity
    they were driven from, so re-recording a replay reproduces the
    original bundle byte-for-byte."""
    sc = cfg.serve
    w = cfg.workload
    import dataclasses

    stamp = {
        "bundle_schema": BUNDLE_SCHEMA,
        "workload": "drill" if drill is not None else "serve",
        "scenario": {
            "arrivals": [float(r.arrival_s) for r in schedule],
            "rate_rps": float(rate_rps),
            "duration_s": float(sc.duration_s),
            "seed": int(sc.seed),
            "tenants": int(sc.tenants),
            "alpha": float(sc.alpha),
            "chunk_bytes": int(sc.chunk_bytes or w.granule_bytes),
            "classes": [dict(c) for c in sc.classes],
            "objects": sorted(
                [m.name, int(m.size), int(m.generation)] for m in objects
            ),
            "object_prefix": w.object_name_prefix,
            "bucket": w.bucket,
            "fault": dataclasses.asdict(cfg.transport.fault),
            "membership": {
                "hosts": int(sc.hosts),
                "timeline": [
                    [float(t0), float(t1), dict(spec)]
                    for t0, t1, spec in sc.membership_timeline
                ],
                "resize_window_s": float(sc.resize_window_s),
            },
            # Emitted unconditionally (None for serve) — the bundle
            # field catalog is a drift-guard surface, never optional.
            "drill": drill,
        },
        "baseline": distill_baseline(
            serve_extra, errors=errors, p99_ms=p99_ms,
            membership=membership,
        ),
        "fingerprint": config_fingerprint(cfg.to_dict()),
    }
    if source:
        stamp["source"] = dict(source)
    return stamp
