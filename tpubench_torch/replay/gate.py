"""``report --fail-on`` — the exit-code regression contract (a copy of
``tpubench/replay/gate.py``).

A ``--fail-on`` expression is a FAILURE CONDITION over the metrics a
result document carries: ``<metric><op><threshold>`` (no spaces), e.g.
``--fail-on 'goodput_retention<0.9'`` makes ``report`` exit
non-zero when a replay retained less than 90 % of the original's
goodput. Repeatable; any violated expression fails the report. Exit
codes: 0 = every gate holds, 1 = a gate tripped, 2 = a named metric
exists in none of the documents (a typo'd gate must fail CI loudly,
never silently pass).

:func:`metric_namespace` is the one definition of which names are
gateable and where they come from — knee/SLO/goodput/staging/rewarm/
retention across serve, sweep, chaos, membership, bench-cell and replay
documents, with replay's diff metrics merged last (a replay doc's
``goodput_retention`` is the replay-vs-original ratio, not the chaos
fault-window one).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

# Two-character operators first: "<=" must never parse as "<" + "=0.9".
_OPS = ("<=", ">=", "==", "!=", "<", ">")


def parse_fail_on(expr: str) -> tuple[str, str, float]:
    """Split ``<metric><op><threshold>``; one-line SystemExit on
    malformed grammar (the config-validation discipline)."""
    for op in _OPS:
        if op in expr:
            metric, _, rhs = expr.partition(op)
            metric = metric.strip()
            rhs = rhs.strip()
            if not metric or any(o in metric for o in _OPS):
                break
            try:
                threshold = float(rhs)
            except ValueError:
                raise SystemExit(
                    f"report --fail-on {expr!r}: threshold {rhs!r} is "
                    "not a number"
                ) from None
            return metric, op, threshold
    raise SystemExit(
        f"report --fail-on {expr!r}: expected <metric><op><threshold> "
        f"with op one of {', '.join(_OPS)} (e.g. 'gold_slo<0.95')"
    )


def _holds(value: float, op: str, threshold: float) -> bool:
    return {
        "<": value < threshold,
        ">": value > threshold,
        "<=": value <= threshold,
        ">=": value >= threshold,
        "==": value == threshold,
        "!=": value != threshold,
    }[op]


def _put(ns: dict, name: str, value) -> None:
    if isinstance(value, bool):
        ns[name] = 1.0 if value else 0.0
    elif isinstance(value, (int, float)):
        ns[name] = float(value)


def metric_namespace(doc: dict) -> dict:
    """Flatten one result document into gateable ``name -> float``
    pairs. Later sources override earlier ones on a name collision —
    replay diff metrics land LAST by design."""
    ns: dict = {}
    if not isinstance(doc, dict):
        return ns
    _put(ns, "gbps", doc.get("gbps"))
    _put(ns, "errors", doc.get("errors"))
    req = (doc.get("summaries") or {}).get("request") or {}
    _put(ns, "p50_ms", req.get("p50_ms"))
    _put(ns, "p99_ms", req.get("p99_ms"))
    # Bench-cell / BENCH_rN-wrapper documents (bench.py output lines).
    _put(ns, "value", doc.get("value"))
    _put(ns, "staging_efficiency", doc.get("staging_efficiency"))
    extra = doc.get("extra") or {}
    stg = extra.get("staging") or {}
    _put(ns, "staging_efficiency", stg.get("staging_efficiency"))
    sv = extra.get("serve") or {}
    for k in ("goodput_gbps", "achieved_rps", "offered_rps", "arrivals",
              "completed", "shed", "jain_fairness"):
        _put(ns, k, sv.get(k))
    classes = sv.get("classes") or {}
    gold_name = None
    if classes:
        gold_name, gold = min(
            classes.items(), key=lambda kv: kv[1].get("priority", 0)
        )
        _put(ns, "gold_slo", gold.get("slo_attainment"))
        _put(ns, "gold_p99_ms", gold.get("p99_ms"))
    knee = (sv.get("sweep") or {}).get("knee") or {}
    _put(ns, "knee_rps", knee.get("offered_rps"))
    dr = extra.get("drill") or {}
    if dr:
        rst = dr.get("restore") or {}
        _put(ns, "time_to_restore_s", rst.get("time_to_restore_s"))
        _put(ns, "restore_verified", rst.get("verified"))
        _put(ns, "restore_errors", rst.get("errors"))
        _put(ns, "restore_torn_rereads", rst.get("torn_rereads"))
        _put(ns, "restore_forced_direct", rst.get("forced_direct"))
        _put(ns, "time_to_rewarm_s", dr.get("time_to_rewarm_s"))
        saves = dr.get("saves") or {}
        _put(ns, "save_cas_conflicts", saves.get("cas_conflicts"))
        _put(ns, "save_errors", saves.get("errors"))
        _put(ns, "save_bytes_uploaded", saves.get("bytes_uploaded"))
        amp = dr.get("amplification") or {}
        _put(ns, "origin_amplification", amp.get("ratio"))
        slo = dr.get("gold_slo") or {}
        if gold_name is not None:
            _put(
                ns, "drill_gold_slo_restore",
                (slo.get("restore_window") or {}).get(gold_name),
            )
            _put(
                ns, "drill_gold_slo_steady",
                (slo.get("steady") or {}).get(gold_name),
            )
    dknee = (extra.get("drill_sweep") or {}).get("knee") or {}
    _put(ns, "save_knee_rps", dknee.get("offered_rps"))
    mb = extra.get("membership") or {}
    if mb:
        rewarms = [
            ev.get("time_to_rewarm_s") for ev in mb.get("events", ())
            if ev.get("time_to_rewarm_s") is not None
        ]
        if rewarms:
            _put(ns, "rewarm_s", max(rewarms))
        _put(ns, "failovers", mb.get("failovers"))
    chaos = (extra.get("chaos") or {}).get("scorecard") or {}
    for k in ("goodput_retention", "p99_inflation", "time_to_recover_s",
              "failed_reads"):
        _put(ns, k, chaos.get(k))
    rp = extra.get("replay") or {}
    if rp:
        _put(ns, "config_match", rp.get("config_match"))
        _put(ns, "arrivals_match", rp.get("arrivals_match"))
        for k, v in (rp.get("replayed") or {}).items():
            _put(ns, k, v)
        # The diff wins every collision: in a replay document,
        # goodput_retention MEANS replay-vs-original.
        for k, v in (rp.get("diff") or {}).items():
            _put(ns, k, v)
        drp = rp.get("drill") or {}
        for k, v in (drp.get("replayed") or {}).items():
            _put(ns, k, v)
        for k, v in (drp.get("diff") or {}).items():
            _put(ns, k, v)
    return ns


def run_fail_on(
    exprs: Sequence[str],
    docs: Iterable,
    paths: Optional[Sequence[str]] = None,
) -> tuple[int, list[str]]:
    """Evaluate every expression over every document. Returns
    ``(exit_code, report_lines)``: 2 (unknown metric) dominates 1
    (violated gate) dominates 0 — a gate that can't even be looked up
    is the worse CI failure."""
    parsed = [parse_fail_on(e) for e in exprs]
    spaces = [metric_namespace(d) for d in docs]
    paths = list(paths or [])
    rc = 0
    lines: list[str] = []
    for (metric, op, threshold), expr in zip(
        parsed, exprs
    ):
        hits = []
        for i, ns in enumerate(spaces):
            if metric not in ns:
                continue
            label = paths[i] if i < len(paths) else f"doc[{i}]"
            hits.append((label, ns[metric]))
        if not hits:
            known = sorted(set().union(*spaces)) if spaces else []
            lines.append(
                f"fail-on {expr!r}: metric {metric!r} not present in "
                "any document (available: "
                + (", ".join(known) if known else "none") + ")"
            )
            rc = 2
            continue
        for label, value in hits:
            if _holds(value, op, threshold):
                lines.append(
                    f"fail-on {expr!r}: TRIPPED by {label} "
                    f"({metric}={value:g})"
                )
                if rc == 0:
                    rc = 1
            else:
                lines.append(
                    f"fail-on {expr!r}: ok for {label} "
                    f"({metric}={value:g})"
                )
    return rc, lines
