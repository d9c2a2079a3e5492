"""Staging stats assembly + rendering — a copy of
``tpubench/staging/stats.py``, which cannot be imported without jax
(``tpubench/staging/__init__.py`` loads the jax stagers). Kept apart from
the stagers so rendering ``extra["staging"]`` needs no device runtime.
"""

from __future__ import annotations

from typing import Optional


def staging_efficiency(
    wait_ns: float, put_submit_ns: float, flight_ns: float, overlapped: bool
) -> Optional[float]:
    """Fraction of transfer flight time HIDDEN from the fetch thread:
    a serial pipeline waits out every transfer (→ ~0.0), a fully
    overlapped one never blocks (→ 1.0). Serial submits run ON the
    fetch thread (and on some runtimes the whole transfer happens
    inside the submission call), so the serial numerator counts
    put_submit too; the overlap reaper's submit time is concurrent
    with fetch and excluded. Single-sourced here — the window, the
    per-stager finish() stats, and the pooled extra["staging"] block
    must never disagree on the definition."""
    if flight_ns <= 0:
        return None
    blocked = wait_ns if overlapped else wait_ns + put_submit_ns
    return max(0.0, min(1.0, 1.0 - blocked / flight_ns))


def staging_extra(stats_list: list) -> Optional[dict]:
    """``extra["staging"]`` block from per-worker stager finish() stats:
    the overlap story — depth, transfers-in-flight gauge (p50/max),
    transfer wait vs flight time, and the pooled staging_efficiency
    (fraction of transfer flight time hidden from the fetch threads).
    Time fields are per-worker averages (staging_breakdown convention);
    byte/count fields are totals. None when no stager reported."""
    live = [st for st in stats_list if st and "transfer_flight_ns" in st]
    if not live:
        return None
    k = len(live)
    wait = sum(st.get("transfer_wait_ns", 0) for st in live)
    put = sum(st.get("put_submit_ns", 0) for st in live)
    flight = sum(st.get("transfer_flight_ns", 0) for st in live)
    overlap = live[0].get("drain") == "overlap"
    eff = staging_efficiency(wait, put, flight, overlap)
    return {
        "workers": k,
        "depth": max(st.get("depth", 1) for st in live),
        "drain": live[0].get("drain", "inline"),
        "transfers": sum(st.get("transfers", 0) for st in live),
        "staged_bytes": sum(st.get("staged_bytes", 0) for st in live),
        "transfer_wait_s": round(wait / 1e9 / k, 6),
        "submit_s": round(put / 1e9 / k, 6),
        "transfer_flight_s": round(flight / 1e9 / k, 6),
        "transfer_inflight": {
            "p50": round(
                sum(st.get("inflight_p50", 0.0) for st in live) / k, 2
            ),
            "max": max(st.get("inflight_max", 0) for st in live),
        },
        "out_of_order_completions": sum(
            st.get("out_of_order_completions", 0) for st in live
        ),
        "staging_efficiency": round(eff, 4) if eff is not None else None,
    }


def format_staging_block(d: dict) -> str:
    """One-line human rendering of ``extra["staging"]`` (printed by the
    CLI next to the scorecard)."""
    eff = d.get("staging_efficiency")
    infl = d.get("transfer_inflight") or {}
    return (
        f"  staging: drain={d.get('drain', '?')} depth={d.get('depth', '?')} "
        f"transfers={d.get('transfers', 0)} "
        f"inflight p50={infl.get('p50', 0)}/max={infl.get('max', 0)} "
        f"ooo={d.get('out_of_order_completions', 0)}  "
        f"transfer_wait={d.get('transfer_wait_s', 0.0):.3f}s "
        f"flight={d.get('transfer_flight_s', 0.0):.3f}s "
        f"efficiency={f'{eff:.1%}' if eff is not None else 'n/a'}"
    )
