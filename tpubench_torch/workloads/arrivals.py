"""Shared arrival processes + popularity laws for open-loop workloads
(``tpubench/workloads/arrivals.py``, copied: numpy only, no device).

Every closed-loop workload paces itself (a fixed worker pool
pulls as fast as it can); the serve plane is OPEN-LOOP — requests arrive
on their own schedule whether or not the system keeps up, which is the
only regime where a saturation knee exists to measure (the Pulsar
enterprise-scale methodology: sweep offered load, report
latency-vs-load, not one operating point).

This module is the single definition of the two statistical surfaces
serve and the coop simulation must agree on:

* :func:`zipf_plan` — the Zipf-hot chunk popularity law (promoted out of
  ``pipeline/coop.py``, which imports it back, so the two workloads can
  never drift on what "hot set" means);
* the arrival processes — Poisson, bursty (two-state MMPP), diurnal
  (thinned nonhomogeneous Poisson) and replayed-trace — all returning a
  sorted timeline of arrival timestamps in *virtual seconds from run
  start*, deterministic for a given seed (``np.random.Philox``, the
  zipf_plan discipline).

Timelines are VIRTUAL: generation never sleeps. The dispatcher that
replays one applies :func:`scaled_gaps` — the shared
``TPUBENCH_BENCH_SLEEP_SCALE`` contract (``config.parse_sleep_scale``)
with a per-gap floor, so a scaled-down hermetic run still *paces* its
bursts instead of collapsing every gap to zero and measuring a batch
submit instead of an arrival process.
"""

from __future__ import annotations

import json
import math
from typing import Optional, Sequence

import numpy as np

from tpubench_torch.pipeline.cache import ChunkKey
from tpubench_torch.storage.base import ObjectMeta


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(seed))


# -------------------------------------------------------------- popularity --


def zipf_keys_weights(
    objects: Sequence[ObjectMeta],
    chunk_bytes: int,
    *,
    bucket: str = "",
    alpha: float = 1.2,
) -> tuple[list[ChunkKey], np.ndarray]:
    """The ranked chunk list + normalized Zipf(alpha) weight vector —
    shared setup for :func:`zipf_plan` and callers that draw MANY
    per-tenant streams over one object set (the serve schedule:
    enumerating keys and renormalizing per tenant would be
    O(tenants × chunks) for identical data)."""
    keys: list[ChunkKey] = []
    for meta in objects:
        off = 0
        while off < meta.size:
            n = min(chunk_bytes, meta.size - off)
            keys.append(ChunkKey(bucket, meta.name, meta.generation, off, n))
            off += n
    if not keys:
        raise ValueError("zipf_plan: empty object set")
    weights = 1.0 / np.power(
        np.arange(1, len(keys) + 1, dtype=np.float64), alpha
    )
    weights /= weights.sum()
    return keys, weights


def zipf_plan(
    objects: Sequence[ObjectMeta],
    chunk_bytes: int,
    n_accesses: int,
    *,
    bucket: str = "",
    alpha: float = 1.2,
    seed: int = 0,
) -> list[ChunkKey]:
    """A Zipf-hot chunk access sequence: chunks ranked across the object
    set, rank r drawn with probability ∝ 1/r^alpha — the hot-set shape
    real dataset popularity follows (and the one cooperative caching
    exists to exploit: most accesses land on a small shared hot set)."""
    keys, weights = zipf_keys_weights(
        objects, chunk_bytes, bucket=bucket, alpha=alpha
    )
    rng = _rng(seed)
    idx = rng.choice(len(keys), size=n_accesses, p=weights)
    return [keys[i] for i in idx]


# ---------------------------------------------------------------- arrivals --


def poisson_arrivals(
    rate_rps: float, duration_s: float, *, seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> list[float]:
    """Homogeneous Poisson process: i.i.d. exponential inter-arrival
    gaps at ``rate_rps`` — the memoryless open-loop baseline."""
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = rng if rng is not None else _rng(seed)
    out: list[float] = []
    t = 0.0
    # Draw in batches: one exponential at a time would make the rng call
    # count (and thus the stream position) depend on float rounding.
    est = max(16, int(rate_rps * duration_s * 1.5) + 8)
    while t < duration_s:
        for g in rng.exponential(1.0 / rate_rps, size=est):
            t += float(g)
            if t >= duration_s:
                break
            out.append(t)
    return out


def mmpp_arrivals(
    rate_rps: float, duration_s: float, *, burst_factor: float = 4.0,
    burst_fraction: float = 0.25, cycle_s: float = 1.0, seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> list[float]:
    """Bursty arrivals: a two-state Markov-modulated Poisson process.
    The process alternates a quiet state and a burst state (the burst
    occupies ``burst_fraction`` of each ``cycle_s``); rates are scaled
    so the MEAN offered load stays ``rate_rps`` — the burst A/B varies
    shape, not volume. ``burst_factor`` is the burst-to-quiet rate
    ratio. Where ``tpubench``'s loop ends, this one gives the same
    timeline bit for bit; where a window edge falls below t's float
    resolution, ``tpubench``'s never ends and this one steps past the
    edge."""
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = rng if rng is not None else _rng(seed)
    bf = max(1.0, burst_factor)
    frac = min(max(burst_fraction, 1e-6), 1.0 - 1e-6)
    # mean = quiet*(1-frac) + quiet*bf*frac  =>  quiet = mean / (1-frac+bf*frac)
    quiet = rate_rps / ((1.0 - frac) + bf * frac)
    burst = quiet * bf
    out: list[float] = []
    t = 0.0
    while t < duration_s:
        cycle_t = t % cycle_s
        in_burst = cycle_t < frac * cycle_s
        rate = burst if in_burst else quiet
        g = float(rng.exponential(1.0 / rate))
        # Clip the gap at the state boundary so a long quiet draw can't
        # leap over the next burst window (state changes mid-gap).
        boundary = (frac * cycle_s - cycle_t) if in_burst \
            else (cycle_s - cycle_t)
        if g > boundary:
            nt = t + boundary
            if nt == t:
                # ``t % cycle_s`` landed a rounding error short of the
                # edge and the step is below t's resolution: ``tpubench``
                # spins here for ever. Take the edge from the cycle's
                # index instead, or the next float past t when that edge
                # rounds to t itself (the state then flips).
                k = round((t - cycle_t) / cycle_s)
                edge = k * cycle_s + (frac * cycle_s if in_burst else cycle_s)
                nt = edge if edge > t else math.nextafter(t, math.inf)
            t = nt
            continue
        t += g
        if t < duration_s:
            out.append(t)
    return out


def diurnal_arrivals(
    rate_rps: float, duration_s: float, *, period_s: float = 4.0,
    depth: float = 0.8, seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> list[float]:
    """Diurnal arrivals: a nonhomogeneous Poisson process whose rate
    follows ``rate*(1 + depth*sin(2πt/period))`` — the day/night swing
    compressed to ``period_s``. Generated by thinning against the peak
    rate (the standard construction, deterministic under the seed)."""
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = rng if rng is not None else _rng(seed)
    depth = min(max(depth, 0.0), 0.999)
    peak = rate_rps * (1.0 + depth)
    out: list[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= duration_s:
            break
        lam = rate_rps * (1.0 + depth * np.sin(2.0 * np.pi * t / period_s))
        if rng.random() < lam / peak:
            out.append(t)
    return out


def trace_arrivals(
    times: Sequence[float], duration_s: float = 0.0,
) -> list[float]:
    """Replayed-trace arrivals: explicit timestamps (seconds from run
    start), sorted, non-negative, clipped to ``duration_s`` when one is
    given — the bring-your-own-workload path."""
    out = sorted(float(t) for t in times if t >= 0)
    if duration_s > 0:
        out = [t for t in out if t < duration_s]
    return out


def load_trace(path: str) -> list[float]:
    """A trace file is a JSON list of arrival timestamps (seconds)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, list):
        raise SystemExit(
            f"serve trace {path!r}: expected a JSON list of arrival "
            "timestamps (seconds from run start)"
        )
    return [float(t) for t in doc]


ARRIVAL_KINDS = ("poisson", "bursty", "diurnal", "trace")


def make_arrivals(
    kind: str, rate_rps: float, duration_s: float, *, seed: int = 0,
    burst_factor: float = 4.0, burst_fraction: float = 0.25,
    burst_cycle_s: float = 1.0, diurnal_period_s: float = 4.0,
    trace: Optional[Sequence[float]] = None,
) -> list[float]:
    """Dispatcher over the arrival kinds (one seed → one timeline; the
    schedule-replay test pins identical seeds → identical timelines)."""
    if kind == "poisson":
        return poisson_arrivals(rate_rps, duration_s, seed=seed)
    if kind == "bursty":
        return mmpp_arrivals(
            rate_rps, duration_s, burst_factor=burst_factor,
            burst_fraction=burst_fraction, cycle_s=burst_cycle_s, seed=seed,
        )
    if kind == "diurnal":
        return diurnal_arrivals(
            rate_rps, duration_s, period_s=diurnal_period_s, seed=seed,
        )
    if kind == "trace":
        return trace_arrivals(trace or (), duration_s)
    raise ValueError(
        f"unknown arrival kind {kind!r}; have {'/'.join(ARRIVAL_KINDS)}"
    )


def scaled_gaps(
    times: Sequence[float], scale: float, floor_s: float = 1e-4,
) -> list[float]:
    """Inter-arrival sleep gaps for replaying a virtual timeline under
    ``TPUBENCH_BENCH_SLEEP_SCALE`` (the shared ``parse_sleep_scale``
    contract): each positive gap scales by ``scale`` but never below
    ``floor_s`` — a scaled-to-zero schedule would submit the whole run
    as one batch and a "burst" would stop being a burst. ``scale == 0``
    keeps the floor for the same reason (0 disables *refill* sleeps
    elsewhere; an arrival process with no gaps is not that process)."""
    gaps: list[float] = []
    prev = 0.0
    for t in times:
        g = max(0.0, t - prev)
        prev = t
        gaps.append(max(g * scale, floor_s) if g > 0 else 0.0)
    return gaps
