"""Latency percentile math and report formatting.

Reproduces the reference ssd_test driver's in-process percentile block —
the only place the reference computes statistics itself
(``benchmark-script/ssd_test/main.go:144-163``): sort ascending, then
index-based percentiles ``sorted[p*n/100]`` (p50 = ``sorted[n/2]``,
p99 = ``sorted[99n/100]``), reported as
``Average/P20/P50/P90/p99/Min/Max`` in milliseconds. BASELINE.md adopts this
exact shape for the new framework's latency reporting, so we keep the index
convention bit-for-bit (NOT numpy's interpolated percentile).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class LatencySummary:
    """All values in milliseconds; count is the sample count."""

    count: int
    avg_ms: float
    p20_ms: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    min_ms: float
    max_ms: float

    def to_dict(self) -> dict:
        return asdict(self)


def _index_percentile(sorted_ms: np.ndarray, p: int) -> float:
    # ssd_test/main.go:157-163 convention: sorted[p*n/100], clamped to n-1 so
    # p=100-ish indices on tiny samples stay in range. The array must be
    # sorted — or np.partition'ed at this index, which places the same
    # order statistic there.
    n = len(sorted_ms)
    idx = min((p * n) // 100, n - 1)
    return float(sorted_ms[idx])


# The ssd_test percentile points summarize() extracts.
_PCT_POINTS = (20, 50, 90, 99)


def summarize(latencies_ms: Sequence[float] | np.ndarray) -> LatencySummary:
    arr = np.asarray(latencies_ms, dtype=np.float64)
    if arr.size == 0:
        raise ValueError("summarize() needs at least one sample")
    n = arr.size
    # Index-based selection via ONE np.partition over all four order
    # statistics — O(n) where the previous full np.sort paid O(n log n)
    # on every multi-million-sample journal summary. A partitioned array
    # holds the exact order statistic at every partition index, so
    # _index_percentile (the ONE home of the ssd_test index convention)
    # reads the same sorted[p*n//100] value bit-for-bit — regression-
    # pinned against a sorted reference in test_metrics.py.
    idxs = sorted({min((p * n) // 100, n - 1) for p in _PCT_POINTS})
    part = np.partition(arr, idxs)
    pcts = {p: _index_percentile(part, p) for p in _PCT_POINTS}
    return LatencySummary(
        count=int(n),
        avg_ms=float(arr.mean()),
        p20_ms=pcts[20],
        p50_ms=pcts[50],
        p90_ms=pcts[90],
        p99_ms=pcts[99],
        min_ms=float(arr.min()),
        max_ms=float(arr.max()),
    )


def summarize_ns(latencies_ns: Sequence[int] | np.ndarray) -> LatencySummary:
    return summarize(np.asarray(latencies_ns, dtype=np.float64) / 1e6)


# The ssd_test percentile block's field order (``ssd_test/main.go:157-163``)
# — ONE definition for every renderer of a summary.
PCT_FIELDS = (
    ("Avg", "avg_ms"),
    ("P20", "p20_ms"),
    ("P50", "p50_ms"),
    ("P90", "p90_ms"),
    ("p99", "p99_ms"),
    ("Min", "min_ms"),
    ("Max", "max_ms"),
)


def format_summary(label: str, s: LatencySummary) -> str:
    """Human block in the ssd_test stdout shape (``ssd_test/main.go:157-163``)."""
    lines = [f"[{label}] n={s.count}"]
    for head, key in PCT_FIELDS:
        name = "Average" if head == "Avg" else head  # reference stdout label
        lines.append(f"{name}: {getattr(s, key):.3f} ms")
    return "\n".join(lines)
