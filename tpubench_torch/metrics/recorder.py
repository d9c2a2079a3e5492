"""Race-free measurement primitives (``tpubench/metrics/recorder.py``,
the parts the read workload uses).

The reference appends per-read latencies from all goroutines into one shared
slice with no synchronization — an actual data race
(``ssd_test/main.go:80``, SURVEY §2.2 #15). Here each worker owns a private
:class:`LatencyRecorder`; arrays are merged only after the workers join, so
there is no shared mutable state in the hot loop by construction.
"""

from __future__ import annotations

import time
from array import array
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from tpubench_torch.metrics.percentiles import LatencySummary, summarize_ns


class LatencyRecorder:
    """One per worker. Appends int nanoseconds; no locking needed."""

    __slots__ = ("name", "_ns")

    def __init__(self, name: str = ""):
        self.name = name
        self._ns = array("q")

    def record_ns(self, ns: int) -> None:
        self._ns.append(ns)

    def __len__(self) -> int:
        return len(self._ns)

    def as_ns_array(self) -> np.ndarray:
        return np.frombuffer(self._ns, dtype=np.int64).copy() if self._ns else np.empty(0, np.int64)

    def snapshot_tail_ns(self, start: int) -> tuple[np.ndarray, int]:
        """Mid-run-safe copy of samples [start:len) plus the new consumed
        offset — the periodic exporters' incremental read. Slicing copies
        without exporting the buffer, so the owner's concurrent appends
        stay safe."""
        end = len(self._ns)
        if end <= start:
            return np.empty(0, np.int64), start
        return np.array(self._ns[start:end].tolist(), dtype=np.int64), end

    def summarize(self) -> LatencySummary:
        return summarize_ns(self.as_ns_array())


def merge_recorders(recorders: Iterable[LatencyRecorder]) -> np.ndarray:
    """Post-join merge of per-worker arrays (the fix for ssd_test's race)."""
    arrays = [r.as_ns_array() for r in recorders]
    arrays = [a for a in arrays if a.size]
    if not arrays:
        return np.empty(0, np.int64)
    return np.concatenate(arrays)


class ByteCounter:
    """Bytes-ingested counter + wall-clock window → GB/s accounting."""

    __slots__ = ("bytes", "_t0", "_t1")

    def __init__(self):
        self.bytes = 0
        self._t0 = None
        self._t1 = None

    def start(self) -> None:
        self._t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self._t1 = time.perf_counter_ns()

    @property
    def seconds(self) -> float:
        if self._t0 is None:
            return 0.0
        t1 = self._t1 if self._t1 is not None else time.perf_counter_ns()
        return (t1 - self._t0) / 1e9

    def gbps(self) -> float:
        """Gigabytes (1e9) per second over the started window."""
        sec = self.seconds
        return (self.bytes / 1e9) / sec if sec > 0 else 0.0


@dataclass
class MetricSet:
    """The framework's first-class measures (SURVEY §5.5 north star).

    Reference has a single measure ``readLatency`` ms
    (``metrics_exporter.go:17``); we add bytes-ingested, GB/s/chip, first-byte
    and stage (HBM-landing) latency histograms.
    """

    read_latency: list[LatencyRecorder] = field(default_factory=list)
    first_byte_latency: list[LatencyRecorder] = field(default_factory=list)
    stage_latency: list[LatencyRecorder] = field(default_factory=list)
    gather_latency: list[LatencyRecorder] = field(default_factory=list)
    ingest: ByteCounter = field(default_factory=ByteCounter)

    def new_worker(self, name: str) -> tuple[LatencyRecorder, LatencyRecorder]:
        """Returns (read, first_byte) recorders owned by one worker."""
        r = LatencyRecorder(f"{name}/read")
        fb = LatencyRecorder(f"{name}/first_byte")
        self.read_latency.append(r)
        self.first_byte_latency.append(fb)
        return r, fb

    def summaries(self) -> dict[str, LatencySummary]:
        out = {}
        for key, recs in (
            ("read", self.read_latency),
            ("first_byte", self.first_byte_latency),
            ("stage", self.stage_latency),
            ("gather", self.gather_latency),
        ):
            merged = merge_recorders(recs)
            if merged.size:
                out[key] = summarize_ns(merged)
        return out
