"""Live telemetry plane: the in-run, pull-based metrics registry (a copy
of ``tpubench/obs/telemetry.py``; the live aggregator and ``top`` that
tail its journal stream are :mod:`tpubench_torch.obs.live`).

Half the reference's value is *cloud observability export* — an
OpenCensus view pushed to Cloud Monitoring every 30 s during the run
(``metrics_exporter.go:36-58``). tpubench's richer signal (flight
records, ``tb_stats_*`` native counters, pipeline/staging/tune stats)
was until now only inspectable *after* a run, via journal merge in
``tpubench report timeline``. This module makes the same signal
scrapeable while the run is in flight:

* :class:`TelemetryRegistry` — counters, gauges and fixed-bucket
  histograms (the reference view's ``LatencyDistribution`` bucket
  bounds, so dashboards line up bucket-for-bucket with the Cloud
  Monitoring series), every metric registered WITH help text (the
  metric-drift guard in tests pins registry ↔ README table ↔ PHASES);
* a **flight-channel feeder**: the registry taps every appended flight
  record (``FlightRecorder.set_tap``) on the worker's own thread —
  per-phase segment histograms, byte/error/hedge/breaker/tune/cache
  counters, and the goodput tally all update record-by-record, before
  ring overwrite can drop anything;
* :class:`TelemetrySession` — the per-run wiring: a tiny stdlib-only
  HTTP endpoint (Prometheus text exposition at ``/metrics``, JSON at
  ``/snapshot``; ``--telemetry-port``, 0 = ephemeral), periodic
  OTLP-shaped JSON export through the exporters machinery, incremental
  sampling of the run's own ``LatencyRecorder`` tails and the native
  ``tb_stats_*`` counters, and the in-run journal stream the live
  aggregator behind ``tpubench top`` tails.

Agreement discipline: the registry computes goodput with the SAME
formula as :func:`tpubench_torch.obs.flight.goodput_summary` and keeps exact
nanosecond samples per phase next to the bucketed histograms, so the
``/snapshot`` percentiles and the post-hoc ``report timeline`` numbers
agree on the same records (the acceptance test pins <1 %).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from bisect import bisect_right
from typing import Callable, Optional, Sequence

import numpy as np

from tpubench_torch.config import TelemetryConfig
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.obs.exporters import (
    DEFAULT_LATENCY_BUCKETS_MS,
    OTLPMetricsExporter,
    PeriodicExporter,
)
from tpubench_torch.obs.flight import PHASES, phase_segments, record_span_ns

# --------------------------------------------------------------- metrics ----

# Per-histogram bound on retained exact nanosecond samples; reaching it
# halves the list and doubles the keep stride (deterministic systematic
# subsample — no RNG, so resumable/replayable runs stay bit-identical).
EXACT_SAMPLE_CAP = 65536


class Counter:
    """Monotone counter. Mutations happen under the registry lock (the
    feeder/ticker serialize); reads are snapshot/render-side."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set_cumulative(self, v: float) -> None:
        """Adopt an externally-cumulative value (native ``tb_stats_*``
        deltas); clamped monotone so a stale sample can never make a
        Prometheus counter go backwards."""
        if v > self.value:
            self.value = v


class LabeledCounter:
    """One-label counter family (the native-transport counters: one
    child per ``tb_stats_*`` key, a bounded, known-at-runtime set)."""

    __slots__ = ("name", "help", "label", "children")

    def __init__(self, name: str, help_: str, label: str):
        self.name = name
        self.help = help_
        self.label = label
        self.children: dict[str, float] = {}

    def inc(self, label_value: str, n: float = 1.0) -> None:
        self.children[label_value] = self.children.get(label_value, 0.0) + n

    def set_cumulative(self, label_value: str, v: float) -> None:
        if v > self.children.get(label_value, 0.0):
            self.children[label_value] = v


class Gauge:
    __slots__ = ("name", "help", "value", "known")

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self.value = 0.0
        self.known = False  # unset gauges are omitted, not rendered as 0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.known = True


class Histogram:
    """Fixed-bucket latency histogram on the reference view's bounds
    (``DEFAULT_LATENCY_BUCKETS_MS``) PLUS the exact nanosecond samples:
    buckets feed Prometheus/OTLP, the exact samples feed ``/snapshot``
    percentiles that match ``report timeline`` bit-for-bit.

    The exact list is bounded (``EXACT_SAMPLE_CAP``): past the cap it
    decimates deterministically — keep every other retained sample,
    double the keep stride — so a serve-shaped run can tick for days
    without the registry's RSS growing, while runs under the cap (every
    hermetic test) keep the full-fidelity bit-for-bit identity.

    Each bucket additionally keeps its LAST observed exemplar — the
    (value, trace_id) pair of the newest observation that landed there,
    when the observer supplied a trace id. Rendered only in the
    OpenMetrics exposition (``Accept: application/openmetrics-text``):
    the slow buckets' exemplars are exactly the trace ids ``tpubench
    report trace`` resolves — the scrape-side handle from "the p99
    bucket grew" to "THIS read's span tree"."""

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum_ms",
                 "_ns", "_stride", "_phase", "exemplars")

    def __init__(self, name: str, help_: str,
                 bounds_ms: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_
        self.bounds = list(bounds_ms or DEFAULT_LATENCY_BUCKETS_MS)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum_ms = 0.0
        self._ns: list[int] = []
        self._stride = 1
        self._phase = 0
        # bucket index -> (value_ms, trace_id); last-write-wins.
        self.exemplars: dict[int, tuple[float, str]] = {}

    def observe_ns(self, ns: int, trace_id: Optional[str] = None) -> None:
        ms = ns / 1e6
        idx = bisect_right(self.bounds, ms)
        self.counts[idx] += 1
        if trace_id:
            self.exemplars[idx] = (ms, trace_id)
        self.count += 1
        self.sum_ms += ms
        self._phase += 1
        if self._phase >= self._stride:
            self._phase = 0
            self._ns.append(int(ns))
            if len(self._ns) >= EXACT_SAMPLE_CAP:
                del self._ns[::2]
                self._stride *= 2

    def exact_summary(self) -> Optional[dict]:
        if not self._ns:
            return None
        s = summarize_ns(np.asarray(self._ns, dtype=np.int64))
        out = {"count": self.count, "p50_ms": s.p50_ms, "p99_ms": s.p99_ms}
        if self._stride > 1:
            # Percentiles come from a 1-in-stride systematic subsample.
            out["sample_stride"] = self._stride
        return out

    def to_dict(self) -> dict:
        return {
            "bounds_ms": self.bounds,
            "counts": list(self.counts),
            "count": self.count,
            "sum_ms": self.sum_ms,
        }


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class TelemetryRegistry:
    """Name → metric map with mandatory help text, Prometheus text
    exposition and a JSON snapshot. One lock guards every mutation and
    render — the feeder runs on worker threads, the ticker and HTTP
    handlers on their own."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: dict[str, object] = {}

    def _register(self, metric):
        if not metric.help:
            raise ValueError(
                f"metric {metric.name!r}: help text is mandatory "
                "(the drift guard pins registry <-> README)"
            )
        if metric.name in self._metrics:
            raise ValueError(f"metric {metric.name!r} already registered")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help_: str) -> Counter:
        return self._register(Counter(name, help_))

    def labeled_counter(self, name: str, help_: str,
                        label: str) -> LabeledCounter:
        return self._register(LabeledCounter(name, help_, label))

    def gauge(self, name: str, help_: str) -> Gauge:
        return self._register(Gauge(name, help_))

    def histogram(self, name: str, help_: str,
                  bounds_ms: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram(name, help_, bounds_ms))

    def get(self, name: str):
        return self._metrics[name]

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def helps(self) -> dict[str, str]:
        return {n: m.help for n, m in self._metrics.items()}

    # ---------------------------------------------------------- render ----
    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition (format 0.0.4 by default): HELP/
        TYPE pairs, cumulative histogram buckets with the ``+Inf``
        terminator. ``openmetrics=True`` renders the OpenMetrics shape
        instead — bucket lines carry their trace-id exemplars
        (``# {trace_id="..."} <value>``) and the body ends with
        ``# EOF`` — the exposition that links a slow histogram bucket
        to the exact trace ``report trace`` can resolve."""
        with self.lock:
            lines: list[str] = []
            for name in sorted(self._metrics):
                m = self._metrics[name]
                help_ = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                # OpenMetrics 1.0 names a counter FAMILY without the
                # `_total` suffix (samples keep it); declaring the
                # family as `*_total counter` fails a stock Prometheus
                # OpenMetrics parse and takes the whole scrape down.
                # 0.0.4 keeps the historical suffixed declaration.
                family = name
                if (openmetrics
                        and isinstance(m, (Counter, LabeledCounter))
                        and name.endswith("_total")):
                    family = name[: -len("_total")]
                lines.append(f"# HELP {family} {help_}")
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {family} counter")
                    lines.append(f"{name} {_fmt(m.value)}")
                elif isinstance(m, LabeledCounter):
                    lines.append(f"# TYPE {family} counter")
                    for lv in sorted(m.children):
                        lines.append(
                            f'{name}{{{m.label}="{lv}"}} '
                            f"{_fmt(m.children[lv])}"
                        )
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {name} gauge")
                    if m.known:
                        lines.append(f"{name} {_fmt(m.value)}")
                elif isinstance(m, Histogram):
                    lines.append(f"# TYPE {name} histogram")

                    def _exemplar(idx: int, hist=m) -> str:
                        if not openmetrics or idx not in hist.exemplars:
                            return ""
                        ms, tid = hist.exemplars[idx]
                        return f' # {{trace_id="{tid}"}} {repr(float(ms))}'

                    cum = 0
                    for i, (bound, c) in enumerate(zip(m.bounds, m.counts)):
                        cum += c
                        lines.append(
                            f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}'
                            + _exemplar(i)
                        )
                    lines.append(
                        f'{name}_bucket{{le="+Inf"}} {m.count}'
                        + _exemplar(len(m.bounds))
                    )
                    lines.append(f"{name}_sum {repr(float(m.sum_ms))}")
                    lines.append(f"{name}_count {m.count}")
            if openmetrics:
                lines.append("# EOF")
            return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able registry state: flat counters/gauges, bucketed
        histograms, plus exact per-histogram p50/p99 (``phases``)."""
        with self.lock:
            counters: dict = {}
            gauges: dict = {}
            hists: dict = {}
            phases: dict = {}
            for name, m in self._metrics.items():
                if isinstance(m, Counter):
                    counters[name] = m.value
                elif isinstance(m, LabeledCounter):
                    counters[name] = {
                        "label": m.label, "children": dict(m.children),
                    }
                elif isinstance(m, Gauge):
                    if m.known:
                        gauges[name] = m.value
                elif isinstance(m, Histogram):
                    hists[name] = m.to_dict()
                    ex = m.exact_summary()
                    if ex is not None:
                        phases[name] = ex
            return {
                "time": time.time(),
                "counters": counters,
                "gauges": gauges,
                "histograms": hists,
                "exact": phases,
            }


# The registry's metric surface: tpubench's, name for name (held equal by
# tests/test_torch_obs.py), so one scraper reads both packages.
PHASE_HIST_PREFIX = "tpubench_phase_"

COUNTER_METRICS = {
    "tpubench_records_total": "flight records appended (all kinds)",
    "tpubench_reads_total": "completed read-kind flight records",
    "tpubench_read_errors_total": "read-kind records that ended in error",
    "tpubench_bytes_total":
        "payload bytes delivered by read-kind records (fetch-owner credit)",
    "tpubench_steps_total": "train-ingest step records",
    "tpubench_step_bytes_total": "bytes consumed by train-ingest steps",
    "tpubench_steps_with_data_wait_total":
        "steps that waited on data at all (stall phases present)",
    "tpubench_retries_total": "retry annotations on reads",
    "tpubench_hedges_total": "hedged-read launches",
    "tpubench_hedge_wins_total": "hedge races the hedge won",
    "tpubench_stalls_total": "stall-watchdog events",
    "tpubench_breaker_events_total": "circuit-breaker transitions",
    "tpubench_tune_decisions_total": "autotuner decision windows",
    "tpubench_tune_accepts_total": "autotuner probes accepted",
    "tpubench_tune_reverts_total": "autotuner probes reverted",
    "tpubench_cache_hits_total": "chunk-cache hit records",
    "tpubench_cache_misses_total": "chunk-cache miss records",
    "tpubench_prefetch_issues_total": "readahead prefetch issues",
    "tpubench_peer_requests_total":
        "cooperative-cache misses routed to a peer owner",
    "tpubench_peer_hits_total":
        "peer requests served by the owner (origin fetches avoided)",
    "tpubench_peer_misses_total":
        "peer requests the owner shed (fell back to origin)",
    "tpubench_peer_bytes_total": "chunk bytes received over the peer channel",
    "tpubench_owner_fetches_total":
        "origin fetches made as the chunk's ring owner",
    "tpubench_coop_demotions_total":
        "straggler owners demoted off the ownership ring",
    "tpubench_coop_restores_total":
        "demoted owners restored to the ownership ring",
    "tpubench_membership_events_total":
        "elastic-membership transitions (join/leave/fail/pause/resume)",
    "tpubench_membership_handoff_chunks_total":
        "chunks drained to new owners by cooperative warm handoff",
    "tpubench_membership_handoff_bytes_total":
        "bytes drained to new owners by cooperative warm handoff",
    "tpubench_slab_overflows_total": "slab-pool overflow leases",
    "tpubench_stage_transfers_total": "host-to-HBM staging transfers",
    "tpubench_stage_bytes_total": "bytes staged to HBM",
    "tpubench_stage_overlapped_total":
        "staging transfers completed by the overlapped window",
    "tpubench_serve_requests_total":
        "open-loop serve requests resolved (completed or shed)",
    "tpubench_serve_shed_total":
        "serve requests shed by admission control "
        "(queue overload / deadline / drain)",
    "tpubench_serve_deadline_miss_total":
        "completed serve requests that missed their tenant deadline",
    "tpubench_upload_sessions_total":
        "resumable upload sessions completed (one per ckpt-save object)",
    "tpubench_upload_parts_total":
        "upload parts committed (content-range PUTs)",
    "tpubench_upload_resumed_parts_total":
        "upload parts resumed after a mid-part fault "
        "(committed offset re-probed, tail resent)",
    "tpubench_upload_bytes_total":
        "bytes finalized through resumable uploads",
    "tpubench_grpc_frames_total":
        "gRPC wire events on client calls "
        "(stream open / message sent / message received)",
    "tpubench_bidi_acks_total":
        "BidiWriteObject persisted-size acks received "
        "(one per lockstep flush)",
    "tpubench_meta_ops_total":
        "open-loop metadata ops completed (meta-storm list/stat/open)",
    "tpubench_meta_errors_total": "metadata ops that failed",
    "tpubench_journal_flushes_total": "in-run flight-journal stream flushes",
    "tpubench_journal_rotated_records_total":
        "oldest journal records dropped by size-bounded rotation",
    "tpubench_tap_errors_total":
        "flight-tap feed errors (swallowed, never on the hot path)",
    "tpubench_scrapes_total": "/metrics scrapes served",
}

LABELED_COUNTER_METRICS = {
    "tpubench_native_transport_total": (
        "native tb_stats_* transport counters, delta since session start",
        "counter",
    ),
}

# The native tb_stats_* counter catalog — the `counter=` label values of
# tpubench_native_transport_total, as the engine's stats() keys them.
NATIVE_TRANSPORT_COUNTERS = {
    "bytes_tx": "payload bytes handed to send/SSL_write",
    "bytes_rx": "payload bytes returned by recv/SSL_read",
    "recv_wait_ns": "wall time blocked inside recv/SSL_read",
    "connects": "TCP connects (tb_http_connect + reactor sockets)",
    "tls_handshakes": "completed TLS handshakes",
    "conn_closes": "connection handles closed",
    "h2_frames_rx": "h2 frames consumed by the poll loop",
    "h2_data_bytes_rx": "h2 DATA frame payload bytes (incl. padding)",
    "h2_window_updates_tx": "h2 flow-control credit frames sent",
    "h2_streams_opened": "h2 streams submitted (gRPC + raw GET)",
    "h2_rst_rx": "RST_STREAM frames received",
    "h2_goaway_rx": "GOAWAY frames received",
    "pool_wakes": "executor consumer wakes returning >=1 completion",
    "pool_completions": "executor completions across all wakes",
    "pool_batched_wakes": "wakes that drained >1 completion in one handoff",
    "reactor_loops": "reactor epoll_wait iterations",
    "reactor_epoll_events": "epoll events delivered to the reactor",
    "reactor_completions": "completions enqueued to reactor SPSC rings",
    "reactor_doorbell_wakes":
        "eventfd doorbells rung (coalesced: batch threshold or loop edge)",
    "reactor_ring_depth_sum":
        "ring depth observed at each enqueue, summed (mean = sum/completions)",
    "reactor_ring_depth_max": "max reactor ring depth observed",
    "reactor_tls_handshakes":
        "TLS handshakes completed by the reactor's nonblocking state machine",
    "reactor_tls_resumes":
        "reactor handshakes that resumed a cached per-target TLS session",
    "reactor_h2_streams": "h2 streams opened by the reactor's multiplexer",
    "reactor_flow_stall_ns":
        "time queued h2 flow-control credit waited for the socket to drain",
}

GAUGE_METRICS = {
    "tpubench_up": "1 while the telemetry session is live",
    "tpubench_run_seconds": "wall seconds since the session started",
    "tpubench_goodput_gbps":
        "delivered GB/s over the flight records' observed span "
        "(goodput_summary formula)",
    "tpubench_goodput_gbps_per_chip": "goodput divided by staged chip count",
    "tpubench_cache_hit_ratio": "cache hits / (hits + misses), record-derived",
    "tpubench_peer_hit_ratio":
        "peer hits / peer requests, record-derived (coop cache)",
    "tpubench_staging_efficiency":
        "fraction of transfer flight time hidden from the fetch threads",
    "tpubench_membership_epoch":
        "current elastic-membership view epoch (bumps on every "
        "join/leave/fail/pause/resume)",
    "tpubench_fleet_hosts":
        "simulated host count of the last virtual-time fleet run",
    "tpubench_fleet_virtual_seconds":
        "virtual seconds the last fleet simulation covered (its "
        "real wall cost is the run's wall_seconds)",
}

HISTOGRAM_METRICS = {
    "tpubench_read_latency_ms":
        "full-read latency sampled off the run's LatencyRecorders",
}


def phase_metric_name(phase: str) -> str:
    return f"{PHASE_HIST_PREFIX}{phase}_ms"


def metric_catalog() -> dict[str, str]:
    """Every registry metric name -> help, including the per-phase
    histograms — the single source the README table and the drift guard
    both walk."""
    cat = dict(COUNTER_METRICS)
    for name, (help_, _) in LABELED_COUNTER_METRICS.items():
        cat[name] = help_
    cat.update(GAUGE_METRICS)
    cat.update(HISTOGRAM_METRICS)
    for p in PHASES + ("total",):
        cat[phase_metric_name(p)] = (
            f"'{p}' phase segment latency (ms), attributed per flight "
            "record" if p != "total"
            else "whole-record latency (first to last phase stamp, ms)"
        )
    return cat


def build_registry() -> TelemetryRegistry:
    """The default tpubench registry: every catalog metric registered
    with its help text (drift guard: registry names == catalog names ==
    README table rows)."""
    reg = TelemetryRegistry()
    for name, help_ in COUNTER_METRICS.items():
        reg.counter(name, help_)
    for name, (help_, label) in LABELED_COUNTER_METRICS.items():
        reg.labeled_counter(name, help_, label)
    for name, help_ in GAUGE_METRICS.items():
        reg.gauge(name, help_)
    for name, help_ in HISTOGRAM_METRICS.items():
        reg.histogram(name, help_)
    for p in PHASES + ("total",):
        reg.histogram(phase_metric_name(p), metric_catalog()[
            phase_metric_name(p)
        ])
    return reg


# ---------------------------------------------------------------- feeder ----


class FlightFeeder:
    """Per-record registry feed, installed as the FlightRecorder's tap.

    Runs on the appending worker's thread under the registry lock;
    errors are counted and swallowed (the hot path must never pay for a
    telemetry bug). Keeps the goodput tally with the exact
    :func:`goodput_summary` byte-credit rules so live and post-hoc
    numbers agree."""

    def __init__(self, registry: TelemetryRegistry):
        self.reg = registry
        # Single-host span/byte tally (the registry lives in-process).
        self.t0_ns: Optional[int] = None
        self.t1_ns: Optional[int] = None
        self.read_bytes = 0
        self.step_bytes = 0
        self.steps = 0

    # One bound-method handle per hot counter (dict lookups once).
    def __call__(self, rec: dict) -> None:
        try:
            with self.reg.lock:
                self._feed(rec)
        except Exception:  # noqa: BLE001 — tap contract: never raise
            try:
                with self.reg.lock:
                    self.reg.get("tpubench_tap_errors_total").inc()
            except Exception:  # noqa: BLE001
                pass

    def _feed(self, rec: dict) -> None:
        reg = self.reg
        reg.get("tpubench_records_total").inc()
        phases = rec.get("phases", {})
        # Trace-id exemplar per observation: the record's trace id rides
        # into the bucket it lands in, so an OpenMetrics scrape can walk
        # from a fat p99 bucket straight to the trace tree.
        tid = rec.get("trace_id")
        for name, dur in phase_segments(rec).items():
            reg.get(phase_metric_name(name)).observe_ns(dur, trace_id=tid)
        t0, t1 = record_span_ns(rec)
        if t0 is not None:
            self.t0_ns = t0 if self.t0_ns is None else min(self.t0_ns, t0)
            self.t1_ns = t1 if self.t1_ns is None else max(self.t1_ns, t1)
        kind = rec.get("kind", "read")
        nbytes = rec.get("bytes", 0)
        if kind == "read":
            reg.get("tpubench_reads_total").inc()
            if rec.get("error"):
                reg.get("tpubench_read_errors_total").inc()
            else:
                reg.get("tpubench_bytes_total").inc(nbytes)
                self.read_bytes += nbytes
        elif kind == "step":
            reg.get("tpubench_steps_total").inc()
            reg.get("tpubench_step_bytes_total").inc(nbytes)
            self.steps += 1
            self.step_bytes += nbytes
            if "stall_end" in phases:
                reg.get("tpubench_steps_with_data_wait_total").inc()
        elif kind == "stage":
            reg.get("tpubench_stage_transfers_total").inc()
            reg.get("tpubench_stage_bytes_total").inc(nbytes)
        elif kind == "upload":
            if not rec.get("error"):
                # "Sessions COMPLETED" by its help text: an errored
                # upload record (e.g. a 412 after session open) must
                # not count.
                reg.get("tpubench_upload_sessions_total").inc()
                reg.get("tpubench_upload_bytes_total").inc(nbytes)
        elif kind == "meta":
            reg.get("tpubench_meta_ops_total").inc()
            if rec.get("error"):
                reg.get("tpubench_meta_errors_total").inc()
        if "cache_hit" in phases:
            reg.get("tpubench_cache_hits_total").inc()
        if "cache_miss" in phases:
            reg.get("tpubench_cache_misses_total").inc()
        if "prefetch_issue" in phases:
            reg.get("tpubench_prefetch_issues_total").inc()
        if "peer_request" in phases:
            reg.get("tpubench_peer_requests_total").inc()
        if "peer_hit" in phases:
            reg.get("tpubench_peer_hits_total").inc()
            if not rec.get("error"):
                reg.get("tpubench_peer_bytes_total").inc(nbytes)
        if "peer_miss" in phases:
            reg.get("tpubench_peer_misses_total").inc()
        if "owner_fetch" in phases:
            reg.get("tpubench_owner_fetches_total").inc()
        for n in rec.get("notes", ()):
            nk = n.get("kind")
            if nk == "retry":
                reg.get("tpubench_retries_total").inc()
                if n.get("reason") == "upload_resume":
                    reg.get("tpubench_upload_resumed_parts_total").inc()
            elif nk == "part":
                reg.get("tpubench_upload_parts_total").inc()
            elif nk == "grpc_frame":
                reg.get("tpubench_grpc_frames_total").inc()
            elif nk == "bidi_ack":
                reg.get("tpubench_bidi_acks_total").inc()
            elif nk == "hedge":
                if n.get("event") == "launch":
                    reg.get("tpubench_hedges_total").inc()
                elif n.get("event") == "win":
                    reg.get("tpubench_hedge_wins_total").inc()
            elif nk == "serve_req":
                reg.get("tpubench_serve_requests_total").inc()
                if (n.get("outcome") == "completed"
                        and n.get("deadline_met") is False):
                    reg.get("tpubench_serve_deadline_miss_total").inc()
            elif nk == "shed":
                reg.get("tpubench_serve_shed_total").inc()
            elif nk == "stall":
                reg.get("tpubench_stalls_total").inc()
            elif nk == "breaker":
                reg.get("tpubench_breaker_events_total").inc()
            elif nk == "tune":
                reg.get("tpubench_tune_decisions_total").inc()
                verdict = str(n.get("verdict", ""))
                if verdict == "accept":
                    reg.get("tpubench_tune_accepts_total").inc()
                elif verdict.startswith("revert"):
                    reg.get("tpubench_tune_reverts_total").inc()
            elif nk == "slab" and n.get("event") == "overflow":
                reg.get("tpubench_slab_overflows_total").inc()
            elif nk == "coop":
                if n.get("event") == "demote":
                    reg.get("tpubench_coop_demotions_total").inc()
                elif n.get("event") == "restore":
                    reg.get("tpubench_coop_restores_total").inc()
            elif nk == "member":
                action = n.get("action")
                if action == "handoff":
                    reg.get(
                        "tpubench_membership_handoff_chunks_total"
                    ).inc(n.get("handoff_chunks", 0))
                    reg.get(
                        "tpubench_membership_handoff_bytes_total"
                    ).inc(n.get("handoff_bytes", 0))
                else:
                    reg.get("tpubench_membership_events_total").inc()
                epoch = n.get("epoch")
                if epoch is not None:
                    reg.get("tpubench_membership_epoch").set(epoch)
            elif nk == "fleet":
                hosts = n.get("hosts")
                if hosts is not None:
                    reg.get("tpubench_fleet_hosts").set(hosts)
                virtual_s = n.get("virtual_s")
                if virtual_s is not None:
                    reg.get("tpubench_fleet_virtual_seconds").set(virtual_s)
            elif nk == "stage" and n.get("event") == "overlap":
                reg.get("tpubench_stage_overlapped_total").inc()

    def goodput(self) -> dict:
        """The live twin of ``goodput_summary`` over this host's tapped
        records: same byte credit (steps win over reads), same span."""
        nbytes = self.step_bytes if self.steps else self.read_bytes
        wall_s = (
            (self.t1_ns - self.t0_ns) / 1e9
            if self.t0_ns is not None and self.t1_ns > self.t0_ns else 0.0
        )
        gbps = (nbytes / 1e9) / wall_s if wall_s > 0 else 0.0
        return {"bytes": nbytes, "wall_s": wall_s, "gbps": gbps}


# ----------------------------------------------------------------- http -----


def _make_server(session: "TelemetrySession", port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — stdlib API
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path == "/metrics":
                # Content negotiation: an OpenMetrics scraper (Accept:
                # application/openmetrics-text) gets bucket exemplars
                # linking slow buckets to trace ids; plain scrapers get
                # unchanged 0.0.4 text.
                om = "application/openmetrics-text" in (
                    self.headers.get("Accept") or ""
                )
                body = session.render_prometheus(
                    openmetrics=om
                ).encode("utf-8")
                ctype = (
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8" if om
                    else "text/plain; version=0.0.4; charset=utf-8"
                )
            elif path == "/snapshot":
                body = json.dumps(session.snapshot()).encode("utf-8")
                ctype = "application/json"
            elif path == "/":
                body = (
                    b"tpubench telemetry: /metrics (Prometheus), "
                    b"/snapshot (JSON)\n"
                )
                ctype = "text/plain; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # noqa: A003 — silence stdlib
            pass

    # Loopback only: the endpoint is a local scrape/debug surface, not a
    # service — never bound on external interfaces.
    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


# --------------------------------------------------------------- session ----


class TelemetrySession:
    """One run's telemetry wiring: registry + feeder + tick thread +
    optional HTTP endpoint + optional OTLP export + optional in-run
    journal stream. Workloads attach their sources, ``start()``, and
    stamp ``close()``'s summary into ``extra["telemetry"]``."""

    def __init__(self, tcfg: TelemetryConfig, resource: Optional[dict] = None):
        self.cfg = tcfg
        self.resource = dict(resource or {})
        self.registry = build_registry()
        self.feeder = FlightFeeder(self.registry)
        self.scrapes = 0
        self.port: Optional[int] = None
        self._flight = None
        self._recorders: list = []
        self._rec_offsets: list[int] = []
        self._chips = 1
        self._journal: Optional[tuple] = None  # (flight, path, extra_fn, max)
        self._rotation_seen = 0
        self._server = None
        self._server_thread = None
        self._ticker: Optional[PeriodicExporter] = None
        self._otlp: Optional[OTLPMetricsExporter] = None
        self._otlp_periodic: Optional[PeriodicExporter] = None
        self._t0 = time.monotonic()
        self._native_base: Optional[dict] = None
        self._closed = False
        self._last_summary: dict = {}

    # ---------------------------------------------------------- attach ----
    def attach_flight(self, flight) -> None:
        """Tap the run's FlightRecorder: every appended record feeds the
        registry before ring overwrite can drop it."""
        self._flight = flight
        flight.set_tap(self.feeder)

    def attach_recorders(self, recorders: Sequence) -> None:
        """Latency recorders sampled incrementally each tick into
        ``tpubench_read_latency_ms`` (the RecorderSampler discipline:
        ``snapshot_tail_ns``, O(new) per tick)."""
        for rec in recorders:
            self._recorders.append(rec)
            self._rec_offsets.append(0)

    def set_chips(self, n: int) -> None:
        self._chips = max(1, int(n))

    def stream_journal(self, flight, path: str,
                       extra_fn: Optional[Callable[[], dict]] = None,
                       max_bytes: int = 0) -> None:
        """Flush the flight journal every tick so ``tpubench top`` (and
        any cross-host aggregator) can tail it mid-run; writes stay
        atomic, ``.gz`` and rotation ride the write_journal path."""
        self._journal = (flight, path, extra_fn, max_bytes)

    # ------------------------------------------------------------ tick ----
    def _sample_recorders(self) -> None:
        hist = self.registry.get("tpubench_read_latency_ms")
        for i, rec in enumerate(self._recorders):
            arr, self._rec_offsets[i] = rec.snapshot_tail_ns(
                self._rec_offsets[i]
            )
            for ns in arr.tolist():
                hist.observe_ns(ns)

    def _sample_native(self) -> None:
        try:
            from tpubench_torch.native.engine import peek_engine

            eng = peek_engine()
        except Exception:  # noqa: BLE001 — engine truly optional
            return
        if eng is None:
            return
        stats = eng.stats()
        if self._native_base is None:
            self._native_base = dict(stats)
            return
        fam = self.registry.get("tpubench_native_transport_total")
        for k, v in stats.items():
            fam.set_cumulative(k, v - self._native_base.get(k, 0))

    def _update_gauges(self) -> None:
        reg = self.registry
        reg.get("tpubench_up").set(1.0)
        reg.get("tpubench_run_seconds").set(time.monotonic() - self._t0)
        gp = self.feeder.goodput()
        reg.get("tpubench_goodput_gbps").set(gp["gbps"])
        reg.get("tpubench_goodput_gbps_per_chip").set(
            gp["gbps"] / self._chips
        )
        hits = reg.get("tpubench_cache_hits_total").value
        misses = reg.get("tpubench_cache_misses_total").value
        if hits + misses > 0:
            reg.get("tpubench_cache_hit_ratio").set(hits / (hits + misses))
        preq = reg.get("tpubench_peer_requests_total").value
        if preq > 0:
            reg.get("tpubench_peer_hit_ratio").set(
                reg.get("tpubench_peer_hits_total").value / preq
            )

    def tick(self) -> None:
        with self.registry.lock:
            self._sample_recorders()
            self._sample_native()
            self._update_gauges()
        if self._journal is not None:
            flight, path, extra_fn, max_bytes = self._journal
            flight.write_journal(
                path, extra=extra_fn() if extra_fn else None,
                max_bytes=max_bytes,
            )
            with self.registry.lock:
                self.registry.get("tpubench_journal_flushes_total").inc()
                # Cumulative-delta, not last_rotation_dropped: each flush
                # re-drops the same oldest records (the ring still holds
                # them), so summing per-write drops would inflate the
                # counter every tick. The recorder's watermarked total
                # counts each record once.
                total = getattr(flight, "rotation_dropped_total", 0)
                if total > self._rotation_seen:
                    self.registry.get(
                        "tpubench_journal_rotated_records_total"
                    ).inc(total - self._rotation_seen)
                    self._rotation_seen = total

    # ------------------------------------------------------- endpoints ----
    def render_prometheus(self, openmetrics: bool = False) -> str:
        with self.registry.lock:
            self.scrapes += 1
            self.registry.get("tpubench_scrapes_total").inc()
        return self.registry.render_prometheus(openmetrics=openmetrics)

    def snapshot(self) -> dict:
        snap = self.registry.snapshot()
        snap["goodput"] = self.feeder.goodput()
        snap["goodput"]["gbps_per_chip"] = (
            snap["goodput"]["gbps"] / self._chips
        )
        snap["resource"] = self.resource
        return snap

    # ------------------------------------------------------- lifecycle ----
    def start(self) -> "TelemetrySession":
        with self.registry.lock:
            self._update_gauges()
        if self.cfg.port >= 0:
            self._server = _make_server(self, self.cfg.port)
            self.port = self._server.server_address[1]
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="telemetry-http",
            )
            self._server_thread.start()
            print(
                f"telemetry: http://127.0.0.1:{self.port}/metrics "
                f"(+ /snapshot)",
                file=sys.stderr,
            )
        self._ticker = PeriodicExporter(self.tick, self.cfg.interval_s)
        self._ticker.start()
        if self.cfg.otlp or self.cfg.otlp_endpoint:
            self._otlp = OTLPMetricsExporter(
                self.snapshot, endpoint=self.cfg.otlp_endpoint,
                resource=self.resource,
            )
            self._otlp_periodic = PeriodicExporter(
                self._otlp.export_once, self.cfg.otlp_interval_s
            )
            self._otlp_periodic.start()
        return self

    def finalize_extra(self, extra: dict) -> None:
        """Fold a finished run's ``extra`` blocks into the gauges the
        records alone can't derive (staging efficiency, chip count)."""
        staging = (extra or {}).get("staging") or {}
        eff = staging.get("staging_efficiency")
        with self.registry.lock:
            if eff is not None:
                self.registry.get("tpubench_staging_efficiency").set(eff)

    def close(self, final_extra: Optional[dict] = None) -> dict:
        """Final tick + final OTLP flush, server shutdown, and the
        ``extra["telemetry"]`` stamp (port, scrape/flush counts, final
        goodput + exact per-phase percentiles)."""
        if self._closed:
            return self._last_summary
        self._closed = True
        if final_extra:
            self.finalize_extra(final_extra)
        if self._flight is not None:
            self._flight.set_tap(None)
        if self._ticker is not None:
            self._ticker.close()  # guaranteed final tick
        if self._otlp_periodic is not None:
            self._otlp_periodic.close()  # guaranteed final flush
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        snap = self.snapshot()
        summary = {
            "port": self.port,
            "scrapes": self.scrapes,
            "ticks": self._ticker.flush_count if self._ticker else 0,
            "goodput": snap["goodput"],
            "phases": snap["exact"],
            "counters": {
                k: v for k, v in snap["counters"].items()
                if not isinstance(v, dict) and v
            },
            "gauges": snap["gauges"],
        }
        if self._otlp is not None:
            summary["otlp"] = self._otlp.summary(self._otlp_periodic)
            # Dry-run payload capture rides the stamp only when small —
            # tests read it; result files must not balloon.
            if not self._otlp.endpoint and len(self._otlp.exported) <= 4:
                summary["otlp"]["payloads_captured"] = self._otlp.exported
            # Trace twin: one final OTLP-shaped span export over the
            # run's flight records (the trace store), riding the same
            # dry-run/POST machinery — a run that exported metrics also
            # ships its span trees, never silently only half the signal.
            if self._flight is not None:
                from tpubench_torch.obs.exporters import OTLPTraceExporter

                texp = OTLPTraceExporter(
                    self._flight.records, endpoint=self.cfg.otlp_endpoint,
                    resource=self.resource,
                )
                try:
                    texp.export_once()
                    summary["otlp"]["traces"] = texp.summary()
                except Exception as e:  # noqa: BLE001 — close() never raises
                    summary["otlp"]["traces"] = {
                        "error": f"{type(e).__name__}: {e}",
                    }
        self._last_summary = summary
        return summary


def telemetry_from_config(cfg) -> Optional[TelemetrySession]:
    """Session per ``cfg.telemetry`` (None when the plane is off). The
    resource labels carry the transport/process identity every export
    path stamps (the multi-host series-collision discipline from
    CloudMonitoringExporter)."""
    tc = getattr(cfg, "telemetry", None)
    if tc is None or not tc.active:
        return None
    from tpubench_torch.dist.launch import member
    from tpubench_torch.obs.flight import transport_label

    return TelemetrySession(tc, resource={
        "transport": transport_label(cfg),
        "process": str(member(cfg.dist).rank),
        "workload": "",
    })
