"""Metric export (reference ``metrics_exporter.go``; a copy of
``tpubench/obs/exporters.py``).

The reference registers one OpenCensus view (``princer_go_client_read_latency``
with the default latency histogram buckets) and ships it to Cloud Monitoring
under ``custom.googleapis.com/custom-go-client/`` every 30 s
(metrics_exporter.go:22-44). Known bug NOT reproduced: the shadowed exporter
var that silently skipped the final flush (``:37``, SURVEY §2.1 #7) — here
``close()`` always flushes.

Implementations:

* :class:`LatencyDistribution` — the OpenCensus default latency buckets, so
  dashboards keyed to the reference's view line up bucket-for-bucket.
* :class:`CloudMonitoringExporter` — periodic Cloud Monitoring time-series
  push (gated on ``google-cloud-monitoring``); ``dry_run`` collects the
  payloads locally so tests can assert on them without GCP.
* :class:`SnapshotWriter` — periodic local JSON snapshots per host, the
  checkpoint/resume story (SURVEY §5.4): runs are restartable and partial
  results survive a crash.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from tpubench_torch.dist.launch import member

# OpenCensus ochttp.DefaultLatencyDistribution bucket bounds (ms) — the
# aggregation the reference's view uses (metrics_exporter.go:28).
DEFAULT_LATENCY_BUCKETS_MS = [
    1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 20, 25, 30, 40, 50, 65, 80, 100, 130,
    160, 200, 250, 300, 400, 500, 650, 800, 1000, 2000, 5000, 10000, 20000,
    50000, 100000,
]


class LatencyDistribution:
    """Histogram with the reference view's bucket bounds."""

    def __init__(self, bounds_ms=None):
        self.bounds = list(bounds_ms or DEFAULT_LATENCY_BUCKETS_MS)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum_ms = 0.0

    def record_many_ms(self, values_ms) -> None:
        arr = np.asarray(values_ms, dtype=np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.bounds), arr, side="right")
        binned = np.bincount(idx, minlength=len(self.counts))
        for i in binned.nonzero()[0]:
            self.counts[i] += int(binned[i])
        self.count += int(arr.size)
        self.sum_ms += float(arr.sum())

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {
            "bounds_ms": self.bounds,
            "counts": self.counts,
            "count": self.count,
            "mean_ms": self.mean_ms,
        }


class CloudMonitoringExporter:
    """Pushes the read-latency distribution + GB/s gauge as custom metrics.

    Reporting interval mirrors the reference's 30 s (metrics_exporter.go:44);
    the metric prefix is config (default ``custom.googleapis.com/tpubench/``).
    """

    def __init__(
        self,
        project: str,
        metric_prefix: str,
        interval_s: float = 30.0,
        dry_run: bool = False,
        base_labels: Optional[dict] = None,
    ):
        self.project = project
        self.prefix = metric_prefix.rstrip("/")
        self.interval_s = interval_s
        self.dry_run = dry_run
        # Stamped on every series; multi-host runs MUST carry a per-process
        # label or N hosts write the same time series and Cloud Monitoring
        # rejects all but one per sampling period.
        self.base_labels = dict(base_labels or {})
        self.exported: list[dict] = []  # dry-run capture
        self._client = None
        if not dry_run:
            from google.cloud import monitoring_v3  # gated import

            self._client = monitoring_v3.MetricServiceClient()
            self._monitoring_v3 = monitoring_v3

    def _labels(self, labels: Optional[dict]) -> dict:
        return {**self.base_labels, **(labels or {})}

    def export_point(self, name: str, value: float, labels: Optional[dict] = None):
        payload = {
            "type": f"{self.prefix}/{name}",
            "value": value,
            "labels": self._labels(labels),
            "time": time.time(),
        }
        if self.dry_run or self._client is None:
            self.exported.append(payload)
            return
        mv3 = self._monitoring_v3
        series = mv3.TimeSeries()
        series.metric.type = payload["type"]
        for k, v in payload["labels"].items():
            series.metric.labels[k] = str(v)
        series.resource.type = "global"
        point = mv3.Point()
        point.value.double_value = float(value)
        now = time.time()
        point.interval = mv3.TimeInterval(
            {"end_time": {"seconds": int(now), "nanos": int((now % 1) * 1e9)}}
        )
        series.points = [point]
        self._client.create_time_series(
            name=f"projects/{self.project}", time_series=[series]
        )

    def export_distribution(self, name: str, dist: LatencyDistribution, labels=None):
        """Typed Distribution time-series: full histogram (explicit bucket
        bounds + per-bucket counts), never a lossy mean-only stand-in. The
        dry-run payload keeps the same histogram for assertion/offline
        upload."""
        payload = {
            "type": f"{self.prefix}/{name}",
            "distribution": dist.to_dict(),
            "labels": self._labels(labels),
            "time": time.time(),
        }
        if self.dry_run or self._client is None:
            self.exported.append(payload)
            return
        mv3 = self._monitoring_v3
        series = mv3.TimeSeries()
        series.metric.type = payload["type"]
        for k, v in payload["labels"].items():
            series.metric.labels[k] = str(v)
        series.resource.type = "global"
        dval = mv3.types.Distribution(
            count=dist.count,
            mean=dist.mean_ms,
            bucket_options=mv3.types.Distribution.BucketOptions(
                explicit_buckets=mv3.types.Distribution.BucketOptions.Explicit(
                    bounds=[float(b) for b in dist.bounds]
                )
            ),
            bucket_counts=[int(c) for c in dist.counts],
        )
        point = mv3.Point()
        point.value.distribution_value = dval
        now = time.time()
        point.interval = mv3.TimeInterval(
            {"end_time": {"seconds": int(now), "nanos": int((now % 1) * 1e9)}}
        )
        series.points = [point]
        self._client.create_time_series(
            name=f"projects/{self.project}", time_series=[series]
        )

    def summary(self, periodic: Optional["PeriodicExporter"] = None) -> dict:
        """The run-report stamp shared by every workload's extras."""
        out = {
            "flushes": periodic.flush_count if periodic else 1,
            "points": len(self.exported),
            "dry_run": self.dry_run,
            "prefix": self.prefix,
        }
        if periodic and periodic.error_count:
            out["flush_errors"] = periodic.error_count
            out["last_error"] = periodic.last_error
        return out

    def close(self) -> None:  # always flush (unlike the reference's bug)
        pass


class PeriodicExporter:
    """Background thread: calls ``fn()`` every ``interval_s`` and once at
    close — the 30 s reporting loop + guaranteed final flush.

    A flush error (live Cloud Monitoring push hitting a network blip) must
    never kill the flush thread silently NOR crash the workload's finally
    block at the very end of a long run: errors are counted and the last
    one is kept for the run report. A lock serializes flushes so close()'s
    final flush cannot run concurrently with a slow in-flight one."""

    def __init__(self, fn: Callable[[], None], interval_s: float = 30.0):
        self._fn = fn
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="periodic-exporter", daemon=True
        )
        self._flush_lock = threading.Lock()
        self.flush_count = 0
        self.error_count = 0
        self.last_error: Optional[str] = None

    def start(self) -> "PeriodicExporter":
        self._thread.start()
        return self

    def _flush_once(self) -> None:
        with self._flush_lock:
            try:
                self._fn()
                self.flush_count += 1
            except Exception as e:  # noqa: BLE001 — see class docstring
                self.error_count += 1
                self.last_error = f"{type(e).__name__}: {e}"

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._flush_once()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        self._flush_once()  # final flush ALWAYS runs (metrics_exporter.go:37 bug fix)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


class SnapshotWriter:
    """Periodic per-host JSON snapshots of in-flight metrics (SURVEY §5.4)."""

    def __init__(
        self,
        snapshot_fn: Callable[[], dict],
        path: str,
        interval_s: float = 30.0,
        process_index: int = 0,
    ):
        self.path = path
        self._fn = snapshot_fn
        self._process_index = process_index
        self._periodic = PeriodicExporter(self._write, interval_s)

    def _write(self) -> None:
        snap = {
            "time": time.time(),
            "process_index": self._process_index,
            **self._fn(),
        }
        tmp = f"{self.path}.tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, self.path)  # atomic: a crash never leaves torn JSON

    def __enter__(self):
        self._periodic.start()
        return self

    def __exit__(self, *exc):
        self._periodic.close()


def load_snapshot(path: str) -> Optional[dict]:
    """Crash-tolerant read of a SnapshotWriter file (the resume path's
    loader): a missing, empty or truncated/partial JSON snapshot — a
    torn write from a crash mid-flush, or a ``.tmp`` that never got its
    atomic rename — returns ``None`` with a one-line stderr warning
    instead of poisoning the reader with a traceback. The run then
    starts from scratch, which is exactly what a corrupt checkpoint
    must mean."""
    import sys

    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        print(f"warning: {path}: unreadable snapshot ({e}), ignored",
              file=sys.stderr)
        return None
    if not raw.strip():
        print(f"warning: {path}: empty snapshot, ignored", file=sys.stderr)
        return None
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError as e:
        print(
            f"warning: {path}: truncated/partial snapshot "
            f"({e.msg} at char {e.pos}), ignored",
            file=sys.stderr,
        )
        return None
    if not isinstance(doc, dict):
        print(
            f"warning: {path}: snapshot is not a JSON object "
            f"({type(doc).__name__}), ignored",
            file=sys.stderr,
        )
        return None
    return doc


def _otlp_export(exp, payload: dict) -> None:
    """Shared dry-run-capture + POST tail of the OTLP exporters (metrics
    and traces ride the SAME machinery — one copy, so a future retry/
    auth/compression change cannot silently miss one): append to the
    bounded newest-kept capture window, then POST when an endpoint is
    configured (stdlib urllib, 10 s timeout)."""
    exp.exported.append(payload)
    if len(exp.exported) > exp._keep:
        # Keep the newest payloads: a day-long run's dry-run capture
        # must not grow without bound.
        del exp.exported[: len(exp.exported) - exp._keep]
    if exp.endpoint:
        import urllib.request

        req = urllib.request.Request(
            exp.endpoint,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=10):
            pass
        exp.posts += 1


class OTLPMetricsExporter:
    """OTLP-shaped JSON metric export (resourceMetrics/scopeMetrics/
    metrics — the OTLP/HTTP JSON wire shape) off a snapshot function,
    periodic via :class:`PeriodicExporter` like every other exporter
    here. Without an endpoint every payload is captured dry-run (the
    CloudMonitoringExporter discipline: tests and offline uploaders
    assert on ``exported``); with an endpoint set, payloads POST via
    stdlib urllib — no OTel SDK, no new hard deps."""

    def __init__(self, snapshot_fn: Callable[[], dict],
                 endpoint: str = "", resource: Optional[dict] = None,
                 keep_payloads: int = 64):
        self._fn = snapshot_fn
        self.endpoint = endpoint
        self.resource = dict(resource or {})
        self.exported: list[dict] = []  # dry-run / latest-payload capture
        self._keep = max(1, keep_payloads)
        self.posts = 0

    def build_payload(self) -> dict:
        """One OTLP ExportMetricsServiceRequest-shaped dict from the
        registry snapshot: counters → monotonic cumulative sums, gauges
        → gauge points, histograms → explicit-bounds histogram points."""
        snap = self._fn()
        now_ns = time.time_ns()
        metrics = []
        for name, c in snap.get("counters", {}).items():
            points = []
            if isinstance(c, dict):
                # Labeled family (registry snapshot shape:
                # {"label": <key>, "children": {<value>: n}}).
                key = c.get("label", "label")
                for lv, v in sorted(c.get("children", {}).items()):
                    points.append({
                        "asDouble": float(v),
                        "timeUnixNano": str(now_ns),
                        "attributes": [{
                            "key": key,
                            "value": {"stringValue": str(lv)},
                        }],
                    })
            else:
                points.append({
                    "asDouble": float(c),
                    "timeUnixNano": str(now_ns),
                })
            metrics.append({
                "name": name,
                "sum": {
                    "dataPoints": points,
                    "aggregationTemporality": 2,  # CUMULATIVE
                    "isMonotonic": True,
                },
            })
        for name, v in snap.get("gauges", {}).items():
            metrics.append({
                "name": name,
                "gauge": {"dataPoints": [{
                    "asDouble": float(v), "timeUnixNano": str(now_ns),
                }]},
            })
        for name, h in snap.get("histograms", {}).items():
            metrics.append({
                "name": name,
                "histogram": {
                    "dataPoints": [{
                        "count": str(h.get("count", 0)),
                        "sum": float(h.get("sum_ms", 0.0)),
                        "explicitBounds": [
                            float(b) for b in h.get("bounds_ms", [])
                        ],
                        "bucketCounts": [
                            str(c) for c in h.get("counts", [])
                        ],
                        "timeUnixNano": str(now_ns),
                    }],
                    "aggregationTemporality": 2,
                },
            })
        return {
            "resourceMetrics": [{
                "resource": {"attributes": [
                    {"key": k, "value": {"stringValue": str(v)}}
                    for k, v in self.resource.items()
                ]},
                "scopeMetrics": [{
                    "scope": {"name": "tpubench"},
                    "metrics": metrics,
                }],
            }],
        }

    def export_once(self) -> None:
        _otlp_export(self, self.build_payload())

    def summary(self, periodic: Optional["PeriodicExporter"] = None) -> dict:
        out = {
            "payloads": len(self.exported),
            "posts": self.posts,
            "endpoint": self.endpoint or "dry_run",
        }
        if periodic is not None:
            out["flushes"] = periodic.flush_count
            if periodic.error_count:
                out["flush_errors"] = periodic.error_count
                out["last_error"] = periodic.last_error
        return out


class OTLPTraceExporter:
    """OTLP-shaped JSON TRACE export over the run's flight records —
    the span twin of :class:`OTLPMetricsExporter`, riding the same
    dry-run-capture / stdlib-urllib-POST machinery. ``records_fn``
    yields the journal records (the trace store); payload shape comes
    from :func:`tpubench_torch.obs.trace.otlp_trace_payload`. A metrics
    endpoint ending in ``/v1/metrics`` is rewritten to ``/v1/traces``
    (the OTLP/HTTP path convention); any other endpoint is used as-is.
    """

    def __init__(self, records_fn: Callable[[], list],
                 endpoint: str = "", resource: Optional[dict] = None,
                 keep_payloads: int = 4):
        self._fn = records_fn
        self.endpoint = (
            endpoint.replace("/v1/metrics", "/v1/traces")
            if endpoint else ""
        )
        self.resource = dict(resource or {})
        self.exported: list[dict] = []
        self._keep = max(1, keep_payloads)
        self.posts = 0
        self.spans_exported = 0

    def export_once(self) -> None:
        from tpubench_torch.obs.trace import otlp_trace_payload

        payload = otlp_trace_payload(self._fn(), resource=self.resource)
        spans = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
        self.spans_exported += len(spans)
        _otlp_export(self, payload)

    def summary(self) -> dict:
        return {
            "payloads": len(self.exported),
            "spans": self.spans_exported,
            "posts": self.posts,
            "endpoint": self.endpoint or "dry_run",
        }


class MetricsExportSession:
    """In-run periodic metric export — the reference's L2 core behavior
    (view + histogram pushed to Cloud Monitoring every 30 s DURING the run,
    ``metrics_exporter.go:36-58``), generalized to the framework's measure
    set: read/first-byte/stage latency distributions (full histograms) plus
    bytes-ingested and GB/s gauges, flushed every ``interval_s`` and once at
    close (final flush ALWAYS runs — the reference's shadowed-exporter bug
    is not reproduced).

    A long pod run emits its first series after one interval, not only when
    it finishes.
    """

    def __init__(
        self,
        exporter: CloudMonitoringExporter,
        metrics,
        interval_s: float = 30.0,
        labels: Optional[dict] = None,
        bytes_fn: Optional[Callable[[], int]] = None,
    ):
        self.exporter = exporter
        self._metrics = metrics
        self._labels = labels or {}
        # Live progress source for mid-run flushes (the MetricSet's ingest
        # counter is only finalized after the workers join).
        self._bytes_fn = bytes_fn
        self._periodic = PeriodicExporter(self._flush, interval_s)
        # Incremental histogram state: cumulative distribution per series +
        # consumed-sample offset per recorder, so each flush reads only the
        # NEW samples (O(new) per flush, not O(all-so-far) — a long run's
        # flush cost must not grow over time).
        self._dists: dict[str, LatencyDistribution] = {}
        self._offsets: dict[tuple[str, int], int] = {}

    def _dist_of(self, name: str, recorders) -> LatencyDistribution:
        dist = self._dists.setdefault(name, LatencyDistribution())
        for rec in recorders:
            key = (name, id(rec))
            ns, self._offsets[key] = rec.snapshot_tail_ns(
                self._offsets.get(key, 0)
            )
            if ns.size:
                dist.record_many_ms(ns / 1e6)
        return dist

    def _flush(self) -> None:
        m = self._metrics
        for name, recs in (
            ("read_latency", m.read_latency),
            ("first_byte_latency", m.first_byte_latency),
            ("stage_latency", m.stage_latency),
            ("gather_latency", m.gather_latency),
        ):
            dist = self._dist_of(name, recs)
            if dist.count:
                self.exporter.export_distribution(name, dist, self._labels)
        nbytes = self._bytes_fn() if self._bytes_fn else m.ingest.bytes
        self.exporter.export_point("bytes_ingested", float(nbytes), self._labels)
        sec = m.ingest.seconds
        self.exporter.export_point(
            "ingest_gbps", (nbytes / 1e9) / sec if sec > 0 else 0.0, self._labels
        )

    @property
    def flush_count(self) -> int:
        return self._periodic.flush_count

    def summary(self) -> dict:
        """Small run-report stamp: how much was exported, where."""
        return self.exporter.summary(self._periodic)

    def __enter__(self):
        self._periodic.start()
        return self

    def __exit__(self, *exc):
        self._periodic.close()
        self.exporter.close()


def cloud_exporter_from_config(cfg) -> Optional[CloudMonitoringExporter]:
    """``export="cloud"`` activates the push path (dry-run unless
    ``export_dry_run=False``, which needs google-cloud-monitoring and GCP
    creds — absence fails loudly, never a silent no-op). ``"json"``/
    ``"none"`` mean no in-run export."""
    o = cfg.obs
    if o.export in ("", "none", "json"):
        return None
    if o.export != "cloud":
        raise ValueError(f"obs.export={o.export!r}: expected none|json|cloud")
    return CloudMonitoringExporter(
        project=cfg.workload.project or "local",
        metric_prefix=o.metric_prefix,
        interval_s=o.metrics_interval_s,
        dry_run=o.export_dry_run,
        # Per-process label, the global rank (a host launches one rank
        # process a card): without it a pod's N processes write one
        # identical time series and N-1 pushes are rejected.
        base_labels={
            "transport": cfg.transport.protocol,
            "process": str(member(cfg.dist).rank),
        },
    )


def metrics_session_from_config(
    cfg, metrics, bytes_fn: Optional[Callable[[], int]] = None
) -> Optional[MetricsExportSession]:
    """MetricSet-driven session (read workload family) per
    ObservabilityConfig; see :func:`cloud_exporter_from_config`."""
    exporter = cloud_exporter_from_config(cfg)
    if exporter is None:
        return None
    return MetricsExportSession(
        exporter, metrics, interval_s=cfg.obs.metrics_interval_s,
        bytes_fn=bytes_fn,
    )
