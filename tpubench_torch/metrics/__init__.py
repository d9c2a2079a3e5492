"""Metrics core (copies of ``tpubench/metrics``, numpy only): race-free
per-worker recorders, ssd_test-format percentiles, throughput accounting
and result files."""

from tpubench_torch.metrics.percentiles import LatencySummary, format_summary, summarize  # noqa: F401
from tpubench_torch.metrics.recorder import (  # noqa: F401
    ByteCounter,
    LatencyRecorder,
    MetricSet,
    merge_recorders,
)
from tpubench_torch.metrics.report import RunResult, write_result  # noqa: F401
