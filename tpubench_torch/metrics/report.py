"""First-class result files: the same result JSON as ``tpubench``'s
(``tpubench/metrics/report.py``), written by the port's workloads, and
:func:`upload_result`, which pushes one to ``obs.results_bucket``."""

from __future__ import annotations

import json
import os
import platform
import time
from dataclasses import dataclass, field
from typing import Any

from tpubench_torch.metrics.percentiles import LatencySummary, format_summary


@dataclass
class RunResult:
    workload: str
    config: dict[str, Any]
    bytes_total: int = 0
    wall_seconds: float = 0.0
    gbps: float = 0.0
    gbps_per_chip: float = 0.0
    n_chips: int = 1
    summaries: dict[str, LatencySummary] = field(default_factory=dict)
    extra: dict[str, Any] = field(default_factory=dict)
    errors: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "workload": self.workload,
            "timestamp": time.time(),
            "host": platform.node(),
            "config": self.config,
            "bytes_total": self.bytes_total,
            "wall_seconds": self.wall_seconds,
            "gbps": self.gbps,
            "gbps_per_chip": self.gbps_per_chip,
            "n_chips": self.n_chips,
            "errors": self.errors,
            "summaries": {k: s.to_dict() for k, s in self.summaries.items()},
            "extra": self.extra,
        }

    def format(self) -> str:
        lines = [
            f"== tpubench_torch {self.workload} ==",
            f"bytes={self.bytes_total} wall={self.wall_seconds:.3f}s "
            f"GB/s={self.gbps:.3f} GB/s/chip={self.gbps_per_chip:.3f} "
            f"chips={self.n_chips} errors={self.errors}",
        ]
        for key, s in self.summaries.items():
            lines.append(format_summary(key, s))
        return "\n".join(lines)


def upload_result(cfg, path: str, backend=None) -> str:
    """Push one result JSON to ``cfg.obs.results_bucket`` over the run's own
    storage protocol — the ``gsutil cp`` step of the reference's experiment
    loop (execute_pb.sh:5) as a first-class framework capability. Returns
    the uploaded object name."""
    from tpubench_torch.storage import open_backend

    owns = backend is None
    if backend is None:
        proto = cfg.transport.protocol
        if proto not in ("http", "grpc"):
            # 'local' would ignore the bucket (it roots at workload.dir) and
            # 'fake' would drop the bytes in a throwaway in-process store —
            # either way "uploaded" would be a lie. Fail loudly instead.
            raise ValueError(
                f"results_bucket requires an object-store protocol "
                f"(http|grpc), not {proto!r}"
            )
        up_cfg = type(cfg).from_dict(cfg.to_dict())
        up_cfg.workload.bucket = cfg.obs.results_bucket
        backend = open_backend(up_cfg)
    try:
        name = f"results/{os.path.basename(path)}"
        with open(path, "rb") as f:
            backend.write(name, f.read())
        return name
    finally:
        if owns:
            backend.close()


def write_result(result: RunResult, results_dir: str, tag: str = "") -> str:
    os.makedirs(results_dir, exist_ok=True)
    fname = f"{result.workload}_{tag + '_' if tag else ''}{int(time.time() * 1000)}.json"
    path = os.path.join(results_dir, fname)
    with open(path, "w") as f:
        json.dump(result.to_dict(), f, indent=2)
    return path
