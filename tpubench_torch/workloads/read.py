"""Root read benchmark — the reference's flagship (``main.go``), ported from
``tpubench/workloads/read.py`` (its Python-pool route).

* ``workers`` threads, worker ``i`` owns object ``<prefix><i>``
  (``main.go:121``), each doing ``read_calls_per_worker`` full-object reads;
* per read: open reader → stream granule by granule → record full-read and
  first-byte latency → close (``main.go:133-148``);
* errgroup join semantics (``main.go:200-219``) via :class:`WorkerGroup`;
* bytes are staged to the GPU per granule through a ``sink_factory`` hook
  (:func:`tpubench_torch.staging.device.make_sink_factory`), either fetched
  straight into the staging slot (zero-copy) or through a reused granule
  buffer that the stager copies (the copying route).

The result JSON is ``tpubench read``'s, minus the blocks of features not
ported yet (flight recorder, telemetry, tune, tail). Through every client
(fake, HTTP/1.1, native receive, HTTP/2, gRPC, local), under the retry
decorator; with native receive the socket writes straight into the
staging slot.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from tpubench_torch.config import BenchConfig, refuse_unported
from tpubench_torch.device import resolve_device
from tpubench_torch.metrics import MetricSet
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.staging.stats import staging_extra
from tpubench_torch.native.engine import peek_engine
from tpubench_torch.storage import base_backend, open_backend
from tpubench_torch.storage.base import (
    StorageBackend,
    read_object_into_sink,
    read_object_through,
)
from tpubench_torch.workloads.common import WorkerGroup


class Sink(Protocol):
    """Per-worker granule consumer (the staging hook). Sinks may also
    implement the zero-copy pair ``acquire() -> memoryview`` /
    ``commit(n)``; the workload uses it only when both are present and
    records which route ran (``staging_zero_copy``)."""

    def submit(self, mv: memoryview) -> None: ...

    def finish(self) -> dict: ...


SinkFactory = Callable[[int], Sink]


@dataclass
class ReadWorkload:
    cfg: BenchConfig
    backend: StorageBackend
    sink_factory: Optional[SinkFactory] = None

    def run(self) -> RunResult:
        w = self.cfg.workload
        n = w.workers
        metrics = MetricSet()
        recorders = [metrics.new_worker(f"w{i}") for i in range(n)]
        worker_bytes = [0] * n
        sink_stats: list[dict] = [{} for _ in range(n)]
        zero_copy_used = [False] * n

        def worker(i: int, cancel) -> None:
            read_rec, fb_rec = recorders[i]
            name = f"{w.object_name_prefix}{i}"  # main.go:121
            sink = self.sink_factory(i) if self.sink_factory else None
            zero_copy = (
                sink is not None
                and self.cfg.staging.zero_copy
                and hasattr(sink, "acquire")
                and hasattr(sink, "commit")
            )
            zero_copy_used[i] = zero_copy
            granule = (
                None if zero_copy else memoryview(bytearray(w.granule_bytes))
            )
            submit = sink.submit if (sink and not zero_copy) else None
            total_local = 0
            try:
                for _ in range(w.read_calls_per_worker):
                    if cancel.is_set():
                        break
                    t0 = time.perf_counter_ns()
                    reader = self.backend.open_read(name)
                    if zero_copy:
                        nbytes, fb_ns = read_object_into_sink(
                            reader, sink, w.granule_bytes
                        )
                    else:
                        nbytes, fb_ns = read_object_through(
                            reader, granule, submit
                        )
                    t1 = time.perf_counter_ns()
                    read_rec.record_ns(t1 - t0)
                    if fb_ns is not None:
                        fb_rec.record_ns(fb_ns - t0)
                    total_local += nbytes
                    worker_bytes[i] = total_local
            finally:
                if sink is not None:
                    sink_stats[i] = sink.finish() or {}
                worker_bytes[i] = total_local

        # Native transport counters: their delta across the run goes into
        # the result when the engine is live.
        eng0 = peek_engine()
        native_stats0 = eng0.stats() if eng0 is not None else {}
        metrics.ingest.start()
        group = WorkerGroup(abort_on_error=w.abort_on_error)
        try:
            gres = group.run(n, worker, name="read")
        finally:
            metrics.ingest.stop()
            metrics.ingest.bytes = sum(worker_bytes)
            # Stage-latency recorders created by sinks live in their stats.
            for st in sink_stats:
                rec = st.get("stage_recorder")
                if rec is not None:
                    metrics.stage_latency.append(rec)

        wall = metrics.ingest.seconds
        gbps = metrics.ingest.gbps()
        n_chips = max(1, int(sink_stats[0].get("n_chips", 1))) if sink_stats else 1
        staged = sum(int(st.get("staged_bytes", 0)) for st in sink_stats)
        res = RunResult(
            workload="read",
            config=self.cfg.to_dict(),
            bytes_total=metrics.ingest.bytes,
            wall_seconds=wall,
            gbps=gbps,
            gbps_per_chip=gbps / n_chips,
            n_chips=n_chips,
            summaries=metrics.summaries(),
            errors=gres.error_count,
        )
        # Native-receive connection accounting (connects/reuses/
        # stale_retries), read from the base client's pool only if one was
        # built, so this never builds a pool as a side effect.
        native_pool = getattr(base_backend(self.backend), "_native_pool_obj", None)
        if native_pool is not None:
            res.extra["native_conn_stats"] = dict(native_pool.stats)
        if staged:
            res.extra["staging_zero_copy"] = all(zero_copy_used)
            res.extra["staged_bytes"] = staged
            res.extra["staged_gbps"] = (staged / 1e9) / wall if wall > 0 else 0.0
            res.extra["staged_gbps_per_chip"] = res.extra["staged_gbps"] / n_chips
            # Phase breakdown (averaged per worker, seconds): fetch-thread
            # time blocked on transfers vs in submission — the rest is
            # fetch + pipeline overhead.
            live = [st for st in sink_stats if "transfer_wait_ns" in st]
            if live:
                k = len(live)
                res.extra["staging_breakdown"] = {
                    "workers": k,
                    "drain": live[0].get("drain", "inline"),
                    "wall_s": wall,
                    "transfer_wait_s": sum(
                        st["transfer_wait_ns"] for st in live
                    ) / 1e9 / k,
                    "put_submit_s": sum(
                        st["put_submit_ns"] for st in live
                    ) / 1e9 / k,
                }
                if any("checksum_reduce_ns" in st for st in live):
                    res.extra["staging_breakdown"]["checksum_reduce_s"] = sum(
                        st.get("checksum_reduce_ns", 0) for st in live
                    ) / 1e9 / k
            staging_block = staging_extra(sink_stats)
            if staging_block is not None:
                res.extra["staging"] = staging_block
        checks = [st["checksum_ok"] for st in sink_stats if "checksum_ok" in st]
        if checks:
            res.extra["checksum_ok"] = all(checks)
        eng1 = peek_engine()
        if eng1 is not None:
            delta = {
                k: v - native_stats0.get(k, 0) for k, v in eng1.stats().items()
            }
            if any(delta.values()):
                res.extra["native_transport"] = delta
        return res


def run_read(
    cfg: BenchConfig,
    backend: Optional[StorageBackend] = None,
    sink_factory: Optional[SinkFactory] = None,
    device="cuda",
) -> RunResult:
    """Run the read workload. ``device`` must be ``"cpu"`` to run without
    CUDA; features the port does not have yet raise
    ``NotImplementedError`` before anything runs. ``fetch_executor``
    ``native*`` runs on the C++ fetch executor
    (:mod:`tpubench_torch.workloads.fetch_executor`), which stages without
    ``sink_factory``."""
    resolve_device(device)
    refuse_unported(cfg)
    owns_backend = backend is None
    backend = backend or open_backend(cfg)
    try:
        if cfg.workload.fetch_executor.startswith("native"):
            from tpubench_torch.workloads.fetch_executor import (
                run_read_native_executor,
                run_read_native_staged,
            )

            if cfg.staging.mode == "none":
                return run_read_native_executor(cfg, backend)
            return run_read_native_staged(cfg, backend, device=device)
        return ReadWorkload(
            cfg=cfg, backend=backend, sink_factory=sink_factory,
        ).run()
    finally:
        if owns_backend:
            backend.close()
