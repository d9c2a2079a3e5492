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

The result JSON is ``tpubench read``'s. Through every client (fake, HTTP/1.1,
native receive, HTTP/2, gRPC, local), under the tail layers and the retry
decorator; with native receive the socket writes straight into the
staging slot. The obs plane rides along as in ``tpubench``: one
``ReadObject`` span per read with its flight record begun inside it, the
staging rings' per-transfer records on the same recorder, live telemetry,
and the metrics export session.

With ``tune.enabled`` the online controller (:mod:`tpubench_torch.tune`)
moves live knobs while the run goes: worker fan-out through an
:class:`~tpubench_torch.workloads.common.ElasticGate`, the hedge delay,
and (copy ring, depth > 1, no validation) every worker's staging depth
through a :class:`~tpubench_torch.staging.executor.StagerRegistry`. Such
a session is bounded by ``tune.duration_s``; its trace lands in
``extra["tune"]`` and, with a recorder, as ``kind="tune"`` flight records.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from tpubench_torch.config import BenchConfig, refuse_unported
from tpubench_torch.device import resolve_device
from tpubench_torch.metrics import MetricSet
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.native.engine import peek_engine
from tpubench_torch.obs.exporters import metrics_session_from_config
from tpubench_torch.obs.flight import (
    flight_from_config,
    rank_journal_path,
    transport_label,
)
from tpubench_torch.obs.telemetry import telemetry_from_config
from tpubench_torch.obs.tracing import NoopTracer, Tracer
from tpubench_torch.staging.stats import staging_extra
from tpubench_torch.storage import base_backend, collect_tail_stats, open_backend
from tpubench_torch.storage.base import (
    StorageBackend,
    read_object_into_sink,
    read_object_through,
)
from tpubench_torch.workloads.common import ElasticGate, WorkerGroup


class Sink(Protocol):
    """Per-worker granule consumer (the staging hook). Sinks may also
    implement the zero-copy pair ``acquire() -> memoryview`` /
    ``commit(n)``; the workload uses it only when both are present and
    records which route ran (``staging_zero_copy``)."""

    def submit(self, mv: memoryview) -> None: ...

    def finish(self) -> dict: ...


SinkFactory = Callable[[int], Sink]


def _build_read_controller(cfg, read_recorders, bytes_fn, backend, gate,
                           flight, stager_registry=None):
    """Tune controller of the worker-pool route: live knobs are the
    elastic worker fan-out, the hedge delay (when hedging is on) and the
    staging window's depth (when the copy ring overlaps), fanned out to
    every worker's ring through the stager registry; goodput and p99 are
    sampled off the run's own per-worker recorders."""
    from tpubench_torch.storage.tail import HedgedBackend, find_tail_layer
    from tpubench_torch.tune.controller import (
        Knob,
        RecorderSampler,
        TuneController,
        hedge_delay_knob,
        staging_depth_ceiling,
    )

    wanted = set(cfg.tune.knobs)
    knobs = []
    if "workers" in wanted and gate.total > 1:
        knobs.append(Knob(
            "workers", gate.active, gate.set_active,
            lo=1, hi=gate.total, mode="mul",
        ))
    if "hedge_delay_s" in wanted and cfg.transport.tail.hedge:
        hb = find_tail_layer(backend, HedgedBackend)
        if hb is not None:
            knobs.append(hedge_delay_knob(
                cfg.transport.tail.hedge_delay_s, hb.set_hedge_delay,
            ))
    if stager_registry is not None:
        depth0 = max(1, cfg.staging.depth)
        knobs.append(Knob(
            "staging_depth", depth0, stager_registry.set_depth,
            lo=1, hi=staging_depth_ceiling(depth0), mode="mul",
        ))
    if not knobs:
        return None
    sampler = RecorderSampler(read_recorders, bytes_fn)
    ring = flight.worker("tune") if flight is not None else None
    return TuneController(cfg.tune, knobs, sampler, flight_ring=ring)


@dataclass
class ReadWorkload:
    cfg: BenchConfig
    backend: StorageBackend
    tracer: Tracer
    sink_factory: Optional[SinkFactory] = None

    def run(self) -> RunResult:
        w = self.cfg.workload
        n = w.workers
        metrics = MetricSet()
        recorders = [metrics.new_worker(f"w{i}") for i in range(n)]
        worker_bytes = [0] * n
        sink_stats: list[dict] = [{} for _ in range(n)]
        zero_copy_used = [False] * n
        # Flight recorder: per-worker record rings, one phase record per
        # read (worker-owned, like the latency recorders above).
        flight = flight_from_config(self.cfg)
        tlabel = transport_label(self.cfg)
        flights = [
            flight.worker(f"w{i}") if flight is not None else None
            for i in range(n)
        ]
        # Native transport counters: their delta across the run goes into
        # the result (and the journal) when the engine is live.
        eng0 = peek_engine()
        native_stats0 = eng0.stats() if eng0 is not None else {}

        # Live telemetry: registry fed record by record off the flight
        # tap, read latency sampled off the per-worker recorders, journal
        # streamed each tick.
        jpath_stream = None
        if self.cfg.obs.flight_journal:
            jpath_stream = rank_journal_path(self.cfg)
        tel = telemetry_from_config(self.cfg)
        tel_summary = None
        if tel is not None:
            tel.resource["workload"] = "read"
            if flight is not None:
                tel.attach_flight(flight)
                if jpath_stream:
                    tel.stream_journal(
                        flight, jpath_stream,
                        extra_fn=lambda: {"workload": "read"},
                        max_bytes=self.cfg.obs.journal_max_bytes,
                    )
            tel.attach_recorders(metrics.read_latency)
            tel.start()

        # Tuning: an elastic gate makes worker fan-out a live knob (all
        # threads spawn, the controller admits a subset; parked workers
        # resume when it grows the pool back). The overlapped copy ring's
        # depth is a live knob through a registry that fans set_depth out
        # to every ring as the workers build them (the same condition as
        # tpubench: the landing ring and the validating ring have none).
        tune_on = self.cfg.tune.enabled
        gate = ElasticGate(n, n) if tune_on else None
        stager_registry = None
        sink_factory = self.sink_factory
        s = self.cfg.staging
        if (
            tune_on and sink_factory is not None
            and "staging_depth" in self.cfg.tune.knobs
            and s.mode == "device_put" and s.double_buffer and s.depth > 1
            and not s.validate_checksum
        ):
            from tpubench_torch.staging.executor import StagerRegistry

            stager_registry = StagerRegistry()
            base_factory = sink_factory
            sink_factory = lambda i: stager_registry.attach(base_factory(i))  # noqa: E731

        def worker(i: int, cancel) -> None:
            read_rec, fb_rec = recorders[i]
            wf = flights[i]
            name = f"{w.object_name_prefix}{i}"  # main.go:121
            sink = sink_factory(i) if sink_factory else None
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
                    # Admitted before t0: a parked worker's wait is never
                    # read or first-byte latency.
                    if gate is not None and not gate.admit(i, cancel):
                        break
                    with self.tracer.span(
                        "ReadObject", bucket=w.bucket, object=name
                    ) as span:
                        t0 = time.perf_counter_ns()
                        # The op begins INSIDE the span's scope, so its
                        # flight record joins the span's trace.
                        op = (
                            wf.begin(name, tlabel, enqueue_ns=t0)
                            if wf is not None else None
                        )
                        if op is not None:
                            span.event(
                                "trace_context", trace_id=op.trace_id,
                                span_id=op.span_id,
                            )
                        try:
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
                        except BaseException as e:
                            if op is not None:
                                op.finish(error=e)
                            raise
                        read_rec.record_ns(t1 - t0)
                        if fb_ns is not None:
                            fb_rec.record_ns(fb_ns - t0)
                            span.event("first_byte")
                        if op is not None:
                            if fb_ns is not None:
                                op.mark("first_byte", fb_ns)
                            op.mark("body_complete", t1)
                            op.finish(nbytes)
                        total_local += nbytes
                        worker_bytes[i] = total_local
            finally:
                if sink is not None:
                    sink_stats[i] = sink.finish() or {}
                worker_bytes[i] = total_local

        session = metrics_session_from_config(
            self.cfg, metrics, bytes_fn=lambda: sum(worker_bytes)
        )
        metrics.ingest.start()
        group = WorkerGroup(abort_on_error=w.abort_on_error)
        result_errors = 0
        controller = None
        duration_timer = None
        tune_stats = None
        if gate is not None:
            controller = _build_read_controller(
                self.cfg, metrics.read_latency,
                lambda: sum(worker_bytes), self.backend, gate, flight,
                stager_registry=stager_registry,
            )
            # An online session is duration-bounded: a shrink parks
            # workers with reads left, so read-count completion can no
            # longer be the only exit. No controller (nothing actuatable)
            # = no cap: the run must not silently truncate.
            if controller is not None:
                duration_timer = threading.Timer(
                    self.cfg.tune.duration_s, group.cancel.set
                )
                duration_timer.daemon = True
        try:
            if session is not None:
                session.__enter__()
            try:
                # Ambient recorder: the staging rings (built inside the
                # workers) append their per-transfer records to it.
                with (flight.activate() if flight is not None
                      else contextlib.nullcontext()):
                    if controller is not None:
                        controller.start()
                    if duration_timer is not None:
                        duration_timer.start()
                    gres = group.run(n, worker, name="read")
                result_errors = gres.error_count
            finally:
                if duration_timer is not None:
                    duration_timer.cancel()
                if controller is not None:
                    tune_stats = controller.stop()
                metrics.ingest.stop()
                metrics.ingest.bytes = sum(worker_bytes)
                # Stage-latency recorders created by sinks live in their
                # stats; merged BEFORE the session's final flush.
                for st in sink_stats:
                    rec = st.get("stage_recorder")
                    if rec is not None:
                        metrics.stage_latency.append(rec)
        finally:
            if session is not None:
                session.__exit__(None, None, None)  # guaranteed final flush
            if tel is not None:
                # Workers joined and every sink finished: closed here so
                # the HTTP server and tick thread never outlive a run.
                block = staging_extra(sink_stats)
                tel.set_chips(
                    int(sink_stats[0].get("n_chips", 1) or 1)
                    if sink_stats else 1
                )
                tel_summary = tel.close(
                    final_extra={"staging": block} if block else None
                )

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
            errors=result_errors,
        )
        if session is not None:
            res.extra["metrics_export"] = session.summary()
        if tel_summary is not None:
            res.extra["telemetry"] = tel_summary
        if tune_stats is not None:
            res.extra["tune"] = tune_stats
        # Native-receive connection accounting (connects/reuses/
        # stale_retries), read from the base client's pool only if one was
        # built, so this never builds a pool as a side effect.
        native_pool = getattr(base_backend(self.backend), "_native_pool_obj", None)
        if native_pool is not None:
            res.extra["native_conn_stats"] = dict(native_pool.stats)
        # Tail counters (hedge wins/losses/waste, stalls, breaker state).
        tail_stats = collect_tail_stats(self.backend)
        if tail_stats:
            res.extra["tail"] = tail_stats
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
        native_delta = None
        if eng1 is not None:
            native_delta = {
                k: v - native_stats0.get(k, 0) for k, v in eng1.stats().items()
            }
            if any(native_delta.values()):
                res.extra["native_transport"] = native_delta
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if jpath_stream:
                extra = {"workload": "read", "n_chips": n_chips}
                if native_delta:
                    extra["native_transport"] = native_delta
                res.extra["flight_journal"] = flight.write_journal(
                    jpath_stream, extra=extra,
                    max_bytes=self.cfg.obs.journal_max_bytes,
                )
        return res


def run_read(
    cfg: BenchConfig,
    backend: Optional[StorageBackend] = None,
    sink_factory: Optional[SinkFactory] = None,
    device="cuda",
    tracer: Optional[Tracer] = None,
) -> RunResult:
    """Run the read workload. ``device`` must be ``"cpu"`` to run without
    CUDA; features the port does not have yet raise
    ``NotImplementedError`` before anything runs. ``fetch_executor``
    ``native*`` runs on the C++ fetch executor
    (:mod:`tpubench_torch.workloads.fetch_executor`), which stages without
    ``sink_factory``. ``tracer`` opens the per-read spans; the backend
    gets the same one, so its request spans nest under them."""
    resolve_device(device)
    refuse_unported(cfg)
    if cfg.coop.enabled:
        # The cooperative cache lives in the pipeline miss path, which
        # only train-ingest drives: say so rather than run the plain
        # per-host read quietly (a quiet no-op would poison an A/B).
        print(
            "read: --coop has no effect on this workload (the cooperative "
            "cache rides the train-ingest pipeline miss path)",
            file=sys.stderr,
        )
    tracer = tracer or NoopTracer()
    owns_backend = backend is None
    backend = backend or open_backend(cfg, tracer=tracer)
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
            cfg=cfg, backend=backend, tracer=tracer,
            sink_factory=sink_factory,
        ).run()
    finally:
        if owns_backend:
            backend.close()
