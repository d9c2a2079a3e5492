"""Span-per-read tracing (reference ``trace_exporter.go`` + main.go:129-132;
a copy of ``tpubench/obs/tracing.py``).

The reference opens an OTel span per read with a bucket attribute and bridges
OpenCensus spans from inside the storage library. Here the workload code
talks to a tiny ``Tracer`` protocol; implementations:

* ``NoopTracer`` — default, zero overhead;
* ``RecordingTracer`` — in-process, for tests and local span dumps;
* OTel-backed tracer via :func:`make_tracer` when ``enable_tracing`` is set
  and ``opentelemetry`` is importable (sampling via ``trace_sample_rate``,
  trace_exporter.go:44).

Beyond the reference: spans get ``first_byte`` and ``stage`` (HBM-landing)
events — the north-star observability split (SURVEY §5.1).

This module is also the home of the CAUSAL trace plane's context layer:
a thread-local :class:`TraceContext` (``trace_id``/``span_id``/
per-trace ``sampled`` bit) that the flight recorder, the tail stack's
helper threads, the coop peer channel and the staging reaper all thread
through, so every flight record lands with ``trace_id``/``span_id``/
``parent_id`` and journals become the trace store (assembled by
:mod:`tpubench_torch.obs.trace` / ``tpubench report trace``). Sampling is
decided per-TRACE at the root — a child span always inherits its
parent's decision, so a sampled child can never orphan under an
unsampled parent.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Iterator, Optional, Protocol

# ---------------------------------------------------------- trace context ---

_ctx_tls = threading.local()
_id_tls = threading.local()


def _id_rng() -> random.Random:
    """Per-thread id generator (no lock, no per-op urandom syscall on the
    hot read path); seeded from the process RNG pool once per thread."""
    rng = getattr(_id_tls, "rng", None)
    if rng is None:
        import os

        rng = _id_tls.rng = random.Random(
            int.from_bytes(os.urandom(16), "big") ^ threading.get_ident()
        )
    return rng


def seed_trace_ids(seed: int) -> None:
    """Deterministic ids for THIS thread (tests/replays only)."""
    _id_tls.rng = random.Random(seed)


def new_trace_id() -> str:
    return f"{_id_rng().getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_id_rng().getrandbits(64):016x}"


def derive_span_id(parent_span_id: str, name: str) -> str:
    """Deterministic child-span id for a SYNTHESIZED span (a phase
    segment of a flight record). Both sides of a cross-host hop can
    compute it independently — the requester propagates
    ``derive_span_id(read_span, "peer_request")`` and the merge pass
    re-derives the same id from the requester's record, which is what
    stitches the owner's spans under the right parent with no id
    exchange beyond the context itself."""
    return hashlib.blake2b(
        f"{parent_span_id}/{name}".encode(), digest_size=8
    ).hexdigest()


@dataclass(frozen=True)
class TraceContext:
    """One position in a trace tree: new spans created under this
    context join ``trace_id`` with ``span_id`` as their parent, and
    inherit the per-trace ``sampled`` decision."""

    trace_id: str
    span_id: str
    sampled: bool = True


def current_trace() -> Optional[TraceContext]:
    return getattr(_ctx_tls, "ctx", None)


def adopt_trace(ctx: Optional[TraceContext]) -> None:
    """Install ``ctx`` as THIS thread's trace position (None clears it)
    — the helper-thread half of the propagation discipline (hedge
    producers, the staging reaper, peer serves), mirroring
    ``flight.adopt_op``."""
    _ctx_tls.ctx = ctx


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Scoped adopt/restore: spans/records created inside parent under
    ``ctx`` (a None ctx scopes a no-op — callers need no branching)."""
    if ctx is None:
        yield
        return
    prev = current_trace()
    _ctx_tls.ctx = ctx
    try:
        yield
    finally:
        _ctx_tls.ctx = prev


class Span(Protocol):
    def event(self, name: str, **attrs) -> None: ...


class Tracer(Protocol):
    def span(self, name: str, **attrs) -> contextlib.AbstractContextManager[Span]: ...

    def shutdown(self) -> None:
        """Flush-on-exit (reference trace_exporter.go:55-60): callers wrap
        runs in try/finally shutdown() so batched spans are never lost."""


class _NoopSpan:
    __slots__ = ()

    def event(self, name: str, **attrs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        yield _NOOP_SPAN

    def shutdown(self) -> None:
        pass


@dataclass
class RecordedSpan:
    name: str
    attrs: dict
    start_ns: int
    end_ns: int = 0
    events: list = field(default_factory=list)
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""

    def event(self, name: str, **attrs) -> None:
        self.events.append((name, time.perf_counter_ns(), attrs))


class RecordingTracer:
    """Thread-safe in-process tracer; sampling mirrors TraceIDRatioBased.

    Sampling is decided per-TRACE, at the root span: a span opened under
    an active :class:`TraceContext` inherits the root's decision instead
    of re-drawing. (The old per-span draw could sample a child whose
    parent was dropped — an orphan span no tool can ever stitch.) Every
    span installs its context for its scope, so child spans — and flight
    records begun inside it — parent under it."""

    def __init__(self, sample_rate: float = 1.0, seed: int = 0,
                 max_spans: int = 65536):
        self.sample_rate = sample_rate
        # Bounded (the EXACT_SAMPLE_CAP discipline, enforced by
        # `tpubench check`): an open-loop serve run is unbounded in
        # time, and journals — not this in-process buffer — are the
        # durable trace store. Keep-first + a drop counter: the run
        # report can say how much was cut.
        self.spans: list[RecordedSpan] = []
        self.max_spans = max(1, int(max_spans))
        self.dropped_spans = 0
        self._lock = threading.Lock()
        self._rng = random.Random(seed)

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        parent = current_trace()
        if parent is not None:
            # Per-trace decision: inherit the root's draw verbatim.
            sampled = parent.sampled
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            with self._lock:
                sampled = self._rng.random() < self.sample_rate
            trace_id, parent_id = new_trace_id(), ""
        span_id = new_span_id()
        ctx = TraceContext(trace_id, span_id, sampled)
        if not sampled:
            # Unsampled root still scopes its (unsampled) context so the
            # whole tree shares one decision — children skip too.
            with trace_scope(ctx):
                yield _NOOP_SPAN
            return
        sp = RecordedSpan(
            name=name, attrs=attrs, start_ns=time.perf_counter_ns(),
            trace_id=trace_id, span_id=span_id, parent_id=parent_id,
        )
        try:
            with trace_scope(ctx):
                yield sp
        finally:
            sp.end_ns = time.perf_counter_ns()
            with self._lock:
                if len(self.spans) < self.max_spans:
                    self.spans.append(sp)
                else:
                    self.dropped_spans += 1

    def shutdown(self) -> None:
        # Same one-line-warning discipline as OtelTracer.shutdown: a
        # truncated span set must not LOOK complete.
        if self.dropped_spans:
            warnings.warn(
                f"RecordingTracer dropped {self.dropped_spans} spans "
                f"past the max_spans={self.max_spans} cap — the kept "
                "set is the run's FIRST spans, not all of them",
                stacklevel=2,
            )


class SpanCarrier:
    """A manually-entered span whose lifetime crosses a call boundary —
    the client-internal request spans end when their READER closes, not
    when ``open_read`` returns. Enter at construction; end exactly once via
    :meth:`close` (optionally with the exception that ended the request, so
    failed reads export as failed spans, not OK ones). Idempotent."""

    __slots__ = ("_cm", "span")

    def __init__(self, tracer: Tracer, name: str, **attrs):
        self._cm = tracer.span(name, **attrs)
        self.span = self._cm.__enter__()

    def event(self, name: str, **attrs) -> None:
        self.span.event(name, **attrs)

    def close(self, exc: Optional[BaseException] = None) -> None:
        if self._cm is None:
            return
        cm, self._cm = self._cm, None
        if exc is not None:
            cm.__exit__(type(exc), exc, exc.__traceback__)
        else:
            cm.__exit__(None, None, None)


class OtelTracer:
    """OTel SDK-backed tracer (gated; reference trace_exporter.go:18-61).

    ``span_processor`` (or the ``exporter`` name) attaches the export path —
    the reference ships spans to Cloud Trace; here "console" (stdout, for
    local inspection), "cloud_trace" (gated on the GCP exporter package), or
    a caller-supplied processor (tests use an in-memory one). Without one,
    spans are sampled/created but not exported.
    """

    def __init__(
        self,
        sample_rate: float,
        service_name: str,
        transport: str,
        span_processor=None,
        exporter: str = "",
    ):
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.sampling import TraceIdRatioBased

        resource = Resource.create(
            {"service.name": service_name, "transport": transport}
        )
        self._provider = TracerProvider(
            sampler=TraceIdRatioBased(sample_rate), resource=resource
        )
        if span_processor is None and exporter:
            span_processor = self._make_processor(exporter)
        if span_processor is not None:
            self._provider.add_span_processor(span_processor)
        self._tracer = self._provider.get_tracer("tpubench")

    @staticmethod
    def _make_processor(exporter: str):
        from opentelemetry.sdk.trace.export import (
            BatchSpanProcessor,
            ConsoleSpanExporter,
        )

        if exporter == "console":
            return BatchSpanProcessor(ConsoleSpanExporter())
        if exporter == "cloud_trace":
            # Reference: texporter.New → Cloud Trace (trace_exporter.go:19).
            from opentelemetry.exporter.cloud_trace import (  # gated
                CloudTraceSpanExporter,
            )

            return BatchSpanProcessor(CloudTraceSpanExporter())
        raise ValueError(f"unknown trace exporter {exporter!r}")

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        with self._tracer.start_as_current_span(name) as otel_span:
            for k, v in attrs.items():
                otel_span.set_attribute(k, v)

            class _Wrap:
                def event(self, ename: str, **eattrs) -> None:
                    otel_span.add_event(ename, eattrs)

            # Install this span's position as the thread's TraceContext
            # (the same contract RecordingTracer honors), so flight ops
            # begun inside join the SAME trace the SDK exports instead
            # of rooting their own: with the real SDK the journal
            # records carry the exported span's exact ids. A double/
            # older SDK without get_span_context falls back to local
            # ids — parenting among records stays consistent, and the
            # read workload's `trace_context` span event remains the
            # bidirectional handle.
            parent = current_trace()
            sc = getattr(otel_span, "get_span_context", lambda: None)()
            if sc is not None and getattr(sc, "trace_id", 0):
                trace_id = f"{sc.trace_id:032x}"
                span_id = f"{sc.span_id:016x}"
            else:
                trace_id = parent.trace_id if parent else new_trace_id()
                span_id = new_span_id()
            recording = getattr(otel_span, "is_recording", lambda: True)()
            sampled = bool(recording) and (
                parent.sampled if parent is not None else True
            )
            with trace_scope(TraceContext(trace_id, span_id, sampled)):
                yield _Wrap()

    def shutdown(self) -> None:
        # Flush-on-exit must never turn a finished run into a traceback:
        # an exporter raising inside the SDK's shutdown (endpoint gone,
        # batch processor already torn down — broken-SDK shapes) degrades
        # to a one-line warning. The run's RESULTS are already written by
        # the time any tracer flushes.
        try:
            self._provider.shutdown()
        except Exception as e:  # noqa: BLE001 — see above
            warnings.warn(
                f"trace exporter flush failed at shutdown "
                f"({type(e).__name__}: {e}); spans may be incomplete",
                stacklevel=2,
            )


@contextlib.contextmanager
def tracer_session(cfg) -> Iterator[Tracer]:
    """The ONE flush-on-exit discipline for every subcommand that runs a
    workload (reference trace_exporter.go:55-60): build the configured
    tracer, yield it, and shutdown() in the finally — so batched spans
    (console/cloud_trace exporters) survive chaos/tune/read alike, and a
    flush error degrades per OtelTracer.shutdown's one-line-warning
    contract instead of masking the run's real outcome."""
    tracer = make_tracer(cfg)
    try:
        yield tracer
    finally:
        tracer.shutdown()


def make_tracer(cfg) -> Tracer:
    """From an ObservabilityConfig (+TransportConfig context)."""
    if not cfg.obs.enable_tracing:
        return NoopTracer()
    requested_exporter = getattr(cfg.obs, "trace_exporter", "")
    try:
        import opentelemetry.sdk.trace  # noqa: F401 — availability probe
    except ImportError:
        if requested_exporter:
            # The user explicitly asked for an export path; dropping it
            # silently would hide that no spans ever leave the process.
            raise RuntimeError(
                f"trace_exporter={requested_exporter!r} requires the "
                "opentelemetry-sdk package, which is not installed"
            ) from None
        # OTel SDK missing, no exporter requested: degrade to in-process
        # recording rather than failing the benchmark run.
        return RecordingTracer(sample_rate=cfg.obs.trace_sample_rate)
    # SDK present: an explicitly requested exporter that cannot be built
    # (unknown name, cloud-trace package absent) is a CONFIG error and must
    # surface, not silently degrade.
    try:
        return OtelTracer(
            sample_rate=cfg.obs.trace_sample_rate,
            service_name="tpubench",
            transport=cfg.transport.protocol,
            exporter=requested_exporter,
        )
    except (ImportError, AttributeError, TypeError) as e:
        # Import/ABI shape failures = SDK version skew (TypeError covers
        # constructor-signature drift across SDK versions). Config-shaped
        # errors (e.g. an out-of-range sample rate raising ValueError) are
        # NOT caught — a bad config must surface, not silently downgrade.
        if requested_exporter:
            raise
        # Skew with no exporter asked for: degrade to in-process recording
        # rather than failing the run — but VISIBLY.
        import warnings

        warnings.warn(
            f"OTel tracer construction failed ({type(e).__name__}: {e}); "
            "degrading to in-process RecordingTracer",
            stacklevel=2,
        )
        return RecordingTracer(sample_rate=cfg.obs.trace_sample_rate)
