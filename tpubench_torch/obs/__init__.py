"""Observability of the port (a copy of ``tpubench/obs``): tracing spans,
metric export, live telemetry, and the per-read flight recorder."""

from tpubench_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    flight_from_config,
    render_timeline,
)
from tpubench_torch.obs.telemetry import (  # noqa: F401
    TelemetryRegistry,
    TelemetrySession,
    telemetry_from_config,
)
from tpubench_torch.obs.tracing import (  # noqa: F401
    NoopTracer,
    RecordingTracer,
    Tracer,
    make_tracer,
)
