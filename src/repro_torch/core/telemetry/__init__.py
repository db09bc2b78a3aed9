"""Observability layer: metrics registry + step tracer (copies of
``repro.core.telemetry.registry`` / ``tracer``). The Chrome-trace exporter
and ``TelemetryConfig`` come with the port's ``--trace-out``."""
from repro_torch.core.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.core.telemetry.tracer import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    SpanEvent,
    StepTracer,
)
