"""Observability layer: metrics registry, step tracer, telemetry config and
Chrome trace export (copies of ``repro.core.telemetry``). Standard library
only: the exported traces are read back by ``tools/trace_summary.py``."""
from repro_torch.core.telemetry.config import TelemetryConfig  # noqa: F401
from repro_torch.core.telemetry.export import (  # noqa: F401
    chrome_trace,
    write_chrome_trace,
)
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
