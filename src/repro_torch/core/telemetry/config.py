"""Telemetry configuration (a copy of ``repro.core.telemetry.config``).

Standard library only: ``tools/trace_summary.py`` reads the traces it gates
without the port installed.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Gates the engine's step tracer.

    The metrics registry is always on — it is a handful of ints and
    callbacks, and ``engine.metrics_snapshot()`` must work regardless.
    Tracing is what this config turns on: with ``trace`` set the engine
    records ring-buffered span events across the
    engine/scheduler/executor/block-manager layers; without a
    ``TelemetryConfig`` at all (``EngineConfig.telemetry is None``) the
    engine holds the shared ``NULL_TRACER`` and every span site is a
    cached no-op.

    ``trace_capacity``: ring-buffer size in events — old events are
    dropped, never the run. ``roofline``: annotate paged decode dispatch
    spans with the analytic ``launch.roofline.decode_step_bound`` tokens/s
    so ``tools/trace_summary.py`` can report the live-vs-bound fraction.
    ``chunk_spans``: synthesize per-chunk prefill/decode spans (one track
    per batch row, seq/adapter ids in args) under each dispatch."""
    trace: bool = True
    trace_capacity: int = 65536
    roofline: bool = True
    chunk_spans: bool = True

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError("TelemetryConfig.trace_capacity must be >= 1")
