"""Step tracer: ring-buffered span events across the serving stack.

``StepTracer.span(...)`` is a context manager recording one complete
span (name, track, start, duration, args) into a bounded deque; spans
nest across the engine -> scheduler -> executor -> block-manager layers
simply by nesting their intervals on a track. ``NULL_TRACER`` is the
shared disabled instance: ``span()`` / ``event()`` / ``record()`` all
return a cached singleton no-op, so an engine whose ``trace`` is left at
``NULL_TRACER`` pays one attribute load + one call per site, allocates no
span or event objects, and buffers nothing. A copy of
``repro.core.telemetry.tracer``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional


class SpanEvent:
    """One recorded span (dur in microseconds) or instant (dur None)."""

    __slots__ = ("name", "track", "ts", "dur", "args")

    def __init__(self, name: str, track: str, ts: float,
                 dur: Optional[float], args: Optional[dict]):
        self.name = name
        self.track = track
        self.ts = ts
        self.dur = dur
        self.args = args


class _Span:
    """Live context-manager handle; appends a SpanEvent on exit. ``args``
    is mutable until then — callers may attach values discovered inside
    the span (e.g. the number of tokens a plan produced)."""

    __slots__ = ("_tracer", "name", "track", "args", "_t0")

    def __init__(self, tracer: "StepTracer", name: str, track: str,
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr.events.append(SpanEvent(self.name, self.track, self._t0,
                                   tr.now() - self._t0, self.args or None))
        return False


class StepTracer:
    """Bounded span recorder. Timestamps are microseconds since the
    tracer's construction (``time.perf_counter`` based — monotonic,
    wall-clock-drift-free), which is exactly the Chrome trace-event
    ``ts`` unit so export is a straight copy."""

    enabled = True

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Microseconds since tracer construction."""
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name: str, track: str = "engine", **args) -> _Span:
        """Context manager recording one complete span on ``track``."""
        return _Span(self, name, track, args)

    def event(self, name: str, track: str = "engine", **args) -> None:
        """Record an instant event (preempt, lora_fault, migrate, ...)."""
        self.events.append(SpanEvent(name, track, self.now(), None,
                                     args or None))

    def record(self, name: str, track: str, ts: float, dur: float,
               **args) -> None:
        """Record a synthesized span with an explicit interval — used for
        per-chunk prefill/decode rows that share their dispatch's time."""
        self.events.append(SpanEvent(name, track, ts, dur, args or None))

    def clear(self) -> None:
        self.events.clear()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op returning a shared object.
    ``events`` is an empty tuple so exporters/tests can treat both
    tracers uniformly."""

    enabled = False
    events = ()

    def now(self) -> float:
        return 0.0

    def span(self, name: str, track: str = "engine", **args) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, track: str = "engine", **args) -> None:
        return None

    def record(self, name: str, track: str, ts: float, dur: float,
               **args) -> None:
        return None

    def clear(self) -> None:
        return None


NULL_TRACER = NullTracer()
