"""Unified metrics registry: typed counters / gauges / histograms.

One registry per engine; every subsystem's stats object registers into it
(block manager occupancy, prefix-cache hit tiers, LoRA store faults, spec
acceptance, runner byte counters, per-backend dispatch counts) so
``engine.metrics_snapshot()`` is the single source of truth consumed by
``serve.py``, ``fleet._load`` and the bench report machinery
(docs/observability.md). jax-free by construction.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

Number = Union[int, float]


class Counter:
    """Monotonic count, incremented by the instrumented code path."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def read(self) -> Number:
        return self.value


class Gauge:
    """Point-in-time value, read through a zero-arg callback at snapshot
    time — existing stats dataclasses stay the owners of their fields and
    the registry never holds stale copies."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str, fn: Callable[[], Number]):
        self.name = name
        self.fn = fn

    def read(self) -> Number:
        return self.fn()


class Histogram:
    """Streaming summary (count/sum/min/max/mean) — no bucket storage, so
    observing on a hot path costs four float ops."""

    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: Number) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def read(self) -> Dict[str, Number]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count, "min": self.min,
                "max": self.max}


class MetricsRegistry:
    """Namespaced instruments ("subsystem.metric") with one flat
    ``snapshot()``. Registering an existing name returns the existing
    instrument (idempotent), mismatched kinds raise."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _register(self, name: str, kind, factory):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}")
            return inst
        inst = factory()
        self._instruments[name] = inst
        return inst

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter, lambda: Counter(name))

    def gauge(self, name: str, fn: Callable[[], Number]) -> Gauge:
        return self._register(name, Gauge, lambda: Gauge(name, fn))

    def histogram(self, name: str) -> Histogram:
        return self._register(name, Histogram, lambda: Histogram(name))

    def value(self, name: str) -> Number:
        """Read one instrument without materializing a full snapshot
        (``fleet._load`` polls this per routing decision)."""
        inst = self._instruments[name]
        out = inst.read()
        if isinstance(out, dict):  # histogram: the mean is "the value"
            return out["mean"]
        return out

    def snapshot(self) -> Dict[str, Number]:
        """Flat {name: number} over every instrument; histograms expand to
        ``name.count`` / ``name.sum`` / ``name.mean`` / ``name.min`` /
        ``name.max``. JSON-serializable by construction."""
        out: Dict[str, Number] = {}
        for name, inst in sorted(self._instruments.items()):
            v = inst.read()
            if isinstance(v, dict):
                for k, sub in v.items():
                    out[f"{name}.{k}"] = sub
            else:
                out[name] = v
        return out
