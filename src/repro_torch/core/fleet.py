"""Multi-instance serving fleet with live request migration (survey §V.A,
Llumnix); a copy of ``repro.core.fleet``. Requests are routed to the
least-loaded engine instance at admission and *rescheduled across instances
at runtime*: the engine's export/import KV migration (the same primitive
the disaggregated server uses) implements Llumnix's live migration, so
rebalancing never recomputes KV. Every instance is built on the one model
and params handed in.

Policies unified by one mechanism (as in the paper): load balancing,
de-fragmentation (drain a mostly-idle instance), and priority make-room.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.engine import EngineConfig, LLMEngine
from repro_torch.core.metrics import RequestMetrics
from repro_torch.core.request import Request, SeqStatus


@dataclasses.dataclass
class FleetStats:
    migrations: int = 0
    migrated_bytes: int = 0


class ServingFleet:
    def __init__(self, model, params, *, instances: int,
                 engine_cfg: EngineConfig, rebalance_threshold: float = 0.25,
                 adapter_affinity: float = 0.1):
        self.engines: List[LLMEngine] = [
            LLMEngine(model, params, engine_cfg) for _ in range(instances)]
        self.threshold = rebalance_threshold
        # LoRA-aware routing: an instance that already holds the request's
        # adapter resident scores this much "emptier" than raw block usage
        # says — avoiding a duplicate adapter load (and a possible eviction)
        # unless the load gap outweighs it
        self.adapter_affinity = adapter_affinity
        self.stats = FleetStats()

    # ------------------------------------------------------------------
    def register_adapter(self, adapter_id: str, weights) -> None:
        """Register a LoRA adapter fleet-wide: the host registry is shared
        "disk", so every instance can fault the adapter in — which is what
        lets live migration move an adapter-bound sequence anywhere."""
        for eng in self.engines:
            eng.register_adapter(adapter_id, weights)

    # ------------------------------------------------------------------
    def _load(self, eng: LLMEngine) -> float:
        """Instance load = fraction of KV blocks in use (Llumnix's memory-
        pressure signal). Resident LoRA adapters rent pool pages, so they
        are part of this signal. Read through the engine's metrics
        registry — the router consumes the same telemetry surface the serve
        report reads."""
        return eng.metrics.value("block_manager.utilization")

    def least_loaded(self) -> LLMEngine:
        return min(self.engines, key=self._load)

    def route(self, req: Request) -> LLMEngine:
        """Least-loaded, tilted by adapter affinity."""

        def score(eng: LLMEngine) -> float:
            s = self._load(eng)
            if req.adapter_id is not None and eng.adapters is not None \
                    and eng.adapters.is_loaded(req.adapter_id):
                s -= self.adapter_affinity
            return s

        return min(self.engines, key=score)

    def add_request(self, req: Request):
        return self.route(req).add_request(req)

    # ------------------------------------------------------------------
    def rebalance(self) -> int:
        """Migrate decoding sequences from the most- to the least-loaded
        instance while their load gap exceeds the threshold. Returns the
        number of migrations performed."""
        moved = 0
        for _ in range(8):  # bounded work per call
            src = max(self.engines, key=self._load)
            dst = min(self.engines, key=self._load)
            if src is dst or self._load(src) - self._load(dst) < self.threshold:
                break
            # migrate the most recently arrived decoding sequence (cheapest
            # to move: smallest KV) that is not mid-prefill
            cands = [s for s in src.scheduler.running
                     if not s.in_prefill and s.status is SeqStatus.RUNNING]
            if not cands:
                break
            victim = max(cands, key=lambda s: s.request.arrival_time)
            payload = src.export_seq(victim.request_id)
            dst.import_seq(payload)
            self.stats.migrations += 1
            self.stats.migrated_bytes += dst.last_import_bytes
            moved += 1
        return moved

    # ------------------------------------------------------------------
    def step(self) -> None:
        for eng in self.engines:
            eng.step()
        self.rebalance()

    def has_work(self) -> bool:
        return any(e.scheduler.has_work() for e in self.engines)

    def run(self, max_steps: int = 10_000) -> List[RequestMetrics]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        out: List[RequestMetrics] = []
        for e in self.engines:
            out.extend(e.finished)
        return out

    @property
    def seqs(self):
        merged = {}
        for e in self.engines:
            merged.update(e.seqs)
        return merged

    def load_gap(self) -> float:
        loads = [self._load(e) for e in self.engines]
        return max(loads) - min(loads)
