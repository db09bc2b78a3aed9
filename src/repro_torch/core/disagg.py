"""Disaggregated prefill/decode serving (survey §IV.B: Splitwise, DistServe,
TetriInfer); a copy of ``repro.core.disagg``.

Two engine instances specialize: the *prefill* instance runs prompt
processing (and emits the first token, as in Splitwise), then the
sequence's KV pages migrate to the *decode* instance, which runs token
generation without ever being stalled by batched prefill work. Both engines
are built on the one model and params handed in, so the weights sit on the
device once. Transfer bytes are accounted explicitly: in the port a
migration goes host store → host store → the decode engine's device mirror
(``LLMEngine.export_seq`` / ``import_seq``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.engine import EngineConfig, LLMEngine
from repro_torch.core.metrics import RequestMetrics
from repro_torch.core.request import Request


@dataclasses.dataclass
class DisaggStats:
    migrated: int = 0
    transfer_bytes: int = 0


class DisaggregatedServer:
    def __init__(self, model, params, *, prefill_cfg: EngineConfig,
                 decode_cfg: EngineConfig):
        self.prefill_engine = LLMEngine(model, params, prefill_cfg)
        self.decode_engine = LLMEngine(model, params, decode_cfg)
        self.stats = DisaggStats()

    def add_request(self, req: Request):
        return self.prefill_engine.add_request(req)

    def _migrate_ready(self) -> None:
        """Move sequences that have completed prefill (first token emitted)."""
        ready = [s for s in list(self.prefill_engine.scheduler.running)
                 if not s.in_prefill and s.generated]
        for seq in ready:
            payload = self.prefill_engine.export_seq(seq.request_id)
            self.decode_engine.import_seq(payload)
            self.stats.migrated += 1
            self.stats.transfer_bytes += self.decode_engine.last_import_bytes

    def step(self) -> None:
        self.prefill_engine.step()
        self._migrate_ready()
        self.decode_engine.step()

    def has_work(self) -> bool:
        return (self.prefill_engine.scheduler.has_work()
                or self.decode_engine.scheduler.has_work())

    def run(self, max_steps: int = 10_000) -> List[RequestMetrics]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return self.decode_engine.finished + self.prefill_engine.finished

    @property
    def seqs(self) -> Dict[str, object]:
        return {**self.prefill_engine.seqs, **self.decode_engine.seqs}
