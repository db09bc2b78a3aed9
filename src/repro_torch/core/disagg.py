"""Disaggregated prefill/decode serving (survey §IV.B: Splitwise, DistServe,
TetriInfer); a copy of ``repro.core.disagg``.

Two engine instances specialize: the *prefill* instance runs prompt
processing (and emits the first token, as in Splitwise), then the
sequence's KV pages migrate to the *decode* instance, which runs token
generation without ever being stalled by batched prefill work. Transfer
bytes are accounted explicitly: in the port a migration goes host store →
host store → the decode engine's device mirror (``LLMEngine.export_seq`` /
``import_seq``), and counts the global pages, as the reference does.

Each phase takes its own ``EngineConfig``, so prefill and decode may run
at different tensor-parallel layouts (DistServe's per-phase parallelism):
one on one device and the other on a model axis, or two model axes over
one world of ranks. Every rank process builds the same server from the
WHOLE tree (``executor.sharded.engine_params``): a sharded engine takes
its rank's slices cut from it, a whole engine the tree itself, so each
rank's device holds the tree once per layout. Rank slices still serve two
engines of their one layout. A migration payload holds the model's global
pages whatever the layouts: a sharded prefill engine gathers them over its
model group, a sharded decode engine keeps its rank's cut.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.engine import EngineConfig, LLMEngine
from repro_torch.core.executor.sharded import engine_params
from repro_torch.core.metrics import RequestMetrics
from repro_torch.core.request import Request


@dataclasses.dataclass
class DisaggStats:
    migrated: int = 0
    transfer_bytes: int = 0


def _layout(cfg: EngineConfig):
    """The (data, model) mesh an engine runs on; None on one device."""
    sh = cfg.sharding
    return (sh.data_axis, sh.model_axis) if sh is not None and sh.num_devices > 1 else None


class DisaggregatedServer:
    def __init__(self, model, params, *, prefill_cfg: EngineConfig,
                 decode_cfg: EngineConfig):
        pre = engine_params(model, params, prefill_cfg.sharding)
        dec = pre if _layout(prefill_cfg) == _layout(decode_cfg) else \
            engine_params(model, params, decode_cfg.sharding)
        self.prefill_engine = LLMEngine(model, pre, prefill_cfg)
        self.decode_engine = LLMEngine(model, dec, decode_cfg)
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
