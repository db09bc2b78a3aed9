"""GatheredRunner: the gather -> ``model.extend`` -> scatter backend.

The port of ``repro.core.executor.gathered``. Each step gathers the
scheduled sequences' pages from the host store into dense (B, W, KV, D)
windows per layer (``PagedModelState.gather``), uploads them to the
model's device, runs ``model.extend`` over the whole (B, C) batch
(decodes are chunks of length 1 — SplitFuse unified batching; C is the
longest chunk, not padded further), then scatters the newly written
positions back to their pages. Every prompt's first chunk runs its
attention through the ``flash_prefill`` kernel on the card (fresh rows,
``models/attention.py::attn_extend``).

It is the parity reference of the paged backend and the only backend for
stacks without a paged family: sliding-window attention (starcoder2-3b).
All window traffic is charged to ``PagedModelState.host_copy_bytes``.
Spans (with a tracer installed): ``gather`` (the host-side window copy),
``window_upload`` (host -> device) and ``scatter`` (the written slots back
to the host store). ``steps`` counts executed batches, ``prefill_steps``
those holding at least one fresh row (``cache_len == 0``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor.base import ExecBatch, ModelRunner, lora_arg
from repro_torch.core.executor.state import PagedModelState
from repro_torch.core.telemetry import NULL_TRACER


class GatheredRunner(ModelRunner):
    name = "gathered"

    def __init__(self, model, params, engine_cfg, store: PagedModelState):
        self.model = model
        self.params = params
        self.cfg = engine_cfg
        self.store = store
        self.device = model.device
        # the engine swaps in a live StepTracer to record spans
        self.trace = NULL_TRACER
        self.steps = 0
        self.prefill_steps = 0

    def execute(self, batch: ExecBatch) -> np.ndarray:
        chunks = batch.chunks
        with self.trace.span("gather", track="executor"):
            window = self.store.gather(batch.tables)
        with self.trace.span("window_upload", track="executor"):
            cache = [{n: t.to(self.device) for n, t in layer.items()} for layer in window]
        logits, new_cache = self.model.extend(
            self.params, torch.from_numpy(batch.tokens).to(self.device), cache,
            torch.from_numpy(batch.cache_lens).to(self.device),
            lora=lora_arg(batch.lora, device=self.device))
        with self.trace.span("scatter", track="executor"):
            self.store.scatter(new_cache, batch.tables, [c.start for c in chunks],
                               [c.length for c in chunks])
        self.steps += 1
        self.prefill_steps += bool((batch.cache_lens == 0).any())
        return logits.float().cpu().numpy()
