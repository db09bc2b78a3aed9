"""GatheredRunner: the gather -> ``model.extend`` -> scatter backend.

The port of ``repro.core.executor.gathered``. Each step gathers the
scheduled sequences' pages from the host store into dense (B, W) windows
per cache leaf (``PagedModelState.gather``), uploads them to the model's
device, runs ``model.extend`` over the whole (B, C) batch (decodes are
chunks of length 1 — SplitFuse unified batching; C is the longest chunk,
not padded further), then scatters the newly written positions back to
their pages. Every prompt's first chunk runs its attention through the
``flash_prefill`` kernel on the card (fresh rows of attention layers,
``models/attention.py::attn_extend``); MLA layers attend plainly. A
state-mixer stack's per-sequence states come up from their slots beside
the windows (``batch.slots``) and go back whole after the step, inside the
same ``window_upload`` and ``scatter`` spans; the engine runs such stacks
one chunk length per dispatch, so every row's states advance over real
tokens only.

It is the parity reference of the paged backend and the only backend for
stacks without a paged family (sliding-window and chunked attention, MLA,
state mixers, whisper's encoder-decoder), for every chunk that carries
modality extras (``batch.extras``: audio frames, image rows; they go up to
the model's device in its activation dtype in an ``extras_upload`` span,
and ``Model.extend`` runs the encoder or splices the image), and for
``kv_quant`` configs the quantized page layout cannot hold (their
round trip happens in ``scatter``). KIVI-quantized stores reach the model
through ``dequantize_window``: the distinct blocks' codes, f16 planes and
the staging pages of blocks still filling are uploaded, then dequantized
on the device by ``dequantize_kv_pages`` — the CUDA unpack kernel on the
card, one launch per leaf name ("k", "v"), so 2 launches a step; a
fp-store step launches none. The scatter's page fills launch the pack
(``quantize_pages``, one launch per grouping axis per row that fills a
page; ``PagedModelState._quant_write_group``).

All window traffic is charged to ``PagedModelState.host_copy_bytes`` as the
reference charges it (the fp window, quantized or not);
``window_upload_bytes`` counts what really crosses to the device. Spans
(with a tracer installed): ``gather`` (the host-side copy), ``window_upload``
(host -> device, and the dequantization of a quantized window) and
``scatter`` (the written slots back to the host store). ``steps`` counts
executed batches, ``prefill_steps`` those holding at least one fresh row
(``cache_len == 0``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.executor.base import ExecBatch, ModelRunner, lora_arg
from repro_torch.core.executor.state import PagedModelState
from repro_torch.core.telemetry import NULL_TRACER
from repro_torch.kernels.kv_quant import dequantize_kv_pages


def dequantize_window(parts: dict, device, dtype) -> List[Dict[str, torch.Tensor]]:
    """``PagedModelState.gather_quantized``'s parts -> per-layer {"k", "v"}
    (B, W, KV, D) windows in ``dtype`` on ``device``, and the state leaves
    of state-mixer layers: per leaf name, the codes and planes of every
    attention layer's distinct blocks go up in one copy each and are
    dequantized in one ``dequantize_kv_pages`` call, the staging pages of
    blocks still filling overwrite theirs, and the table (``inv``) spreads
    the blocks over each row's window. Bit-equal to the host
    dequantization of ``PagedModelState.gather``."""
    inv = parts["inv"].to(device)
    B, nb = inv.shape
    W = parts["W"]
    out: List[Dict[str, torch.Tensor]] = [
        {n: t.to(device) for n, t in layer.items()} for layer in parts["state"]]
    for name in ("k", "v"):
        p = {k: t.to(device) for k, t in parts[name].items()}
        L, KV, n, P, D = p["codes"].shape
        pages = dequantize_kv_pages(
            p["codes"].reshape(-1, P, D), p["scale"].reshape((-1,) + p["scale"].shape[3:]),
            p["zero"].reshape((-1,) + p["zero"].shape[3:]), out_dtype=dtype
        ).reshape(L, KV, n, P, D)
        if len(parts["open"]):
            pages[:, :, parts["open"].to(device)] = p["stage"]
        win = pages[:, :, inv]  # (L, KV, B, nb, P, D)
        for j, layer in enumerate(parts["layers"]):
            out[layer][name] = win[j].permute(1, 2, 3, 0, 4).reshape(
                B, nb * P, KV, D)[:, :W]
    return out


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
        self.window_upload_bytes = 0

    def _upload(self, tensors) -> None:
        self.window_upload_bytes += sum(t.numel() * t.element_size() for t in tensors)

    def execute(self, batch: ExecBatch) -> np.ndarray:
        chunks = batch.chunks
        store = self.store
        with self.trace.span("gather", track="executor"):
            window = store.gather_quantized(batch.tables, batch.slots) \
                if store.quantized else store.gather(batch.tables, batch.slots)
        with self.trace.span("window_upload", track="executor"):
            if store.quantized:
                self._upload([window["inv"], window["open"]] + [
                    t for name in ("k", "v") for t in window[name].values()] + [
                    t for layer in window["state"] for t in layer.values()])
                cache = dequantize_window(window, self.device, store.dtype)
            else:
                self._upload([t for layer in window for t in layer.values()])
                cache = [{n: t.to(self.device) for n, t in layer.items()}
                         for layer in window]
        extras = None
        if batch.extras is not None:
            with self.trace.span("extras_upload", track="executor"):
                extras = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, self.store.dtype) for k, v in batch.extras.items()}
        logits, new_cache = self.model.extend(
            self.params, torch.from_numpy(batch.tokens).to(self.device), cache,
            torch.from_numpy(batch.cache_lens).to(self.device),
            lora=lora_arg(batch.lora, device=self.device), batch=extras)
        with self.trace.span("scatter", track="executor"):
            store.scatter(new_cache, batch.tables, [c.start for c in chunks],
                          [c.length for c in chunks], quant=self.cfg.kv_quant,
                          slots=batch.slots)
        self.steps += 1
        self.prefill_steps += bool((batch.cache_lens == 0).any())
        return logits.float().cpu().numpy()
