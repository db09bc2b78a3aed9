"""Adapter registry: host-side LoRA adapter weights, one entry per tenant.

The port of ``repro.core.lora.registry``. The registry is the "disk tier"
of the multi-LoRA story: it holds every registered adapter's A/B factors as
host numpy trees (in a real deployment these come from checkpoint files).
The ``PagedAdapterStore`` faults adapters from here into device table slots
on demand.

An adapter keeps the JAX package's stage-tree layout, so the same tree
serves both packages:

    tuple over stages of {"l{i}": {site: {"a": (R, Din, rank),
                                          "b": (R, rank, Dout)}}}

with sites ``wq/wk/wv/wo`` on every attention layer and ``w1/w2`` on every
MLP layer (flattened head dims: Dout = H * head_dim for ``wq`` etc.);
``models/convert.py::convert_adapter`` unstacks it into the port's
per-layer order.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.lora.config import LoRAConfig
from repro_torch.models.common import is_glu


def lora_layer_sites(cfg: ModelConfig, spec: LayerSpec) -> List[Tuple[str, int, int]]:
    """(site name, Din, Dout) for one layer: the attention projections, and
    MLP w1/w2 where the layer's ff is a plain MLP."""
    assert spec.mixer == "attn", "LoRA serving needs a pure-attention stack"
    d, f = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sites = [("wq", d, H * hd), ("wk", d, KV * hd), ("wv", d, KV * hd),
             ("wo", H * hd, d)]
    if spec.ff == "mlp":
        out1 = 2 * f if is_glu(cfg.activation) else f
        sites += [("w1", d, out1), ("w2", f, d)]
    return sites


def make_adapter(cfg: ModelConfig, lora: LoRAConfig, seed: int) -> Tuple:
    """A random adapter (the serving stand-in for a fine-tuned checkpoint),
    drawn from ``np.random.default_rng(seed)`` in the JAX package's order,
    so the same seed gives the same bytes (under numpy 2 the division by
    ``np.sqrt`` promotes them to float64, as in the JAX package; the store's
    device tables are f32). B is NON-zero on purpose: a zero adapter is
    indistinguishable from the base model."""
    rng = np.random.default_rng(seed)
    r = lora.rank
    stages = []
    for pattern, reps in cfg.stages:
        layers = {}
        for i, spec in enumerate(pattern):
            sites = {}
            for name, din, dout in lora_layer_sites(cfg, spec):
                sites[name] = {
                    "a": rng.standard_normal((reps, din, r)).astype(np.float32)
                    / np.sqrt(din),
                    "b": rng.standard_normal((reps, r, dout)).astype(np.float32)
                    / np.sqrt(r),
                }
            layers[f"l{i}"] = sites
        stages.append(layers)
    return tuple(stages)


def adapter_nbytes(cfg: ModelConfig, lora: LoRAConfig) -> int:
    """Bytes of one adapter (f32 factors): what the store charges against
    the block pool when renting pages."""
    total = 0
    for pattern, reps in cfg.stages:
        for spec in pattern:
            for _, din, dout in lora_layer_sites(cfg, spec):
                total += 4 * reps * lora.rank * (din + dout)
    return total


# where each site's weight lives in a layer's parameter dict
_SITE_GROUP = {"wq": "mixer", "wk": "mixer", "wv": "mixer", "wo": "mixer",
               "w1": "ff", "w2": "ff"}


def merge_adapter(params, adapter, cfg: ModelConfig, lora: LoRAConfig):
    """Dense swap-merge baseline: fold ``A @ B * (alpha / rank)`` into the
    base weights, as a single-tenant deployment would serve them. Returns
    new per-layer dicts (the base params are not touched). The delta and
    the sum are the JAX package's numpy expressions, per stage (in the
    factors' precision, over the weight upcast to f32), so both packages
    fold the same bytes; the sum is cast back to the weight's dtype."""
    scale = lora.alpha / lora.rank
    layers = [dict(layer) for layer in params["layers"]]
    li = 0
    for si, (pattern, reps) in enumerate(cfg.stages):
        deltas = {}
        for i, spec in enumerate(pattern):
            for name, _, _ in lora_layer_sites(cfg, spec):
                ab = adapter[si][f"l{i}"][name]
                deltas[i, name] = np.einsum("rdk,rko->rdo", ab["a"], ab["b"]) * scale
        for r in range(reps):
            for i, spec in enumerate(pattern):
                layer = layers[li]
                for name, _, _ in lora_layer_sites(cfg, spec):
                    group = layer[_SITE_GROUP[name]] = dict(layer[_SITE_GROUP[name]])
                    site = group[name] = dict(group[name])
                    w = site["w"]
                    merged = (w.float().cpu().numpy()
                              + deltas[i, name][r].reshape(tuple(w.shape)))
                    site["w"] = torch.from_numpy(merged).to(w.dtype).to(w.device)
                li += 1
    return dict(params, layers=layers)


class AdapterRegistry:
    """adapter_id -> host adapter tree. Read-only "disk": the per-engine
    store is the cache."""

    def __init__(self, cfg: ModelConfig, lora: LoRAConfig):
        self.cfg = cfg
        self.lora = lora
        self._adapters: Dict[str, Tuple] = {}

    def register(self, adapter_id: str, weights) -> None:
        self._adapters[adapter_id] = weights

    def get(self, adapter_id: str):
        if adapter_id not in self._adapters:
            raise KeyError(
                f"adapter {adapter_id!r} not registered (known: "
                f"{sorted(self._adapters)})")
        return self._adapters[adapter_id]

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._adapters

    def ids(self) -> List[str]:
        return sorted(self._adapters)
