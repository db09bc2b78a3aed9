"""JAX parameter tree -> PyTorch port parameters.

Input: the VALUE tree of a ``repro`` model (``split_params(...)[0]``),
already on the host as numpy arrays (``jax.device_get``). Each stage
stacks its repeats along a leading ``layers`` axis (``{"l{i}": layer}``
leaves of shape (R, ...)); the port keeps one dict per layer in
``cfg.layer_specs()`` order, so stage ``si``, repeat ``r``, pattern slot
``i`` becomes ``layers[offset(si) + r * len(pattern) + i]``. Weights keep
their JAX layouts ((d, H, hd) projections, (in, out) dense), so no
transposes, and their dtypes (a Mamba layer's f32 ``A_log`` and ``D``
beside bf16 weights). The state mixers' trees (Mamba ``conv_w`` /
``conv_b``, ``x_proj``, ``dt_proj`` with its bias; mLSTM ``w_if``,
``head_norm``; sLSTM ``r``, ``group_norm``, ``ffn_*``) unstack like any
other, and a layer without a feed-forward (xLSTM's) has no ``norm2`` and
no ``ff``. A whisper tree's learned ``pos_embed`` comes over as it is,
each decoder layer's ``cross_norm`` and ``cross`` with the layer, and its
encoder (one stacked stage of ``{"l0": layer}``) becomes ``{"layers":
[...], "final_norm"}``. DeepSeek-V3's multi-token prediction block
``mtp`` (one unstacked layer and its projections and norms) comes over as
it is. The same function converts a gradient tree of the same structure
(``jax.grad`` of the value tree). ``convert_adapter`` unstacks a LoRA adapter's stage tree the
same way. Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def convert_params(cfg: ModelConfig, jax_values: Dict[str, Any]) -> Dict[str, Any]:
    """``jax_values``: numpy value tree of ``repro.models.build_model(cfg)``
    params -> CPU tensors of the same dtypes."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes: no torch mapping
            return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
        return torch.tensor(a)

    out: Dict[str, Any] = {"embed": leaf(jax_values["embed"]),
                           "final_norm": _map(jax_values["final_norm"], leaf)}
    for name in ("lm_head", "pos_embed", "mtp"):
        if name in jax_values:
            out[name] = _map(jax_values[name], leaf)
    layers = []
    for si, (pattern, reps) in enumerate(cfg.stages):
        stage = jax_values["stages"][si]
        for r in range(reps):
            for i in range(len(pattern)):
                layers.append(_map(stage[f"l{i}"], lambda a: leaf(np.asarray(a)[r])))
    out["layers"] = layers
    if "encoder" in jax_values:
        enc = jax_values["encoder"]
        out["encoder"] = {
            "layers": [_map(enc["stages"][0]["l0"], lambda a: leaf(np.asarray(a)[r]))
                       for r in range(cfg.encoder_layers)],
            "final_norm": _map(enc["final_norm"], leaf)}
    return out


def convert_adapter(cfg: ModelConfig, tree) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """A LoRA adapter in the JAX package's stage-tree layout (``tuple over
    stages of {"l{i}": {site: {"a": (R, Din, r), "b": (R, r, Dout)}}}``, as
    ``core/lora/registry.py::make_adapter`` makes it) -> a list over layers,
    in ``cfg.layer_specs()`` order, of ``{site: {"a": (Din, r), "b": (r,
    Dout)}}`` numpy arrays (views of the tree's)."""
    layers = []
    for si, (pattern, reps) in enumerate(cfg.stages):
        stage = tree[si]
        for r in range(reps):
            for i in range(len(pattern)):
                layers.append({name: {k: np.asarray(v)[r] for k, v in ab.items()}
                               for name, ab in stage[f"l{i}"].items()})
    return layers
