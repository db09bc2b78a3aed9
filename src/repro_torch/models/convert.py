"""JAX parameter tree -> PyTorch port parameters.

Input: the VALUE tree of a ``repro`` model (``split_params(...)[0]``),
already on the host as numpy arrays (``jax.device_get``). Each stage
stacks its repeats along a leading ``layers`` axis (``{"l{i}": layer}``
leaves of shape (R, ...)); the port keeps one dict per layer in
``cfg.layer_specs()`` order, so stage ``si``, repeat ``r``, pattern slot
``i`` becomes ``layers[offset(si) + r * len(pattern) + i]``. Weights keep
their JAX layouts ((d, H, hd) projections, (in, out) dense), so no
transposes. Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict

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
    if "lm_head" in jax_values:
        out["lm_head"] = _map(jax_values["lm_head"], leaf)
    layers = []
    for si, (pattern, reps) in enumerate(cfg.stages):
        stage = jax_values["stages"][si]
        for r in range(reps):
            for i in range(len(pattern)):
                layers.append(_map(stage[f"l{i}"], lambda a: leaf(np.asarray(a)[r])))
    out["layers"] = layers
    return out
