"""Input shapes and cache axes per (arch, input shape): the port of
``repro.launch.specs``.

The reference describes each input as a ``jax.ShapeDtypeStruct`` and binds
logical axes to a mesh with ``NamedSharding``; here an input's shape and
dtype is a tensor on the ``meta`` device (no memory), and a rank cuts its
own block of each tensor by ``Rules.pspec`` (``cache_slicer``, as
``core/executor/sharded.py::train_slicer`` cuts parameters). Modality
frontends are stubbed as precomputed embeddings, as in the reference:
``audio_frames`` (B, n_audio_ctx, d) for whisper, ``vision_embeds`` (B,
num_image_tokens, d) for internvl, whose image rows take part of a
sequence's ``seq_len``.

``cache_axes_tree`` names the logical axes of every leaf of
``Model.init_cache``'s list, one dict per layer, as the reference's
``_axes_for_cache_leaf`` names its unstacked (``stacked=False``) tree:
attention K/V ("batch", "kv_seq", "kv_heads", None), a whisper layer's
cross K/V ("batch", None, "kv_heads", None), MLA latents ("batch",
"kv_seq", None), Mamba's conv ("batch", None, "ssm_inner") and ssm
("batch", "ssm_inner", None), every other state ("batch", None, ...).
A tensor-parallel step cuts the xLSTM's states over "lstm_inner" as well
(``tp_cache_axes``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.executor.sharded import rank_block
from repro_torch.models import attention as attn
from repro_torch.models.model import Model, param_axes

# decode caches hold seq_len tokens + headroom for the new token; 512 keeps the
# cache's sequence axis divisible by every mesh-axis extent (context-parallel
# long_500k cuts it over up to 32 ranks)
DECODE_PAD = 512

Axes = Tuple[Optional[str], ...]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """The step's model inputs for the whole batch, as meta tensors:
    ``tokens`` (and ``labels`` for train) (B, text) int32, where an
    internvl sequence's image rows take ``num_image_tokens`` of
    ``seq_len``; the stubbed frontends' ``vision_embeds`` / ``audio_frames``
    in f32 for an f32 config, else bf16; a decode step's ``tokens`` (B, 1)."""
    B, S = shape.global_batch, shape.seq_len
    act = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        text = S
        if cfg.family == "vlm":
            text = S - cfg.num_image_tokens  # image tokens are part of the budget
            specs["vision_embeds"] = _meta((B, cfg.num_image_tokens, cfg.d_model), act)
        if cfg.family == "audio":
            specs["audio_frames"] = _meta((B, cfg.n_audio_ctx, cfg.d_model), act)
        specs["tokens"] = _meta((B, text), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, text), torch.int32)
    else:  # decode
        specs["tokens"] = _meta((B, 1), torch.int32)
    return specs


def batch_axes(cfg: ModelConfig, specs: Dict[str, torch.Tensor]) -> Dict[str, Axes]:
    """Each input's logical axes: rows over "batch", the rest replicated."""
    return {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in specs.items()}


def axes_for_cache_leaf(name: str, ndim: int) -> Axes:
    """The reference's ``_axes_for_cache_leaf`` of an unstacked cache leaf
    by the port's leaf name (``cross_k`` / ``cross_v``: the reference's
    "k" / "v" under its "cross" tree)."""
    if name in ("k", "v") and ndim == 4:
        return ("batch", "kv_seq", "kv_heads", None)
    if name in ("cross_k", "cross_v") and ndim == 4:
        return ("batch", None, "kv_heads", None)
    if name in ("c_kv", "k_pe") and ndim == 3:
        return ("batch", "kv_seq", None)
    if name == "conv" and ndim == 3:
        return ("batch", None, "ssm_inner")
    if name == "ssm" and ndim == 3:
        return ("batch", "ssm_inner", None)
    # xLSTM / sLSTM states and anything else: batch-cut, rest replicated
    return ("batch",) + (None,) * (ndim - 1)


def cache_axes_tree(model: Model, batch: int, max_seq: int, *,
                    window_ring: bool = False) -> Tuple[List[Dict[str, Axes]], list]:
    """(axes per layer leaf, the cache's meta tensors) of
    ``model.init_cache(batch, max_seq, window_ring=...)``, drawn on the
    meta device."""
    template = Model(model.cfg, device="meta").init_cache(batch, max_seq,
                                                          window_ring=window_ring)
    axes = [{name: axes_for_cache_leaf(name, t.ndim) for name, t in layer.items()}
            for layer in template]
    return axes, template


def param_specs(model: Model, rules, max_seq: int = 0):
    """(meta tensor tree of ``model.init``'s parameters, their partition
    specs under ``rules``): no allocation."""
    values = Model(model.cfg, device="meta").init(0, max_seq)

    def specs(v, a):
        if isinstance(v, dict):
            return {k: specs(v[k], a[k]) for k in v}
        if isinstance(v, list):
            return [specs(x, y) for x, y in zip(v, a, strict=True)]
        return rules.pspec(a, tuple(v.shape))
    return values, specs(values, param_axes(model.cfg))


def _parts(part) -> tuple:
    return () if part is None else ((part,) if isinstance(part, str) else tuple(part))


def cache_slicer(model: Model, mesh, rules, axes: List[Dict[str, Axes]], device=None):
    """``place(i, layer)`` for one rank of ``mesh``: the rank's block of
    each leaf of layer ``i`` of a cache (``Model.init_cache``'s list), cut
    by ``rules.pspec`` of its axes (``cache_axes_tree``), as a tensor of
    its own on ``device`` (the mesh's by default); a leaf the rank holds
    whole is the given tensor itself, moved to ``device``. A window ring
    (``attention.window_ring_applies`` under ``rules``) is never cut along
    its sequence: under context parallelism every rank holds it whole."""
    device = mesh.device if device is None else torch.device(device)
    coords = mesh.coords()

    def place(i, layer):
        spec_i = model.specs[i]
        out = {}
        for name, t in layer.items():
            a = axes[i][name]
            if name in ("k", "v") and attn.window_ring_applies(model.cfg, spec_i,
                                                             t.shape[1], rules):
                a = tuple(None if x == "kv_seq" else x for x in a)
            spec = rules.pspec(a, tuple(t.shape))
            if all(mesh.shape.get(x, 1) == 1 for part in spec for x in _parts(part)):
                out[name] = t.to(device)  # the rank holds the leaf whole
                continue
            for dim, part in enumerate(spec):
                t = rank_block(t, dim, _parts(part), mesh.shape, coords)
            # a copy, never a view: a view would keep the whole leaf alive
            out[name] = t.to(device).clone()
        return out
    return place


def shard_cache(model: Model, cache: list, mesh, rules, axes, device=None) -> list:
    """The rank's block of every layer of a whole cache."""
    place = cache_slicer(model, mesh, rules, axes, device)
    return [place(i, layer) for i, layer in enumerate(cache)]


def tp_cache_axes(model: Model, axes: List[Dict[str, Axes]]) -> List[Dict[str, Axes]]:
    """``axes`` (``cache_axes_tree``) with the xLSTM's states cut over
    "lstm_inner", as a tensor-parallel step cuts them (the rank's heads'
    ``C``, ``n``, ``m`` and its channels' ``conv`` for an mLSTM, its heads'
    slices of ``c``, ``n``, ``h`` and ``m`` for an sLSTM); the reference
    names them replicated, its XLA gathering what a layer needs. Mamba's
    states are already cut over "ssm_inner"."""
    out = []
    for spec, layer in zip(model.specs, axes):
        layer = dict(layer)
        if spec.mixer in ("mlstm", "slstm"):
            for name, a in layer.items():
                if name != "conv" or spec.mixer == "mlstm":
                    # the mLSTM's conv (B, 3, di) on its channels, every other
                    # state on its first axis after the batch (heads, or d)
                    at = 2 if name == "conv" else 1
                    layer[name] = a[:at] + ("lstm_inner",) + a[at + 1:]
        out.append(layer)
    return out


def rank_cache(model: Model, batch: int, max_seq: int, mesh, rules, *,
               window_ring: bool = False, fill=None, axes=None) -> list:
    """This rank's block of ``model.init_cache(batch, max_seq,
    window_ring=...)``, made layer by layer: each whole layer is built on
    the model's device, ``fill(i, layer)`` (where given) writes it in
    place, and the rank keeps its block (``cache_slicer``) before the next
    layer is made, so at most one whole layer lives on the way. ``axes``:
    the leaves' axes (``cache_axes_tree``'s by default)."""
    if axes is None:
        axes, _ = cache_axes_tree(model, batch, max_seq, window_ring=window_ring)
    place = cache_slicer(model, mesh, rules, axes)

    def one(i, layer):
        if fill is not None:
            fill(i, layer)
        return place(i, layer)
    return model.init_cache(batch, max_seq, window_ring=window_ring, place=one)
