"""Model factory of the PyTorch port: attention and multi-head latent
attention (MLA) decoders with a dense MLP or a routed MoE feed-forward, on
the paged and gathered serving paths, stacks with state mixers (Mamba:
jamba-v0.1-52b; mLSTM and sLSTM: xlstm-1.3b) and whisper's
encoder-decoder on the gathered path, and internvl's image splice.

The twin of ``repro.models.model.build_model``: ``forward`` (the
full-sequence training forward,
with DeepSeek-V3's multi-token prediction head ``mtp_head`` and the MoE
layers' aux loss; each layer under ``torch.utils.checkpoint``),
``embed_tokens``, ``head``, ``init_cache`` / ``extend`` (a chunk appended to
a gathered ``(B, W, KV, D)`` cache window: prefill, chunked prefill, mixed
batches, decode as chunks of one), and, where ``paged_decode_supported``
holds (every layer global attention, MLP or MoE), ``decode_paged`` (one
token) and ``extend_paged`` (chunked prefill / ragged mixed batches) and
``verify_paged`` (C real positions per row: speculative verify and draft
catch-up); on other stacks (sliding-window attention: starcoder2-3b;
chunked attention: llama4-scout; MLA: deepseek-v3; state mixers) those
three are None, as in the reference. ``decode`` (one token over the
contiguous cache of ``init_cache``, every family: the reference's only
caller is its ``build_step``, ``launch/steps.py`` here) writes each
attention layer's K/V in place, runs MLA's absorbed form and the state
mixers' one-token step; ``init_cache(..., window_ring=True)`` gives a
window layer a ring of ``sliding_window + 512`` slots (a ``RingCache``),
and ``decode``'s ``cp`` cuts each attention layer's cache and each MLA
layer's latents over a group of ranks (context parallelism,
``attention.attn_decode``, ``mla.mla_decode``).
A MoE layer's feed-forward is ``moe.moe_apply`` at capacity factor 2.0, as
the reference serves it, with its aux loss dropped (1.25 and the aux loss
kept in ``forward``, as the reference trains it). Parameters are plain
dicts: ``{"embed": (V, d), "final_norm": {...}, ["lm_head": {"w": (d, V)}],
"layers": [layer, ...]}`` with one dict
per layer in ``cfg.layer_specs()`` order — the JAX package stacks repeats
along a leading axis instead; ``models/convert.py`` unstacks them.

Pages are a list over layers of ``{"k", "v"}`` tensors in kernel layout
(KV, NB, P, D), written in place — or, for KIVI-quantized stores, of
``{"codes", "scale", "zero", "tail"}`` dicts that the step reads and does
not write (``attention._attn_chunk_quant``). A gathered cache is a list
over layers of windows, also written in place: ``{"k", "v"}`` (B, W, KV, D)
for attention, ``{"c_kv", "k_pe"}`` (B, W, r) and (B, W, rope) latents for
MLA, and for a state mixer its per-sequence state, (B,) + the leaf's
shape, which ``extend`` replaces by the state after the chunk
(``cache_leaf_shapes``). A layer whose ``ff`` is "none" (xLSTM's) has no
``norm2`` and no ``ff``. Every step
takes an optional multi-tenant LoRA operand whose per-row deltas go through
``bgmv_add`` at the six adapter sites of a layer (wq, wk, wv, wo, w1, w2),
added in place to the projections' outputs in four launches: wq/wk/wv
together, wo, w1, w2. A MoE layer has the attention sites only (its experts
are not adapted), so two launches. On a shard-local config
(``cfg.tp_axis``: the sharded paged runner's) the paged steps take ``tp``,
the rank's model group, and each layer all-reduces its attention output
(and its MLP output when ``cfg.tp_ff_sharded``) over it; ``param_axes``
names each parameter's logical axes, by which that runner splits them and
the sharded train step cuts them (``forward``'s ``shard``: a rank's
``train/sharding.py`` plan, FSDP slices gathered per layer; heads, inner
channels, hidden units, experts and vocab over the model group, for every
family).
``extend`` and ``decode`` take ``shard``, a rank's plan of a
tensor-parallel prefill or decode step (``core/executor/sharded.py::
StepSharding``): every family's layers run shard-locally as ``forward``'s
do under a training plan, each width the model group holds whole run
whole (``sharding/collectives.py::cut_group``).
``build_model(cfg, device=...)`` runs on ``cuda`` unless asked for ``cpu``
and raises when CUDA is asked for and absent.

Modality extras reach ``extend`` through its ``batch`` dict, as in the
reference. ``audio_frames`` (B, T, d) (whisper, ``family == "audio"``):
``run_encoder`` (sinusoidal positions, then bidirectional layers) and each
decoder layer's cross K/V (``cross_kv_all``), which replace the layer's
``cross_k`` / ``cross_v`` state leaves; every later chunk reads them back
from there. A whisper decoder layer adds its cross-attention after the
self-attention (``cross_norm``, ``cross``), and every step adds the learned
position of each row (``pos_embed``, indices clipped to the table as the
reference clips them). ``vision_embeds`` (B, N, d) (internvl, ``family ==
"vlm"``): ``splice_vision`` replaces the embedding rows at absolute
positions below N by those image rows, so a request's image owns KV
positions [0, N) ahead of its text; a chunk from 0 over the whole image is
exactly the reference's concatenation, and a chunk may end or start inside
the image.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.lora.ops import bgmv_add
from repro_torch.models import attention as attn
from repro_torch.models import mamba, mla, moe, xlstm
from repro_torch.models.common import (apply_norm, dense, dense_axes, gated, is_glu,
                                       make_dense, make_norm, norm_axes, normal_init,
                                       sinusoidal_positions)
from repro_torch.sharding.collectives import (MIXER_AXES, copy_to_model, cut_group,
                                              reduce_from_model)
from repro_torch.sharding.rules import current_rules

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

# mixers whose cache is a fixed-size state per sequence, not pages
STATE_MIXERS = ("mamba", "mlstm", "slstm")
# an audio decoder layer's cross-attention K/V: state leaves of one slot
CROSS_LEAVES = ("cross_k", "cross_v")
# whisper's encoder layers
ENC_SPEC = LayerSpec(mixer="attn", ff="mlp", attn_kind="global")


def resolve_device(device) -> torch.device:
    """The port's entry points take an explicit device: ``cuda`` (the
    default everywhere) must exist — there is no silent CPU fallback.
    ``meta`` builds shapes without data (``param_shapes``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def make_mlp_params(gen, cfg, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    out1 = 2 * f if is_glu(cfg.activation) else f
    return {"w1": make_dense(gen, d, out1, dtype, device, bias=cfg.mlp_bias),
            "w2": make_dense(gen, f, d, dtype, device, bias=cfg.mlp_bias,
                             scale=1.0 / math.sqrt(f))}


def mlp_param_axes(cfg):
    """The logical axes of ``make_mlp_params``' leaves (the reference's)."""
    return {"w1": dense_axes(("embed", "ff"), bias=cfg.mlp_bias, bias_axis="ff"),
            "w2": dense_axes(("ff", "embed"), bias=cfg.mlp_bias, bias_axis="embed")}


def mlp_apply(p, cfg, x, lora=None, lora_ids=None, tp=None):
    """The MLP; with ``lora``, each row's w1 delta joins ``dense(w1, x)``
    before the GLU split and its w2 delta (input: the activated hidden
    state, Din = d_ff) joins ``dense(w2, h)``, each added in place by one
    ``bgmv_add`` launch.

    With ``tp`` (the rank's model group) and ``cfg.tp_ff_sharded`` the rank
    holds a slice of the hidden units: its slicer permuted a GLU ``w1``'s
    columns so its local block is ``[u_i ; g_i]`` and the split stays local;
    x enters through ``copy_to_model`` (its gradient completed over the
    group), ``w2``'s local rows (and the w2 delta's A rows) give a partial
    sum that one ``reduce_from_model`` completes before the replicated bias
    (the JAX ``mlp_apply`` under ``cfg.tp_axis``). The sharded paged path
    and the sharded train step both run it so."""
    sharded = tp is not None and cfg.tp_ff_sharded
    if sharded:
        x = copy_to_model(x, tp)
    h = dense(p["w1"], x)
    if lora is not None and "w1" in lora:
        h, = bgmv_add(x, lora_ids, [(lora["w1"]["a"], lora["w1"]["b"], h)])
    h = gated(cfg.activation, h)
    y = h @ p["w2"]["w"] if sharded else dense(p["w2"], h)
    if lora is not None and "w2" in lora:
        y, = bgmv_add(h, lora_ids, [(lora["w2"]["a"], lora["w2"]["b"], y)])
    if sharded:
        y = reduce_from_model(y, tp)
        if "b" in p["w2"]:
            y = y + p["w2"]["b"]
    return y


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

MIXERS = {"attn": attn.make_attention_params, "mla": mla.make_mla_params,
          "mamba": mamba.make_mamba_params, "mlstm": xlstm.make_mlstm_params,
          "slstm": xlstm.make_slstm_params}


def _layer_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device, *,
                cross: bool = False):
    p = {"norm1": make_norm(cfg.norm, cfg.d_model, dtype, device),
         "mixer": MIXERS[spec.mixer](gen, cfg, dtype, device)}
    if cross:  # a whisper decoder layer's cross-attention
        p["cross_norm"] = make_norm(cfg.norm, cfg.d_model, dtype, device)
        p["cross"] = attn.make_attention_params(gen, cfg, dtype, device)
    if spec.ff != "none":
        make_ff = moe.make_moe_params if spec.ff == "moe" else make_mlp_params
        p["norm2"] = make_norm(cfg.norm, cfg.d_model, dtype, device)
        p["ff"] = make_ff(gen, cfg, dtype, device)
    return p


def _ff_branch(p, spec, cfg, x, lora=None, lora_ids=None, cf: float = 2.0, tp=None,
               shard=None):
    """The feed-forward residual and the MoE's aux loss (0.0 for an MLP or
    none); no residual where ``spec.ff`` is "none". A MoE layer serves at
    capacity factor 2.0 (the reference's serving value: over-provision
    rather than drop; its training forward passes 1.25) and takes no LoRA:
    its adapter sites are the attention projections only. ``tp``: the
    rank's model group, over which an MLP splits its hidden units (under
    ``cfg.tp_ff_sharded``). ``shard``: a rank's training plan
    (``train/sharding.py``): a MoE runs the rank's experts over ``tp`` and
    dispatches over the plan's batch group as its rules' "sharded_moe"
    option says (a tensor-parallel step's plan, ``executor/sharded.py::
    StepSharding``, likewise, with its experts over (data, model) where its
    rules say so). Under the plan's layer config a width the group holds
    whole (``cut_group``) runs whole: the experts, the shared experts'
    units (``cfg.tp_ff_sharded``)."""
    if spec.ff == "none":
        return x, 0.0
    h = apply_norm(cfg.norm, p["norm2"], x)
    if spec.ff == "moe":
        mesh = {} if shard is None else dict(
            tp=cut_group(cfg, "experts", tp), dp=shard.batch,
            sharded_moe=shard.rules.opt("sharded_moe"),
            shared_tp=tp if cfg.tp_ff_sharded else None,
            ep_data=getattr(shard, "ep_data", None))
        y, aux = moe.moe_apply(p["ff"], cfg, h, capacity_factor=cf, **mesh)
        return x + y, aux
    return x + mlp_apply(p["ff"], cfg, h, lora, lora_ids, tp), 0.0


def _layer_decode_paged(p, spec, cfg, x, pages, block_tables, lengths, *,
                        lora=None, lora_ids=None, tp=None):
    """One-token decode with attention running directly on page stores."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    y, pages, kv_new = attn.attn_decode_paged(p["mixer"], cfg, spec, h, pages,
                                              block_tables, lengths, lora, lora_ids, tp)
    return _ff_branch(p, spec, cfg, x + y, lora, lora_ids, tp=tp)[0], pages, kv_new


def _layer_extend_paged(p, spec, cfg, x, pages, block_tables, lengths, *,
                        chunk_lens=None, scratch_block=None, lora=None,
                        lora_ids=None, tp=None):
    """C-token extend with attention running directly on page stores."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    y, pages, kv_new = attn.attn_extend_paged(
        p["mixer"], cfg, spec, h, pages, block_tables, lengths,
        chunk_lens=chunk_lens, scratch_block=scratch_block, lora=lora,
        lora_ids=lora_ids, tp=tp)
    return _ff_branch(p, spec, cfg, x + y, lora, lora_ids, tp=tp)[0], pages, kv_new


def _state_extend(p, spec, cfg, h, state, tp=None):
    """A state mixer over a chunk from each row's carried state: (y, the
    state after the chunk). Every row's C positions are real (the engine
    groups state stacks by exact chunk length). ``tp``: the mixer runs the
    rank's channels or heads, and ``state`` is the rank's."""
    if spec.mixer == "mamba":
        y, (conv, ssm) = mamba.mamba_forward(p, cfg, h, conv_state=state["conv"],
                                             ssm_state=state["ssm"], tp=tp)
        return y, {"conv": conv, "ssm": ssm}
    fwd = xlstm.mlstm_forward if spec.mixer == "mlstm" else xlstm.slstm_forward
    return fwd(p, cfg, h, state=state, tp=tp)


def _layer_extend(p, spec, cfg, x, cache, cache_len, route, *, lora=None,
                  lora_ids=None, shard=None):
    """C-token extend over a gathered cache window, or from a state mixer's
    carried state (the twin of the reference's ``_layer_extend``); a
    whisper decoder layer then attends over its ``cross_k`` / ``cross_v``
    leaves. ``shard``: a tensor-parallel step's plan (``cfg`` its layer
    config): the mixer, cross-attention and feed-forward run the rank's
    heads, channels, hidden units and experts over ``shard.tp``, each
    width the group holds whole run whole. Returns (x, the layer's cache:
    the window written in place, or the new state)."""
    tp = None if shard is None else shard.tp
    mt = cut_group(cfg, MIXER_AXES[spec.mixer], tp)
    h = apply_norm(cfg.norm, p["norm1"], x)
    if spec.mixer in STATE_MIXERS:
        y, cache = _state_extend(p["mixer"], spec, cfg, h, cache, mt)
    elif spec.mixer == "mla":
        y, cache = mla.mla_extend(p["mixer"], cfg, spec, h, cache, cache_len, route, mt)
    else:
        y, cache = attn.attn_extend(p["mixer"], cfg, spec, h, cache, cache_len,
                                    route, lora, lora_ids, mt)
    x = x + y
    if "cross" in p:
        hc = apply_norm(cfg.norm, p["cross_norm"], x)
        x = x + attn.cross_attend(p["cross"], cfg, hc, cache["cross_k"], cache["cross_v"],
                                  cut_group(cfg, "heads", tp))
    return _ff_branch(p, spec, cfg, x, lora, lora_ids, tp=tp, shard=shard)[0], cache


def _layer_decode(p, spec, cfg, x, cache, cache_len, cp=None, shard=None):
    """One token through one layer over its contiguous cache (the twin of
    the reference's ``_layer_decode``): ``attn_decode`` (K/V written in
    place; ``cp``: the rank's slice of the sequence), ``mla_decode`` (the
    absorbed form; ``cp`` likewise), or a state mixer's step from its
    state; a whisper decoder layer then attends over every row of its
    ``cross_k`` / ``cross_v`` through ``decode_attention`` at
    1/sqrt(head_dim); the feed-forward at capacity factor 2.0. ``shard``:
    as in ``_layer_extend``. Returns (x, the layer's cache)."""
    tp = None if shard is None else shard.tp
    mt = cut_group(cfg, MIXER_AXES[spec.mixer], tp)
    h = apply_norm(cfg.norm, p["norm1"], x)
    if spec.mixer in STATE_MIXERS:
        y, cache = _state_extend(p["mixer"], spec, cfg, h, cache, mt)
    elif spec.mixer == "mla":
        y, cache = mla.mla_decode(p["mixer"], cfg, spec, h, cache, cache_len, mt, cp)
    else:
        y, cache = attn.attn_decode(p["mixer"], cfg, spec, h, cache, cache_len, cp, mt)
    x = x + y
    if "cross" in p:
        ct = cut_group(cfg, "heads", tp)
        hc = apply_norm(cfg.norm, p["cross_norm"], x)
        ek, ev = cache["cross_k"], cache["cross_v"]
        q = attn.proj_qkv(p["cross"]["wq"], hc)
        total = torch.full((x.shape[0],), ek.shape[1], dtype=torch.long, device=x.device)
        out = attn.decode_attention(q, attn.local_kv(ek, cfg, ct, 2),
                                    attn.local_kv(ev, cfg, ct, 2), total,
                                    scale=1.0 / math.sqrt(cfg.head_dim))
        x = x + attn.proj_out_lora(p["cross"]["wo"], out, tp=ct)
    return _ff_branch(p, spec, cfg, x, tp=tp, shard=shard)[0], cache


def _mixer_forward(p, spec, cfg, h, positions, tp=None):
    """A layer's mixer over a whole sequence from an empty history; ``tp``:
    the mixer runs the rank's heads or channels (``attn.attn_forward``,
    ``mla.mla_forward``, ``mamba.mamba_forward``, the xLSTM's), or runs
    whole where the group holds its width whole (``cut_group``)."""
    tp = cut_group(cfg, MIXER_AXES[spec.mixer], tp)
    if spec.mixer == "attn":
        return attn.attn_forward(p, cfg, spec, h, positions, tp=tp)
    if spec.mixer == "mla":
        return mla.mla_forward(p, cfg, spec, h, positions, tp=tp)[0]
    fwd = {"mamba": mamba.mamba_forward, "mlstm": xlstm.mlstm_forward,
           "slstm": xlstm.slstm_forward}[spec.mixer]
    return fwd(p, cfg, h, tp=tp)[0]


def _layer_forward(p, spec, cfg, x, positions, enc=None, shard=None):
    """The training path of one layer over a whole sequence (the twin of
    the reference's ``_layer_forward``): the mixer, causal, from an empty
    history; for a whisper decoder layer, cross-attention over the K/V it
    projects from the encoder states ``enc`` (B, T, d) in the activation
    dtype (the reference's ``cross_kv_stage``); the feed-forward, a MoE at
    the reference's training capacity factor 1.25. ``shard``: the rank's
    training plan, whose model group (``shard.tp``) the mixer,
    cross-attention and feed-forward split their heads, channels, hidden
    units and experts over (``cfg`` is then the plan's ``layer_cfg``).
    Returns (x, the MoE's aux loss or 0.0)."""
    tp = shard.tp if shard is not None else None
    x = x + _mixer_forward(p["mixer"], spec, cfg, apply_norm(cfg.norm, p["norm1"], x),
                           positions, tp)
    if enc is not None:
        hc = apply_norm(cfg.norm, p["cross_norm"], x)
        ct = cut_group(cfg, "heads", tp)
        k, v = attn.cross_kv(p["cross"], enc, x.dtype, cfg, ct)
        x = x + attn.cross_attend(p["cross"], cfg, hc, k, v, ct)
    return _ff_branch(p, spec, cfg, x, cf=1.25, tp=tp, shard=shard)


def _layer_forward_sharded(p, axes_specs, spec, cfg, x, positions, enc, shard):
    """``_layer_forward`` on a rank's slices of the layer: the slices cut
    over data are gathered first (``shard.gather``), inside the layer's
    checkpoint, so the backward pass's recompute gathers them again (as
    ZeRO-3 does) and the gathered weights live only while the layer runs."""
    return _layer_forward(shard.gather(p, axes_specs), spec, shard.layer_cfg, x, positions,
                          enc, shard)


def _layer_lora(lora):
    """(per-layer adapter tables, per-row slot ids) of a model-level LoRA
    operand; (None-per-layer, None) without one."""
    if lora is None:
        return itertools.repeat(None), None
    return lora["layers"], lora["ids"]


def paged_decode_supported(cfg: ModelConfig) -> bool:
    """Whether ``decode_paged`` covers this stack: every layer must be plain
    global attention (its feed-forward an MLP or a MoE)."""
    if cfg.family == "audio":
        return False
    return all(s.mixer == "attn" and s.attn_kind == "global"
               for p, _ in cfg.stages for s in p)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def supported_stack(cfg: ModelConfig) -> bool:
    """Whether the port builds this stack: attention layers of the global,
    sliding-window and chunked kinds, MLA layers or state mixers (Mamba,
    mLSTM, sLSTM), with an MLP, a MoE or no feed-forward; learned positions
    and whisper's encoder (``family == "audio"``) included."""
    return all((s.mixer in STATE_MIXERS or (
        s.mixer in ("attn", "mla") and s.attn_kind in ("global", "window", "chunked")))
        and s.ff in ("mlp", "moe", "none")
        for p, _ in cfg.stages for s in p)


class CacheLeaf(NamedTuple):
    """One cache leaf of a layer. A page leaf (``state`` False: attention
    K/V, MLA latents) has its ``shape`` per token; the page store keeps it
    in pages and the gathered backend in (B, W) + shape windows. A state
    leaf (``state`` True: a state mixer's, or a whisper decoder layer's
    cross K/V) has its ``shape`` per sequence, with no token axis, and
    lives in a state slot. ``dtype``: the activation dtype for page leaves,
    conv windows and cross K/V, f32 for the recurrences' states."""
    shape: tuple
    dtype: torch.dtype
    state: bool = False


def has_cross(cfg: ModelConfig) -> bool:
    """Whether the decoder layers attend over encoder states (whisper)."""
    return cfg.family == "audio"


def init_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
               device) -> Dict[str, torch.Tensor]:
    """A layer's per-sequence state leaves for ``batch`` sequences, empty:
    a state mixer's history, the reference's ``init_mamba_cache`` /
    ``init_mlstm_cache`` / ``init_slstm_cache`` (zeros, and the stabilizer
    ``m`` at -1e30); a whisper decoder layer's cross K/V, zeros of
    (n_audio_ctx, KV, D) in the activation dtype, as the reference's
    ``init_cache`` makes them; {} for any other layer."""
    if spec.mixer in STATE_MIXERS:
        init = {"mamba": mamba.init_mamba_cache, "mlstm": xlstm.init_mlstm_cache,
                "slstm": xlstm.init_slstm_cache}[spec.mixer]
        return init(cfg, batch, DTYPES[cfg.dtype], device)
    if not has_cross(cfg):
        return {}
    shape = (batch, cfg.n_audio_ctx, cfg.num_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=DTYPES[cfg.dtype], device=device)
            for n in CROSS_LEAVES}


def cache_leaf_shapes(cfg: ModelConfig) -> List[Dict[str, CacheLeaf]]:
    """Per layer, in ``layer_specs()`` order, each cache leaf's name and
    ``CacheLeaf``: page leaves ``{"k", "v"}: (KV, D)`` for attention,
    ``{"c_kv": (kv_lora_rank,), "k_pe": (qk_rope_head_dim,)}`` for MLA;
    state leaves Mamba ``{"conv": (K-1, d_inner), "ssm": (d_inner, N)
    f32}``, mLSTM ``{"conv": (3, d_inner), "C": (H, dh, dh), "n": (H, dh),
    "m": (H,)}`` (all but conv f32), sLSTM ``{"c", "n", "h": (d,), "m":
    (H,)}`` f32; a whisper decoder layer's ``{"cross_k", "cross_v":
    (n_audio_ctx, KV, D)}`` after its page leaves. Each leaf's kind comes
    from the model, not from its shape: the reference's store reads any
    leaf whose second axis equals ``max_model_len`` as pages, so it would
    page the cross K/V where ``n_audio_ctx == max_model_len``.
    ``Model.init_cache`` and the page store derive their tensors from this
    table."""
    dt = DTYPES[cfg.dtype]
    out = []
    for spec in cfg.layer_specs():
        if spec.mixer in STATE_MIXERS:
            leaves = {}
        elif spec.mixer == "mla":
            leaves = {"c_kv": CacheLeaf((cfg.kv_lora_rank,), dt),
                      "k_pe": CacheLeaf((cfg.qk_rope_head_dim,), dt)}
        else:
            kv = CacheLeaf((cfg.num_kv_heads, cfg.head_dim), dt)
            leaves = {"k": kv, "v": kv}
        leaves.update({n: CacheLeaf(tuple(t.shape[1:]), t.dtype, state=True)
                       for n, t in init_state(cfg, spec, 1, "meta").items()})
        out.append(leaves)
    return out


class RingCache(list):
    """The cache list of ``init_cache(..., window_ring=True)``: its window
    layers hold rings of ``min(max_seq, sliding_window + 512)`` slots.
    ``decode`` runs it only under the rules' "window_ring" option and
    ``extend`` refuses it (the reference has no ring-aware extend)."""


def fill_ring(ring: "RingCache", cache: list, length: int) -> "RingCache":
    """Fill ``ring`` (``init_cache(..., window_ring=True)``) from a whole
    cache of the same model whose rows hold ``length`` tokens: a leaf
    narrower than its whole twin (a window layer's ring of W slots) takes
    positions [length - W, length) at slots ``p % W``, every other leaf is
    copied whole. Returns ``ring``, written in place."""
    for r_layer, c_layer in zip(ring, cache, strict=True):
        for name, t in r_layer.items():
            src = c_layer[name]
            if t.shape == src.shape:
                t.copy_(src)
                continue
            pos = torch.arange(max(0, length - t.shape[1]), length, device=t.device)
            t[:, pos % t.shape[1]] = src[:, pos]
    return ring


def _window(c, spec):
    """The layer's window of the gathered cache (an attention layer's
    ``k``, an MLA layer's ``c_kv``), whose width is the window's; None for
    a state mixer."""
    if spec.mixer in STATE_MIXERS:
        return None
    return c["c_kv"] if spec.mixer == "mla" else c["k"]


class Model:
    """Functions over a parameter dict for one config on one device.

    ``route_rows`` counts the batch rows ``extend`` sent down each route
    (``flash_prefill``: fresh rows; ``flash_attention``: continuation rows,
    and fresh rows of a layer where ``attn.fresh_rows_take_kernel`` fails),
    once per call, not per layer: a row counts under each route it took in
    any layer, so a fresh row of a llama4 chunk longer than ``chunk_size``
    (the kernel in the global layers, the plain attention in the chunked
    ones) counts under both. State-mixer layers attend on no route: a
    Jamba row counts as its attention layer routes it, an xLSTM row under
    neither."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if not supported_stack(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the port serves attention (global, sliding-window "
                "or chunked), MLA and state-mixer (Mamba, mLSTM, sLSTM) stacks "
                "with an MLP, MoE or no feed-forward")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.pdtype = DTYPES[cfg.param_dtype]
        self.specs = cfg.layer_specs()
        self.route_rows = {"flash_prefill": 0, "flash_attention": 0}
        if not paged_decode_supported(cfg):
            # no paged family for this stack: the gathered backend serves it
            self.decode_paged = self.extend_paged = self.verify_paged = None

    # ---------------- init ---------------------------------------------------
    def init(self, seed: int = 0, max_seq: int = 0, place=None) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        the model's device (JAX's init draws other bits for the same seed;
        parity tests convert the JAX weights instead). Learned positions
        draw ``max(learned_positions, max_seq)`` rows, as the reference's.
        With ``cfg.mtp_depth`` (DeepSeek-V3), the multi-token prediction
        block ``mtp``: ``proj`` (2d, d), ``norm_h``, ``norm_e``, a
        ``layer`` of the last stage's last spec and ``final_norm``; only
        ``forward`` reads it.

        ``place(layer, axes)``, where given, maps each layer's tree with its
        logical axes (``param_axes``) as soon as the layer is drawn, before
        the next one: a rank of a sharded engine keeps only its slices that
        way (``executor.sharded.rank_params``), so the whole stack never
        lives on its device at once. The draws are those of ``place=None``."""
        cfg, dev, pdt = self.cfg, self.device, self.pdtype
        axes = param_axes(cfg) if place is not None else None
        # meta tensors take a host generator (no bits are drawn)
        gen = torch.Generator(device=dev if dev.type != "meta" else "cpu").manual_seed(seed)
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": normal_init(gen, (cfg.vocab_size, d), pdt, d ** -0.5, dev),
            "final_norm": make_norm(cfg.norm, d, pdt, dev),
        }
        if cfg.learned_positions:
            params["pos_embed"] = normal_init(
                gen, (max(cfg.learned_positions, max_seq), d), pdt, 0.02, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = make_dense(gen, d, cfg.vocab_size, pdt, dev,
                                           scale=1.0 / math.sqrt(d))
        cross = has_cross(cfg)
        layers = []
        for i, spec in enumerate(self.specs):
            layer = _layer_init(gen, spec, cfg, pdt, dev, cross=cross)
            layers.append(layer if place is None else place(layer, axes["layers"][i]))
        params["layers"] = layers
        if cross:
            params["encoder"] = {
                "layers": [_layer_init(gen, ENC_SPEC, cfg, pdt, dev)
                           for _ in range(cfg.encoder_layers)],
                "final_norm": make_norm(cfg.norm, d, pdt, dev)}
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": make_dense(gen, 2 * d, d, pdt, dev),
                "norm_h": make_norm(cfg.norm, d, pdt, dev),
                "norm_e": make_norm(cfg.norm, d, pdt, dev),
                "layer": _layer_init(gen, cfg.stages[-1][0][-1], cfg, pdt, dev),
                "final_norm": make_norm(cfg.norm, d, pdt, dev)}
        return params

    def init_pages(self, num_blocks: int, block_size: int,
                   quantized: bool = False) -> List[Dict[str, Any]]:
        """Zeroed page stores, one {"k", "v"} pair per layer, kernel layout
        (KV, NB, P, D), on the model's device. fp pages are in the
        activation dtype. ``quantized`` pages (KIVI) are per-name dicts:
        ``codes`` (KV, NB, P, D) uint8 and f16 ``scale``/``zero`` planes,
        (KV, NB, 1, D) for keys (per channel) and (KV, NB, P, 1) for values
        (per token)."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.num_kv_heads, num_blocks, block_size, cfg.head_dim)
        if not quantized:
            return [{name: torch.zeros(shape, dtype=self.dtype, device=dev)
                     for name in ("k", "v")} for _ in self.specs]
        planes = {"k": shape[:2] + (1, cfg.head_dim), "v": shape[:3] + (1,)}
        return [{name: {"codes": torch.zeros(shape, dtype=torch.uint8, device=dev),
                        "scale": torch.zeros(planes[name], dtype=torch.float16,
                                             device=dev),
                        "zero": torch.zeros(planes[name], dtype=torch.float16,
                                            device=dev)}
                 for name in ("k", "v")} for _ in self.specs]

    def init_cache(self, batch: int, max_seq: int, *, window_ring: bool = False,
                   place=None) -> List[Dict[str, torch.Tensor]]:
        """An empty gathered (or contiguous) cache on the model's device, per
        layer: for each page leaf of ``cache_leaf_shapes`` a zeroed (batch,
        max_seq) + per-token shape window, {"k", "v"} (B, W, KV, D) for
        attention, {"c_kv": (B, W, r), "k_pe": (B, W, rope)} for MLA, in the
        activation dtype; then the layer's empty states (``init_state``: a
        state mixer's history, a whisper layer's cross K/V).

        ``window_ring``: a window attention layer takes ``min(max_seq,
        sliding_window + 512)`` slots, a ring for ``decode`` under the
        "window_ring" option (the reference's ``_layer_cache``); the list is
        then a ``RingCache``. ``place(i, layer)``, where given, maps each
        layer's dict as soon as it is made, before the next one (a rank
        keeps its slice of each: ``launch/specs.py::rank_cache``)."""
        cfg = self.cfg
        out = RingCache() if window_ring else []
        for i, (spec, leaves) in enumerate(zip(self.specs, cache_leaf_shapes(cfg))):
            width = max_seq
            if window_ring and spec.mixer == "attn" and spec.attn_kind == "window" \
                    and cfg.sliding_window:
                width = min(max_seq, cfg.sliding_window + 512)
            layer = {name: torch.zeros((batch, width) + leaf.shape, dtype=leaf.dtype,
                                       device=self.device)
                     for name, leaf in leaves.items() if not leaf.state}
            layer.update(init_state(cfg, spec, batch, self.device))
            out.append(layer if place is None else place(i, layer))
        return out

    # ---------------- shared helpers ----------------------------------------
    def embed_tokens(self, params, tokens, tp=None):
        """The token embeddings; with ``tp`` the table holds the model
        group's vocab slice, rank i rows [i * V_l, (i + 1) * V_l): each
        rank looks up the tokens in its rows, zeros the others, and one
        ``reduce_from_model`` sums them (the vocab-parallel embedding)."""
        table = params["embed"]
        if tp is None:
            e = table[tokens.long()].to(self.dtype)
        else:
            rows = table.shape[0]
            idx = tokens.long() - tp.index * rows
            inside = (idx >= 0) & (idx < rows)
            e = table[idx.clamp(0, rows - 1)].to(self.dtype) * inside[..., None]
            e = reduce_from_model(e, tp)
        if self.cfg.embed_scale:
            e = e * math.sqrt(self.cfg.d_model)
        return e

    def add_positions(self, params, x, pos):
        """x plus the learned position of each (B, C) absolute position
        ``pos``, clipped to the table as the reference clips it; x where
        the config has none."""
        if not self.cfg.learned_positions:
            return x
        table = params["pos_embed"]
        return x + table[pos.long().clamp(0, table.shape[0] - 1)].to(self.dtype)

    def head(self, params, x, tp=None):
        """The final norm and the logits; with ``tp`` the head (or the tied
        embedding) holds the model group's vocab slice, x enters through
        ``copy_to_model`` and the logits are the rank's (B, S, V_l) block,
        for the vocab-parallel loss (``train.loop.cross_entropy``)."""
        return self._vocab_logits(params, apply_norm(self.cfg.norm, params["final_norm"], x),
                                  tp)

    def _vocab_logits(self, params, x, tp=None):
        """x (normalized) times the head (or the tied embedding's
        transpose); with ``tp`` the rank's vocab block, x entering through
        ``copy_to_model``."""
        w = params["embed"].t() if self.cfg.tie_embeddings \
            else params["lm_head"]["w"]
        return torch.einsum("bsd,dv->bsv", copy_to_model(x, tp), w.to(x.dtype))

    def run_encoder(self, params, frames, shard=None):
        """frames: (B, T, d) post-frontend embeddings (the stubbed audio
        frontend's output). Sinusoidal positions, then the bidirectional
        encoder layers and its final norm. Returns (B, T, d). ``shard``: a
        rank's training plan; each layer's slices are gathered over data
        where the layer runs, and under a model group each layer runs the
        rank's heads and hidden units (two all-reduces a layer)."""
        cfg = self.cfg
        T = frames.shape[1]
        x = frames.to(self.dtype) + sinusoidal_positions(
            T, cfg.d_model, frames.device).to(self.dtype)
        pos = torch.arange(T, device=x.device)
        enc = params["encoder"]
        tp, lcfg = None, cfg
        if shard is not None:
            enc = shard.gather(enc, shard.specs["encoder"])
            tp, lcfg = shard.tp, shard.layer_cfg
        for p in enc["layers"]:
            h = apply_norm(cfg.norm, p["norm1"], x)
            y = attn.attn_forward(p["mixer"], lcfg, ENC_SPEC, h, pos, causal=False,
                                  tp=cut_group(lcfg, "heads", tp))
            x, _ = _ff_branch(p, ENC_SPEC, lcfg, x + y, tp=tp)
        return apply_norm(cfg.norm, enc["final_norm"], x)

    def cross_kv_all(self, params, enc, shard=None):
        """Each decoder layer's cross K/V over the encoder states enc
        (B, T, d): a list over layers of {"cross_k", "cross_v"} (B, T, KV,
        D) in the activation dtype; under a step's ``shard`` the rank's KV
        heads where the group cuts them."""
        tp = cfg = None
        if shard is not None:
            cfg = shard.layer_cfg
            tp = cut_group(cfg, "heads", shard.tp)
        return [dict(zip(CROSS_LEAVES, attn.cross_kv(p["cross"], enc, self.dtype, cfg, tp)))
                for p in params["layers"]]

    def splice_vision(self, params, tokens, vision_embeds, cache_len, tp=None):
        """The token embeddings of a (B, C) chunk at positions [cache_len,
        cache_len + C), with the rows at absolute positions below N replaced
        by image rows ``vision_embeds`` (B, N, d): position i < N takes
        image row i. From cache_len 0 over the whole image, this is the
        reference's ``splice_vision`` (the image ahead of the text) with N
        placeholder tokens in front of the text. ``tp``: the embedding's
        vocab group (``embed_tokens``)."""
        x = self.embed_tokens(params, tokens, tp)
        B, C, d = x.shape
        N = vision_embeds.shape[1]
        pos = cache_len.long()[:, None] + torch.arange(C, device=x.device)
        rows = vision_embeds.to(x.dtype).gather(
            1, pos.clamp(max=N - 1)[..., None].expand(B, C, d))
        return torch.where((pos < N)[..., None], rows, x)

    # ---------------- forward (training) ----------------------------------------
    def forward(self, params, batch, shard=None):
        """The full-sequence training forward (the twin of the reference's
        ``forward``). ``batch``: ``tokens`` (B, S) on the model's device,
        and the family's extras: ``audio_frames`` (B, T, d) (whisper: the
        encoder runs, and each decoder layer attends over its cross K/V),
        ``vision_embeds`` (B, N, d) (internvl: the image rows at positions
        [0, N), the text after them, so the logits cover N + S positions).
        Learned positions are added for positions [0, S). Each layer runs
        under ``torch.utils.checkpoint`` (under a gradient its activations
        are recomputed in the backward pass: the reference's
        ``jax.checkpoint`` over its scan body), and the state mixers' time
        loops in 64-step chunks. Attention is the plain ``flash_attention``: no kernel runs.
        Returns (logits (B, S', V), aux): ``aux["moe_aux"]``, the MoE
        layers' load-balance losses summed (0.0 without MoE), and with an
        MTP block ``aux["mtp_logits"]`` (B, S - 1, V).

        ``shard``: one rank's plan of the sharded train step
        (``train/sharding.py``). ``params`` are then the rank's slices and
        ``batch`` its rows. The slices cut over data are gathered where
        they are used: a layer's inside its checkpoint, the embedding, head
        and norms once before the first layer. With a model group
        (``shard.tp``) every family runs shard-locally: each layer (and
        whisper's encoder layers and cross-attention, and the MTP block's
        layer) runs the rank's heads (attention, MLA, the xLSTM's), inner
        channels (Mamba, the mLSTM), hidden units and experts, the
        embedding (the MTP block's too) is vocab-parallel where the vocab
        is cut, and the logits (and ``aux["mtp_logits"]``) are then the
        rank's (B, S', V_l) block; image rows join after the
        vocab-parallel embedding. The MoE aux loss is the mesh's
        (``moe.moe_apply``)."""
        cfg, dev = self.cfg, self.device
        tokens = batch["tokens"]
        top, vtp = params, None
        if shard is not None:
            top = shard.gather({k: v for k, v in params.items()
                                if k not in ("layers", "encoder", "mtp")}, shard.specs)
            vtp = shard.vocab_tp
        enc = self.run_encoder(params, batch["audio_frames"], shard) if has_cross(cfg) \
            else None
        x = self.embed_tokens(top, tokens, vtp)
        if cfg.family == "vlm":
            x = torch.cat([batch["vision_embeds"].to(self.dtype), x], dim=1)
        S = x.shape[1]
        positions = torch.arange(S, device=dev)
        if cfg.learned_positions:
            x = x + top["pos_embed"][:S][None].to(self.dtype)
        moe_total = 0.0
        for i, (p, spec) in enumerate(zip(params["layers"], self.specs)):
            if shard is None:
                x, a = checkpoint(_layer_forward, p, spec, cfg, x, positions, enc,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = checkpoint(_layer_forward_sharded, p, shard.specs["layers"][i], spec,
                                  cfg, x, positions, enc, shard, use_reentrant=False,
                                  preserve_rng_state=False)
            moe_total = moe_total + a
        aux = {"moe_aux": moe_total}
        logits = self.head(top, x, vtp)
        if cfg.mtp_depth and "mtp" in params:
            aux["mtp_logits"] = self.mtp_head(params, x, tokens, shard, top)
        return logits, aux

    def mtp_head(self, params, h_main, tokens, shard=None, top=None):
        """DeepSeek-V3's multi-token prediction at depth 1: from the last
        layer's states h_t (before the final norm) and the embedding of
        token t + 1, one more layer of the last stage's last spec predicts
        token t + 2 through the shared head. Returns (B, S - 1, V).
        ``shard`` and ``top`` (the gathered embedding and head): as in
        ``forward``: the embedding is vocab-parallel where the vocab is
        cut, the layer runs the rank's heads, hidden units and experts, and
        the logits are then the rank's (B, S - 1, V_l) block."""
        cfg = self.cfg
        m = params["mtp"]
        vtp = None
        if shard is not None:
            m = shard.gather(m, shard.specs["mtp"])
            vtp = shard.vocab_tp
        top = params if top is None else top
        h = apply_norm(cfg.norm, m["norm_h"], h_main[:, :-1])
        e = apply_norm(cfg.norm, m["norm_e"], self.embed_tokens(top, tokens[:, 1:], vtp))
        x = dense(m["proj"], torch.cat([h, e], dim=-1))
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = _layer_forward(m["layer"], cfg.stages[-1][0][-1],
                              cfg if shard is None else shard.layer_cfg, x, positions,
                              shard=shard)
        return self._vocab_logits(top, apply_norm(cfg.norm, m["final_norm"], x), vtp)

    # ---------------- extend (gathered cache windows) -------------------------
    @torch.no_grad()
    def extend(self, params, tokens, cache, cache_len, lora=None, batch=None, shard=None):
        """tokens: (B, C) at positions [cache_len, cache_len + C); cache: a
        list over layers (``init_cache``) of windows, written in place, and
        of states; cache_len: (B,) tokens already cached per row. ``lora``
        as in ``decode_paged``. ``batch``: modality extras on the model's
        device, for every row of the call — ``audio_frames`` (B, T, d) on
        an audio stack (the encoder runs and its cross K/V replace the
        layers' ``cross_k`` / ``cross_v``), ``vision_embeds`` (B, N, d) on a
        VLM (``splice_vision``); other stacks ignore them, as the
        reference does. Logits of a ragged row's padded positions are
        garbage the caller ignores (a state stack takes no ragged rows: its
        states would run over the padding). Returns (logits (B, C, V), the
        cache list with each state layer's entry replaced by its state
        after the chunk).

        ``shard``: a rank's plan of a tensor-parallel prefill step
        (``core/executor/sharded.py::StepSharding``): ``params`` are its
        slices and ``cache`` its block; each layer runs under the plan's
        layer config over its model group (``_layer_extend``), whisper's
        encoder and cross K/V on the rank's heads, the embedding (internvl's
        too) and head vocab-parallel where the vocab is cut, and the logits
        are then the rank's (B, C, V_l) block."""
        cfg = self.cfg
        lcfg = cfg if shard is None else shard.layer_cfg
        vtp = None if shard is None else shard.vocab_tp
        if isinstance(cache, RingCache):
            raise ValueError(f"{cfg.name}: extend takes no window ring (the reference has no "
                             "ring-aware extend); fill a ring from a whole cache")
        extras = batch or {}
        C = tokens.shape[1]
        if has_cross(cfg) and "audio_frames" in extras:
            enc = self.run_encoder(params, extras["audio_frames"], shard)
            cache = [dict(c, **kv) for c, kv in zip(cache,
                                                    self.cross_kv_all(params, enc, shard))]
        windows = [w for w in map(_window, cache, self.specs) if w is not None]
        # the window width comes from an attention layer's leaf; a stack of
        # state mixers alone writes no window
        route = attn.extend_route(cache_len, C, windows[0].shape[1] if windows else 0)
        kernel = [attn.fresh_rows_take_kernel(self.cfg, s, C) for s in self.specs
                  if s.mixer not in STATE_MIXERS]
        if kernel:
            nf = len(route.fresh)
            self.route_rows["flash_prefill"] += nf if any(kernel) else 0
            self.route_rows["flash_attention"] += len(route.cont) + (
                0 if all(kernel) else nf)
        if cfg.family == "vlm" and "vision_embeds" in extras:
            x = self.splice_vision(params, tokens, extras["vision_embeds"], cache_len, vtp)
        else:
            x = self.embed_tokens(params, tokens, vtp)
        x = self.add_positions(params, x, cache_len.long()[:, None]
                               + torch.arange(C, device=x.device))
        tables, ids = _layer_lora(lora)
        out = []
        for p, spec, c, lt in zip(params["layers"], self.specs, cache, tables):
            x, c = _layer_extend(p, spec, lcfg, x, c, cache_len, route, lora=lt,
                                 lora_ids=ids, shard=shard)
            out.append(c)
        return self.head(params, x, vtp), out

    # ---------------- decode (one token, contiguous cache) ---------------------
    def _check_positions(self, cache, cache_len, cp) -> None:
        """Every row's new position must lie inside each layer's cache (a
        ring's takes any): the reference's scatter drops a write past the
        cache and attends without it, the port raises (one host read of
        cache_len a step). Under ``cp`` an attention cache and an MLA
        layer's latents are the rank's 1/cp.size of the sequence."""
        rules = current_rules()
        if isinstance(cache, RingCache) and not (rules is not None
                                                 and rules.opt("window_ring")):
            raise ValueError(f"{self.cfg.name}: a window ring decodes only under the "
                             "rules' \"window_ring\" option (use_rules)")
        if cache_len.device.type == "meta":
            return  # shapes without values (the dry-run): nothing to read
        top = int(cache_len.max()) if cache_len.numel() else 0
        for i, (spec, c) in enumerate(zip(self.specs, cache)):
            w = _window(c, spec)
            if w is None:
                continue
            width = w.shape[1]
            if spec.mixer == "attn" and attn.window_ring_applies(self.cfg, spec, width):
                continue
            width *= 1 if cp is None else cp.size
            if top >= width:
                raise IndexError(f"{self.cfg.name} layer {i}: a row decodes position {top} "
                                 f"past its {width}-slot cache")

    @torch.no_grad()
    def decode(self, params, tokens, cache, cache_len, *, cp=None, shard=None):
        """tokens: (B, 1) at positions ``cache_len`` (B,); cache: the list of
        ``init_cache`` (attention K/V written in place, a state layer's
        entry replaced by its state after the token). The twin of the
        reference's ``decode`` over its unstacked cache: learned positions
        at ``clip(cache_len, 0, size - 1)``, each layer through
        ``_layer_decode``, the head. A window ring (``RingCache``) needs
        the rules' "window_ring" option in force (``use_rules``).

        ``cp``: a rank's group of a context-parallel decode (``launch/
        mesh.AxisGroup``): each attention layer's cache holds the rank's
        1/cp.size of the sequence, slots [index * S_loc, (index + 1) *
        S_loc), and so does each MLA layer's latents (``c_kv``, ``k_pe``);
        each such layer merges over the group (two all-reduces a layer); a
        ring, the state mixers' states and whisper's cross K/V stay whole
        on every rank.
        ``shard``: a rank's plan of a tensor-parallel decode step, as in
        ``extend`` (the logits then the rank's (B, 1, V_l) block).
        Returns (logits (B, 1, V), the cache list)."""
        self._check_positions(cache, cache_len, cp)
        lcfg = self.cfg if shard is None else shard.layer_cfg
        vtp = None if shard is None else shard.vocab_tp
        x = self.add_positions(params, self.embed_tokens(params, tokens, vtp),
                               cache_len.long()[:, None])
        out = []
        for p, spec, c in zip(params["layers"], self.specs, cache):
            x, c = _layer_decode(p, spec, lcfg, x, c, cache_len, cp, shard)
            out.append(c)
        return self.head(params, x, vtp), (RingCache(out) if isinstance(cache, RingCache)
                                           else out)

    # ---------------- decode_paged (one token) --------------------------------
    def _check_tp(self, tp) -> None:
        """A shard-local config (``cfg.tp_axis`` set) runs only with its
        rank's model group, and a group only with a shard-local config."""
        if (tp is None) != (self.cfg.tp_axis is None):
            raise ValueError(
                f"{self.cfg.name}: tp_axis={self.cfg.tp_axis!r} but the model group "
                f"is {'missing' if tp is None else 'given'}; the sharded paged runner "
                "passes its group to a shard-local model")

    @torch.no_grad()
    def decode_paged(self, params, tokens, pages, block_tables, lengths,
                     lora=None, tp=None):
        """tokens: (B, 1); pages: list over layers of {"k", "v"} (KV, NB, P,
        D), or quantized dicts with a per-step ``tail``; block_tables:
        (B, NP) shared by every layer; lengths: (B,) valid tokens before
        this one. ``lora``: the multi-tenant adapter operand ``{"ids": (B,)
        int32 slots on the model's device, "layers": [per-layer {site:
        {"a", "b"}} tables]}`` (``core/lora/store.py``), or None. Returns
        (logits (B, 1, V), pages, writes) with one {"k", "v"} (B, KV, D)
        entry per layer: the new token's K/V for the host-authoritative
        store. ``tp``: on a shard-local model (``cfg.tp_axis``), the rank's
        model group, which every layer all-reduces over (``proj_out_lora``,
        and ``mlp_apply`` under ``cfg.tp_ff_sharded``)."""
        self._check_tp(tp)
        x = self.add_positions(params, self.embed_tokens(params, tokens),
                               lengths.long()[:, None])
        writes = []
        tables, ids = _layer_lora(lora)
        for p, spec, pg, lt in zip(params["layers"], self.specs, pages, tables):
            x, _, (k_new, v_new) = _layer_decode_paged(
                p, spec, self.cfg, x, pg, block_tables, lengths, lora=lt,
                lora_ids=ids, tp=tp)
            writes.append({"k": k_new, "v": v_new})
        return self.head(params, x), pages, writes

    # ---------------- extend_paged (C-token chunks) --------------------------
    @torch.no_grad()
    def extend_paged(self, params, tokens, pages, block_tables, lengths,
                     chunk_lens=None, scratch_block: Optional[int] = None,
                     lora=None, tp=None):
        """tokens: (B, C) at positions [lengths, lengths + C); pages /
        tables / lengths / lora / tp as in ``decode_paged``. Ragged batches pass
        ``chunk_lens`` (B,) and a ``scratch_block`` for padded positions'
        writes; logits of padded positions are garbage the caller ignores.
        Returns (logits (B, C, V), pages, writes) with write leaves
        (B, C, KV, D)."""
        self._check_tp(tp)
        x = self.add_positions(params, self.embed_tokens(params, tokens),
                               lengths.long()[:, None]
                               + torch.arange(tokens.shape[1], device=tokens.device))
        writes = []
        tables, ids = _layer_lora(lora)
        for p, spec, pg, lt in zip(params["layers"], self.specs, pages, tables):
            x, _, (k_new, v_new) = _layer_extend_paged(
                p, spec, self.cfg, x, pg, block_tables, lengths,
                chunk_lens=chunk_lens, scratch_block=scratch_block, lora=lt,
                lora_ids=ids, tp=tp)
            writes.append({"k": k_new, "v": v_new})
        return self.head(params, x), pages, writes

    # ---------------- verify_paged (C tokens, every position real) ------------
    def verify_paged(self, params, tokens, pages, block_tables, lengths,
                     lora=None, tp=None):
        """Score C tokens per sequence straight off the page stores: the
        speculative verify (the target scores k drafts + 1 bonus position in
        one forward) and the draft's paged catch-up. ``extend_paged`` with
        every position real, so no ``chunk_lens`` and no scratch page; on
        CUDA bf16 / f16 its attention is the paged kernel's native chunked
        path at ``rows_per_seq = C`` (fp32 folds). ``decode_paged`` is the
        C == 1 case. Returns (logits (B, C, V), pages, writes)."""
        return self.extend_paged(params, tokens, pages, block_tables, lengths,
                                 lora=lora, tp=tp)


def _layer_axes(spec: LayerSpec, cfg: ModelConfig, *, cross: bool = False):
    """The logical axes of ``_layer_init``'s tree."""
    mixer = {"attn": attn.attention_param_axes, "mla": mla.mla_param_axes,
             "mamba": mamba.mamba_param_axes, "mlstm": xlstm.mlstm_param_axes,
             "slstm": xlstm.slstm_param_axes}[spec.mixer]
    out = {"norm1": norm_axes(cfg.norm), "mixer": mixer(cfg)}
    if cross:
        out["cross_norm"] = norm_axes(cfg.norm)
        out["cross"] = attn.attention_param_axes(cfg)
    if spec.ff != "none":
        out["norm2"] = norm_axes(cfg.norm)
        out["ff"] = moe.moe_param_axes(cfg) if spec.ff == "moe" else mlp_param_axes(cfg)
    return out


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every leaf of ``Model.init``'s tree, in the same
    structure, as the reference's ``param_axes_tree`` names them, less its
    stacked "layers" axis: every family's mixers (attention, MLA, Mamba,
    mLSTM, sLSTM), MLP and MoE feed-forwards, whisper's encoder and
    cross-attention, learned positions and DeepSeek-V3's MTP block. The
    sharded paged runner splits "heads", "kv_heads" and "ff" by them
    (``serving_tp_rules``); the sharded train step cuts every leaf by
    ``mode_rules(..., "train")``."""
    d_axes = norm_axes(cfg.norm)
    out: Dict[str, Any] = {"embed": ("vocab", "embed"), "final_norm": d_axes}
    if cfg.learned_positions:
        out["pos_embed"] = (None, "embed")
    if not cfg.tie_embeddings:
        out["lm_head"] = dense_axes(("embed", "vocab"))
    cross = has_cross(cfg)
    out["layers"] = [_layer_axes(spec, cfg, cross=cross) for spec in cfg.layer_specs()]
    if cross:
        out["encoder"] = {"layers": [_layer_axes(ENC_SPEC, cfg)
                                     for _ in range(cfg.encoder_layers)],
                          "final_norm": d_axes}
    if cfg.mtp_depth:
        out["mtp"] = {"proj": dense_axes((None, "embed")), "norm_h": d_axes,
                      "norm_e": d_axes, "layer": _layer_axes(cfg.stages[-1][0][-1], cfg),
                      "final_norm": d_axes}
    return out


def param_shapes(cfg: ModelConfig, max_seq: int = 0) -> Dict[str, Any]:
    """The shape of every leaf of ``Model.init``'s tree, in its structure
    (drawn on the meta device: no memory, no bits)."""
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    return shapes(Model(cfg, device="meta").init(0, max_seq))


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
