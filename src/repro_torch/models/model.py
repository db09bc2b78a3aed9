"""Model factory of the PyTorch port: attention and multi-head latent
attention (MLA) decoders with a dense MLP or a routed MoE feed-forward, on
the paged and gathered serving paths, stacks with state mixers (Mamba:
jamba-v0.1-52b; mLSTM and sLSTM: xlstm-1.3b) and whisper's
encoder-decoder on the gathered path, and internvl's image splice.

The twin of the attention, MLA, state-mixer, MLP and MoE part of
``repro.models.model.build_model``:
``embed_tokens``, ``head``, ``init_cache`` / ``extend`` (a chunk appended to
a gathered ``(B, W, KV, D)`` cache window: prefill, chunked prefill, mixed
batches, decode as chunks of one), and, where ``paged_decode_supported``
holds (every layer global attention, MLP or MoE), ``decode_paged`` (one
token) and ``extend_paged`` (chunked prefill / ragged mixed batches) and
``verify_paged`` (C real positions per row: speculative verify and draft
catch-up); on other stacks (sliding-window attention: starcoder2-3b;
chunked attention: llama4-scout; MLA: deepseek-v3; state mixers) those
three are None, as in the reference.
A MoE layer's feed-forward is ``moe.moe_apply`` at capacity factor 2.0, as
the reference serves it, with its aux loss dropped. Parameters are plain
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
are not adapted), so two launches.
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

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.lora.ops import bgmv_add
from repro_torch.models import attention as attn
from repro_torch.models import mamba, mla, moe, xlstm
from repro_torch.models.common import (apply_norm, dense, gated, is_glu, make_dense,
                                       make_norm, normal_init, sinusoidal_positions)

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
    default everywhere) must exist — there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
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


def mlp_apply(p, cfg, x, lora=None, lora_ids=None):
    """The MLP; with ``lora``, each row's w1 delta joins ``dense(w1, x)``
    before the GLU split and its w2 delta (input: the activated hidden
    state, Din = d_ff) joins ``dense(w2, h)``, each added in place by one
    ``bgmv_add`` launch."""
    h = dense(p["w1"], x)
    if lora is not None and "w1" in lora:
        h, = bgmv_add(x, lora_ids, [(lora["w1"]["a"], lora["w1"]["b"], h)])
    h = gated(cfg.activation, h)
    y = dense(p["w2"], h)
    if lora is not None and "w2" in lora:
        y, = bgmv_add(h, lora_ids, [(lora["w2"]["a"], lora["w2"]["b"], y)])
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


def _ff_branch(p, spec, cfg, x, lora=None, lora_ids=None):
    """The feed-forward residual; none where ``spec.ff`` is "none". A MoE
    layer serves at capacity factor 2.0 (the reference's serving value:
    over-provision rather than drop) and takes no LoRA: its adapter sites
    are the attention projections only."""
    if spec.ff == "none":
        return x
    h = apply_norm(cfg.norm, p["norm2"], x)
    if spec.ff == "moe":
        return x + moe.moe_apply(p["ff"], cfg, h, capacity_factor=2.0)[0]
    return x + mlp_apply(p["ff"], cfg, h, lora, lora_ids)


def _layer_decode_paged(p, spec, cfg, x, pages, block_tables, lengths, *,
                        lora=None, lora_ids=None):
    """One-token decode with attention running directly on page stores."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    y, pages, kv_new = attn.attn_decode_paged(p["mixer"], cfg, spec, h, pages,
                                              block_tables, lengths, lora, lora_ids)
    return _ff_branch(p, spec, cfg, x + y, lora, lora_ids), pages, kv_new


def _layer_extend_paged(p, spec, cfg, x, pages, block_tables, lengths, *,
                        chunk_lens=None, scratch_block=None, lora=None,
                        lora_ids=None):
    """C-token extend with attention running directly on page stores."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    y, pages, kv_new = attn.attn_extend_paged(
        p["mixer"], cfg, spec, h, pages, block_tables, lengths,
        chunk_lens=chunk_lens, scratch_block=scratch_block, lora=lora,
        lora_ids=lora_ids)
    return _ff_branch(p, spec, cfg, x + y, lora, lora_ids), pages, kv_new


def _state_extend(p, spec, cfg, h, state):
    """A state mixer over a chunk from each row's carried state: (y, the
    state after the chunk). Every row's C positions are real (the engine
    groups state stacks by exact chunk length)."""
    if spec.mixer == "mamba":
        y, (conv, ssm) = mamba.mamba_forward(p, cfg, h, conv_state=state["conv"],
                                             ssm_state=state["ssm"])
        return y, {"conv": conv, "ssm": ssm}
    fwd = xlstm.mlstm_forward if spec.mixer == "mlstm" else xlstm.slstm_forward
    return fwd(p, cfg, h, state=state)


def _layer_extend(p, spec, cfg, x, cache, cache_len, route, *, lora=None,
                  lora_ids=None):
    """C-token extend over a gathered cache window, or from a state mixer's
    carried state (the twin of the reference's ``_layer_extend``); a
    whisper decoder layer then attends over its ``cross_k`` / ``cross_v``
    leaves. Returns (x, the layer's cache: the window written in place, or
    the new state)."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    if spec.mixer in STATE_MIXERS:
        y, cache = _state_extend(p["mixer"], spec, cfg, h, cache)
    elif spec.mixer == "mla":
        y, cache = mla.mla_extend(p["mixer"], cfg, spec, h, cache, cache_len, route)
    else:
        y, cache = attn.attn_extend(p["mixer"], cfg, spec, h, cache, cache_len,
                                    route, lora, lora_ids)
    x = x + y
    if "cross" in p:
        hc = apply_norm(cfg.norm, p["cross_norm"], x)
        x = x + attn.cross_attend(p["cross"], cfg, hc, cache["cross_k"], cache["cross_v"])
    return _ff_branch(p, spec, cfg, x, lora, lora_ids), cache


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

def ported_stack(cfg: ModelConfig) -> bool:
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
        if not ported_stack(cfg):
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
    def init(self, seed: int = 0, max_seq: int = 0) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        the model's device (JAX's init draws other bits for the same seed;
        parity tests convert the JAX weights instead). Learned positions
        draw ``max(learned_positions, max_seq)`` rows, as the reference's.
        No multi-token prediction block: the reference reads it only in its
        training forward, which the port does not have yet (ROADMAP A.2)."""
        cfg, dev, pdt = self.cfg, self.device, self.pdtype
        gen = torch.Generator(device=dev).manual_seed(seed)
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
        params["layers"] = [_layer_init(gen, spec, cfg, pdt, dev, cross=cross)
                            for spec in self.specs]
        if cross:
            params["encoder"] = {
                "layers": [_layer_init(gen, ENC_SPEC, cfg, pdt, dev)
                           for _ in range(cfg.encoder_layers)],
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

    def init_cache(self, batch: int, max_seq: int) -> List[Dict[str, torch.Tensor]]:
        """An empty gathered cache on the model's device, per layer: for
        each page leaf of ``cache_leaf_shapes`` a zeroed (batch, max_seq) +
        per-token shape window, {"k", "v"} (B, W, KV, D) for attention,
        {"c_kv": (B, W, r), "k_pe": (B, W, rope)} for MLA, in the
        activation dtype; then the layer's empty states (``init_state``: a
        state mixer's history, a whisper layer's cross K/V)."""
        out = []
        for spec, leaves in zip(self.specs, cache_leaf_shapes(self.cfg)):
            layer = {name: torch.zeros((batch, max_seq) + leaf.shape, dtype=leaf.dtype,
                                       device=self.device)
                     for name, leaf in leaves.items() if not leaf.state}
            layer.update(init_state(self.cfg, spec, batch, self.device))
            out.append(layer)
        return out

    # ---------------- shared helpers ----------------------------------------
    def embed_tokens(self, params, tokens):
        e = params["embed"][tokens.long()].to(self.dtype)
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

    def head(self, params, x):
        x = apply_norm(self.cfg.norm, params["final_norm"], x)
        w = params["embed"].t() if self.cfg.tie_embeddings \
            else params["lm_head"]["w"]
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))

    def run_encoder(self, params, frames):
        """frames: (B, T, d) post-frontend embeddings (the stubbed audio
        frontend's output). Sinusoidal positions, then the bidirectional
        encoder layers and its final norm. Returns (B, T, d)."""
        cfg = self.cfg
        T = frames.shape[1]
        x = frames.to(self.dtype) + sinusoidal_positions(
            T, cfg.d_model, frames.device).to(self.dtype)
        for p in params["encoder"]["layers"]:
            h = apply_norm(cfg.norm, p["norm1"], x)
            x = _ff_branch(p, ENC_SPEC, cfg, x + attn.attn_bidir(p["mixer"], cfg,
                                                                 ENC_SPEC, h))
        return apply_norm(cfg.norm, params["encoder"]["final_norm"], x)

    def cross_kv_all(self, params, enc):
        """Each decoder layer's cross K/V over the encoder states enc
        (B, T, d): a list over layers of {"cross_k", "cross_v"} (B, T, KV,
        D) in the activation dtype."""
        return [dict(zip(CROSS_LEAVES, attn.cross_kv(p["cross"], enc, self.dtype)))
                for p in params["layers"]]

    def splice_vision(self, params, tokens, vision_embeds, cache_len):
        """The token embeddings of a (B, C) chunk at positions [cache_len,
        cache_len + C), with the rows at absolute positions below N replaced
        by image rows ``vision_embeds`` (B, N, d): position i < N takes
        image row i. From cache_len 0 over the whole image, this is the
        reference's ``splice_vision`` (the image ahead of the text) with N
        placeholder tokens in front of the text."""
        x = self.embed_tokens(params, tokens)
        B, C, d = x.shape
        N = vision_embeds.shape[1]
        pos = cache_len.long()[:, None] + torch.arange(C, device=x.device)
        rows = vision_embeds.to(x.dtype).gather(
            1, pos.clamp(max=N - 1)[..., None].expand(B, C, d))
        return torch.where((pos < N)[..., None], rows, x)

    # ---------------- extend (gathered cache windows) -------------------------
    @torch.no_grad()
    def extend(self, params, tokens, cache, cache_len, lora=None, batch=None):
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
        after the chunk)."""
        cfg = self.cfg
        extras = batch or {}
        C = tokens.shape[1]
        if has_cross(cfg) and "audio_frames" in extras:
            enc = self.run_encoder(params, extras["audio_frames"])
            cache = [dict(c, **kv) for c, kv in zip(cache, self.cross_kv_all(params, enc))]
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
            x = self.splice_vision(params, tokens, extras["vision_embeds"], cache_len)
        else:
            x = self.embed_tokens(params, tokens)
        x = self.add_positions(params, x, cache_len.long()[:, None]
                               + torch.arange(C, device=x.device))
        tables, ids = _layer_lora(lora)
        out = []
        for p, spec, c, lt in zip(params["layers"], self.specs, cache, tables):
            x, c = _layer_extend(p, spec, self.cfg, x, c, cache_len, route, lora=lt,
                                 lora_ids=ids)
            out.append(c)
        return self.head(params, x), out

    # ---------------- decode_paged (one token) --------------------------------
    @torch.no_grad()
    def decode_paged(self, params, tokens, pages, block_tables, lengths,
                     lora=None):
        """tokens: (B, 1); pages: list over layers of {"k", "v"} (KV, NB, P,
        D), or quantized dicts with a per-step ``tail``; block_tables:
        (B, NP) shared by every layer; lengths: (B,) valid tokens before
        this one. ``lora``: the multi-tenant adapter operand ``{"ids": (B,)
        int32 slots on the model's device, "layers": [per-layer {site:
        {"a", "b"}} tables]}`` (``core/lora/store.py``), or None. Returns
        (logits (B, 1, V), pages, writes) with one {"k", "v"} (B, KV, D)
        entry per layer: the new token's K/V for the host-authoritative
        store."""
        x = self.add_positions(params, self.embed_tokens(params, tokens),
                               lengths.long()[:, None])
        writes = []
        tables, ids = _layer_lora(lora)
        for p, spec, pg, lt in zip(params["layers"], self.specs, pages, tables):
            x, _, (k_new, v_new) = _layer_decode_paged(
                p, spec, self.cfg, x, pg, block_tables, lengths, lora=lt,
                lora_ids=ids)
            writes.append({"k": k_new, "v": v_new})
        return self.head(params, x), pages, writes

    # ---------------- extend_paged (C-token chunks) --------------------------
    @torch.no_grad()
    def extend_paged(self, params, tokens, pages, block_tables, lengths,
                     chunk_lens=None, scratch_block: Optional[int] = None,
                     lora=None):
        """tokens: (B, C) at positions [lengths, lengths + C); pages /
        tables / lengths / lora as in ``decode_paged``. Ragged batches pass
        ``chunk_lens`` (B,) and a ``scratch_block`` for padded positions'
        writes; logits of padded positions are garbage the caller ignores.
        Returns (logits (B, C, V), pages, writes) with write leaves
        (B, C, KV, D)."""
        x = self.add_positions(params, self.embed_tokens(params, tokens),
                               lengths.long()[:, None]
                               + torch.arange(tokens.shape[1], device=tokens.device))
        writes = []
        tables, ids = _layer_lora(lora)
        for p, spec, pg, lt in zip(params["layers"], self.specs, pages, tables):
            x, _, (k_new, v_new) = _layer_extend_paged(
                p, spec, self.cfg, x, pg, block_tables, lengths,
                chunk_lens=chunk_lens, scratch_block=scratch_block, lora=lt,
                lora_ids=ids)
            writes.append({"k": k_new, "v": v_new})
        return self.head(params, x), pages, writes

    # ---------------- verify_paged (C tokens, every position real) ------------
    def verify_paged(self, params, tokens, pages, block_tables, lengths,
                     lora=None):
        """Score C tokens per sequence straight off the page stores: the
        speculative verify (the target scores k drafts + 1 bonus position in
        one forward) and the draft's paged catch-up. ``extend_paged`` with
        every position real, so no ``chunk_lens`` and no scratch page; on
        CUDA bf16 / f16 its attention is the paged kernel's native chunked
        path at ``rows_per_seq = C`` (fp32 folds). ``decode_paged`` is the
        C == 1 case. Returns (logits (B, C, V), pages, writes)."""
        return self.extend_paged(params, tokens, pages, block_tables, lengths,
                                 lora=lora)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
