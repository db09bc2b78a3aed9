"""GQA/MQA/MHA attention on paged KV stores and on gathered cache windows.

Twins of the paged family of ``repro.models.attention``: 3-D projections
(``(d, H, hd)`` in, ``(H, hd, d)`` out), RoPE at absolute positions, and
``attn_decode_paged`` / ``attn_extend_paged`` writing the new K/V into the
page stores before the paged-attention op attends over the block tables.
Unlike JAX, the page writes happen IN PLACE on the given tensors
(``index_put_``): the runner's device mirror is updated without a copy.
The functions still return the pages so call sites read like the JAX ones.
KIVI-quantized page stores (``quantized_pages``) take ``_attn_chunk_quant``:
the pages stay read-only and the step's K/V joins a full-precision tail.
Every step function takes an optional multi-tenant LoRA operand: ``lora``,
this layer's ``{site: {"a", "b"}}`` adapter tables, and ``lora_ids`` (B,),
each row's table slot; the per-row deltas are added in place to the
projections' outputs by ``bgmv_add``: one launch for wq, wk and wv, one
for wo.

The gathered backend's chunk attention, ``attn_extend`` (the twin of
``repro.models.model._attn_extend``), writes a chunk's K/V into a dense
``(B, W, KV, D)`` cache window and splits the batch's rows by route
(``extend_route``): a FRESH row (nothing cached, queries at 0..C-1) is
exactly the causal prefill ``kernels/flash_attention`` computes, so it
goes to ``ops.flash_prefill`` (the CUDA kernel on the card); a
CONTINUATION row (decodes, later chunks, chunks after a prefix-cache hit)
goes to ``flash_attention``, the plain twin of the reference's blockwise
``lax`` attention, with per-row positions and ``kv_valid``. Global,
sliding-window and chunked (llama4) kinds; a chunked layer's fresh row
takes the kernel only while its chunk lies inside the first attention
chunk, where the chunk mask is plain causal (``fresh_rows_take_kernel``).
Under tensor parallelism (the sharded paged runner) each rank runs these
functions on its shard-local heads, and ``proj_out_lora`` takes the rank's
model group ``tp``: the local output projection (and its ``wo`` LoRA
delta) is a partial sum that one all-reduce completes before the bias.
``attn_extend`` and ``attn_decode`` take the same ``tp`` in a
tensor-parallel prefill or decode step (``launch/steps.py``), the cache
holding the rank's KV heads or all of them (``local_kv`` picks the ones a
contiguous split's heads read).

The contiguous decode path (the twin of the reference's ``attn_decode``,
which only ``Model.decode`` calls): ``attn_decode`` writes one token's K/V
into a ``(B, Smax, KV, D)`` cache in place and attends through
``decode_attention`` (global, window and chunked masks, or a given
validity), in the reference's rounding: f32 products of the cache in its
own dtype, the normalized probabilities cast to the V cache's dtype before
the PV product. Under the rules' "window_ring" option a window layer whose
cache is at most ``sliding_window + 1024`` wide holds a RING over absolute
positions (``window_ring_applies``): slot ``pos % W``. Handed a ``cp``
group (context parallelism, ``decode_attention_cp``), each rank holds its
slice of the cache's sequence and the shards' (m, l, o) merge in two
all-reduces. Plain PyTorch, as the reference computes all three outside
Pallas.

whisper's encoder self-attention (``attn_forward`` with ``causal=False``)
and its decoder's cross-attention over the encoder states
(``cross_attend``) are not causal, so ``flash_prefill`` cannot take them:
both are the plain ``flash_attention`` with ``causal=False``, as the
reference computes them outside Pallas. The training forward
(``attn_forward``) also runs the plain ``flash_attention``, causal, under
autograd: the reference's ``value_and_grad`` differentiates its plain
blockwise attention, never a Pallas kernel, and no kernel here has a
backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_prefill
from repro_torch.kernels.lora.ops import bgmv_add
from repro_torch.kernels.paged_attention import (paged_attend, paged_attend_extend,
                                                paged_attend_extend_quant)
from repro_torch.models.common import apply_rope, normal_init
from repro_torch.sharding.collectives import copy_to_model, reduce_from_model
from repro_torch.sharding.rules import current_rules

NEG_INF = -1e30


def make_attention_params(gen, cfg, dtype, device):
    """Projections stored 3-D — (d_model, heads, head_dim) — as in JAX, so
    converted weights keep their layout."""
    d = cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)

    def proj(heads):
        p = {"w": normal_init(gen, (d, heads, hd), dtype, s, device)}
        if cfg.qkv_bias:
            p["b"] = torch.zeros((heads, hd), dtype=dtype, device=device)
        return p

    p = {"wq": proj(H), "wk": proj(KV), "wv": proj(KV),
         "wo": {"w": normal_init(gen, (H, hd, d), dtype,
                                 1.0 / math.sqrt(H * hd), device)}}
    if cfg.attn_out_bias:
        p["wo"]["b"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def attention_param_axes(cfg):
    """The logical axes of ``make_attention_params``' leaves, as the
    reference names them: q-side projections and ``wo``'s rows over
    "heads", k and v over "kv_heads"."""
    def proj(axis):
        p = {"w": ("embed", axis, None)}
        if cfg.qkv_bias:
            p["b"] = (axis, None)
        return p

    p = {"wq": proj("heads"), "wk": proj("kv_heads"), "wv": proj("kv_heads"),
         "wo": {"w": ("heads", None, "embed")}}
    if cfg.attn_out_bias:
        p["wo"]["b"] = ("embed",)
    return p


def proj_qkv(p, x):
    """x: (B, S, d) -> (B, S, heads, hd), contiguous (the LoRA epilogue
    writes into it as (B, S, heads * hd))."""
    y = torch.einsum("bsd,dhk->bshk", x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def proj_out(p, x):
    """x: (B, S, H, hd) -> (B, S, d)."""
    y = torch.einsum("bshk,hkd->bsd", x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def _qkv(p, cfg, x, lora=None, lora_ids=None):
    """q, k, v (B, C, heads, hd). With ``lora``, each row's adapter delta
    is added after the bias (and before RoPE, which the callers apply): the
    three sites in one ``bgmv_add`` launch, into the projections in place
    (viewed as (B, C, heads * hd), which raises if they are not contiguous)."""
    q, k, v = proj_qkv(p["wq"], x), proj_qkv(p["wk"], x), proj_qkv(p["wv"], x)
    if lora is not None:
        B, C, _ = x.shape
        outs = bgmv_add(x, lora_ids, [(lora[n]["a"], lora[n]["b"], t.view(B, C, -1))
                                      for n, t in (("wq", q), ("wk", k), ("wv", v))])
        q, k, v = (o.view(t.shape) for o, t in zip(outs, (q, k, v)))
    return q, k, v


def proj_out_lora(p_wo, x, lora=None, lora_ids=None, tp=None):
    """``proj_out`` plus the per-row ``wo`` adapter delta, added after the
    bias (in place, by ``bgmv_add``); the adapter's input is the
    pre-projection (B, C, H, hd) flattened to H * hd.

    With ``tp`` (a rank's model group, ``launch/mesh.AxisGroup``: the
    sharded paged path and the sharded train step) ``x`` holds this rank's
    heads and ``wo`` the matching rows, so the product — and the ``wo``
    delta, whose A factor is sharded over the same flattened head axis —
    are PARTIAL sums: the delta goes into the product with no bias, one
    all-reduce (``reduce_from_model``) completes both, and the replicated
    bias comes last (summed across ranks it would count once per rank). The twin of the JAX ``proj_out_lora`` with
    ``tp_axis``; without ``tp`` the single-device order is kept."""
    if tp is None:
        out = proj_out(p_wo, x)
    else:
        out = torch.einsum("bshk,hkd->bsd", x, p_wo["w"])
    if lora is not None:
        B, C, H, hd = x.shape
        out, = bgmv_add(x.reshape(B, C, H * hd), lora_ids,
                        [(lora["wo"]["a"], lora["wo"]["b"], out)])
    if tp is not None:
        out = reduce_from_model(out, tp)
        if "b" in p_wo:
            out = out + p_wo["b"]
    return out


def _uses_rope(cfg, spec) -> bool:
    return cfg.use_rope and not (cfg.nope_on_global and spec.attn_kind == "global")


def _scale(cfg) -> float:
    return cfg.softmax_scale or 1.0 / math.sqrt(cfg.head_dim)


def local_kv(t, cfg, tp, dim: int):
    """The KV heads of ``t`` (along ``dim``) that a rank's query heads read.
    Where a contiguous head split meets replicated KV heads (``tp_layout``'s
    ``kv_contiguous``: cfg.num_heads = Hl local heads, Hl % KV != 0) local
    head l is global head index * Hl + l and reads KV head (index * Hl +
    l) // G: a view of those KV heads where each takes an equal run of
    local heads (Hl < G: one KV head), else one KV head per local head
    (``index_select``). Everywhere else (no group, KV heads cut, the
    permuted split) ``t`` as it is."""
    KV = t.shape[dim]
    Hl = cfg.num_heads
    if tp is None or Hl % KV == 0:
        return t
    G = Hl * tp.size // KV
    kv = (tp.index * Hl + np.arange(Hl)) // G
    lo, n = int(kv[0]), int(kv[-1]) - int(kv[0]) + 1
    if Hl % n == 0 and np.array_equal(kv, lo + np.arange(Hl) // (Hl // n)):
        return t.narrow(dim, lo, n)
    return t.index_select(dim, torch.from_numpy(kv).to(t.device))


def quantized_pages(pages) -> bool:
    """Whether a paged K/V dict holds KIVI-quantized stores (codes + scale/
    zero planes) instead of fp page tensors."""
    return isinstance(pages.get("k"), dict) and "codes" in pages["k"]


def _attn_chunk_quant(p, cfg, spec, x, pages, block_tables, lengths,
                      lora=None, lora_ids=None, tp=None):
    """C-token attention against KIVI-quantized page stores.

    ``pages[name]`` holds uint8 ``codes`` and f16 ``scale``/``zero`` planes
    for every FILLED page, and a per-step ``tail`` (B, P + C, KV, D) in the
    cache dtype: slot i holds position ``tail_start + i`` with
    ``tail_start = lengths // P * P``, i.e. each sequence's still-filling
    page, then C empty slots. This step's C tokens are written into their
    tail slots ``(lengths - tail_start) + j`` — in place, on the per-step
    tail, never into the quantized pages: a page packs on the host when it
    fills — and come back in ``(k_new, v_new)`` for the host writeback. The
    C query positions attend through ``paged_attend_extend_quant``: row
    (b, j) sees the quantized positions [0, tail_start_b) plus tail tokens
    up to its own. A chunk crossing several page fills works unchanged,
    since the tail covers [tail_start, tail_start + P + C). Padded positions
    of ragged chunks land in the row's own tail past its valid length, which
    nothing reads, so no scratch redirect is needed.

    Returns (out (B, C, d), pages unchanged, (k_new, v_new)) with
    k_new/v_new (B, C, KV, D) in the cache dtype."""
    B, C, _ = x.shape
    q, k, v = _qkv(p, cfg, x, lora, lora_ids)
    pos = lengths.long()[:, None] + torch.arange(C, device=x.device)
    if _uses_rope(cfg, spec):
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    k_tail, v_tail = pages["k"]["tail"], pages["v"]["tail"]
    dt = k_tail.dtype  # the cache's logical (at-rest) dtype
    k_new = k.to(dt)  # (B, C, KV, D)
    v_new = v.to(dt)
    P = pages["k"]["codes"].shape[2]
    lengths = lengths.long()
    tail_start = lengths // P * P
    bidx = torch.arange(B, device=x.device)[:, None]
    slots = (lengths - tail_start)[:, None] + torch.arange(C, device=x.device)
    k_tail[bidx, slots] = k_new
    v_tail[bidx, slots] = v_new
    out = paged_attend_extend_quant(q, pages["k"], pages["v"], k_tail, v_tail,
                                    block_tables, lengths, tail_start,
                                    scale=_scale(cfg), deq_dtype=dt)
    return proj_out_lora(p["wo"], out, lora, lora_ids, tp), pages, (k_new, v_new)


def attn_decode_paged(p, cfg, spec, x, pages, block_tables, lengths,
                      lora=None, lora_ids=None, tp=None):
    """One-token decode directly against block-indexed page stores.

    x: (B, 1, d); pages: {"k", "v"}: (KV, NB, P, D); block_tables: (B, NP);
    lengths: (B,) valid tokens BEFORE this one. The new token's K/V is
    written in place into page [lengths // P, lengths % P], then the
    paged-attention op attends with ``lengths + 1`` valid tokens. Returns
    (out (B, 1, d), pages, (k_new, v_new)) with k_new/v_new (B, KV, D) for
    the host-store writeback. Quantized stores (``quantized_pages``) take
    ``_attn_chunk_quant`` with C = 1. ``tp``: the rank's model group on
    the sharded path (``proj_out_lora``)."""
    if quantized_pages(pages):
        out, pages, (k_new, v_new) = _attn_chunk_quant(
            p, cfg, spec, x, pages, block_tables, lengths, lora, lora_ids, tp)
        return out, pages, (k_new[:, 0], v_new[:, 0])
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x, lora, lora_ids)
    pos = lengths.long()
    if _uses_rope(cfg, spec):
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    P = pages["k"].shape[2]
    blk = block_tables[torch.arange(B, device=x.device), pos // P].long()
    off = pos % P
    k_new = k[:, 0].to(pages["k"].dtype)  # (B, KV, D)
    v_new = v[:, 0].to(pages["v"].dtype)
    pages["k"][:, blk, off] = k_new.transpose(0, 1)
    pages["v"][:, blk, off] = v_new.transpose(0, 1)
    out = paged_attend(q, pages["k"], pages["v"], block_tables, pos + 1,
                       scale=_scale(cfg))
    return proj_out_lora(p["wo"], out, lora, lora_ids, tp), pages, (k_new, v_new)


def attn_extend_paged(p, cfg, spec, x, pages, block_tables, lengths, *,
                      chunk_lens=None, scratch_block=None, lora=None,
                      lora_ids=None, tp=None):
    """Multi-token extend directly against block-indexed page stores.

    x: (B, C, d) — C new tokens per sequence at positions [lengths,
    lengths + C). All C tokens' K/V are written in place first (writes span
    page boundaries: ``blk = table[pos // P]`` per position), then the C
    query positions attend through ``paged_attend_extend``. Ragged batches
    pass ``chunk_lens`` (B,): padded positions ``j >= chunk_lens[b]``
    redirect their write to ``scratch_block``, a block outside every real
    table, so duplicate write indices can only collide there.

    Returns (out (B, C, d), pages, (k_new, v_new)) with k_new/v_new
    (B, C, KV, D). Quantized stores take ``_attn_chunk_quant`` (fp tail, no
    page writes, no scratch needed)."""
    if quantized_pages(pages):
        return _attn_chunk_quant(p, cfg, spec, x, pages, block_tables, lengths,
                                 lora, lora_ids, tp)
    B, C, _ = x.shape
    q, k, v = _qkv(p, cfg, x, lora, lora_ids)
    pos = lengths.long()[:, None] + torch.arange(C, device=x.device)
    if _uses_rope(cfg, spec):
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    P = pages["k"].shape[2]
    page_idx = pos // P
    padded = None
    if chunk_lens is not None:
        padded = torch.arange(C, device=x.device)[None, :] >= \
            chunk_lens.long()[:, None]
        # a padded position may run past the table; it never reads it
        page_idx = torch.where(padded, torch.zeros_like(page_idx), page_idx)
    blk = block_tables[torch.arange(B, device=x.device)[:, None],
                       page_idx].long()
    if padded is not None:
        blk = torch.where(padded, torch.full_like(blk, int(scratch_block)), blk)
    blk = blk.reshape(B * C)
    off = (pos % P).reshape(B * C)
    k_new = k.to(pages["k"].dtype)  # (B, C, KV, D)
    v_new = v.to(pages["v"].dtype)
    pages["k"][:, blk, off] = k_new.reshape((B * C,) + k_new.shape[2:]).transpose(0, 1)
    pages["v"][:, blk, off] = v_new.reshape((B * C,) + v_new.shape[2:]).transpose(0, 1)
    out = paged_attend_extend(q, pages["k"], pages["v"], block_tables, lengths,
                              scale=_scale(cfg))
    return proj_out_lora(p["wo"], out, lora, lora_ids, tp), pages, (k_new, v_new)


# ---------------------------------------------------------------------------
# gathered cache windows: masks, plain attention, chunk extend
# ---------------------------------------------------------------------------

def pair_mask(q_pos, k_pos, kind: str, *, window: int = 0, chunk: int = 0,
              causal: bool = True):
    """(..., Sq) and (..., Sk) absolute positions -> bool (..., Sq, Sk),
    True = attend. Kinds ``global``, ``window`` (keys within ``window``
    positions) and ``chunked`` (keys in the query's ``chunk``-token chunk)."""
    if kind not in ("global", "window", "chunked"):
        raise ValueError(f"unknown attention kind {kind!r}")
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = (k <= q) if causal else torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                                          dtype=torch.bool, device=q.device)
    if kind == "window" and window:
        m = m & (k > q - window)
    elif kind == "chunked" and chunk:
        m = m & ((k // chunk) == (q // chunk))
    return m


def flash_attention(q, k, v, *, q_pos, k_pos, kind: str = "global",
                    window: int = 0, chunk: int = 0, scale: float,
                    causal: bool = True, kv_valid: Optional[torch.Tensor] = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D); GQA via head grouping.
    q_pos: (Sq,) or (B, Sq), k_pos: (Sk,) or (B, Sk) absolute positions;
    kv_valid: (B, Sk) bool. Returns (B, Sq, H, Dv) in q's dtype; a row
    with no valid key gives 0.

    The plain twin of ``repro.models.attention.flash_attention``: the same
    masks and f32 softmax, computed in one pass over all Sk keys instead of
    the reference's blockwise online softmax (the same function; the sums
    run in another order)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    q_pos = torch.broadcast_to(torch.atleast_2d(q_pos), (B, Sq))
    k_pos = torch.broadcast_to(torch.atleast_2d(k_pos), (B, Sk))
    valid = pair_mask(q_pos, k_pos, kind, window=window, chunk=chunk,
                      causal=causal)  # (B, Sq, Sk)
    if kv_valid is not None:
        valid = valid & kv_valid[:, None, :]
    valid = valid[:, None, None]  # (B, 1, 1, Sq, Sk)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KV, G, D).float(),
                     k.float()) * scale
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # (B, Sq, KV, G, 1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = torch.where(l > 0, o / torch.clamp_min(l, 1e-30), 0.0)
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


@dataclasses.dataclass
class ExtendRoute:
    """How one gathered extend call splits its rows, computed once from the
    rows' cache lengths and shared by every layer.

    ``fresh`` / ``cont``: (n,) row indices with ``cache_len == 0`` /
    ``> 0`` on the model's device. ``wb, wc, wp``: for every chunk slot
    whose position falls inside the W-slot window, its row, its offset in
    the chunk and its window position (slots past the window are dropped,
    as JAX's scatter drops out-of-bounds updates)."""
    fresh: torch.Tensor
    cont: torch.Tensor
    wb: torch.Tensor
    wc: torch.Tensor
    wp: torch.Tensor


def extend_route(cache_len: torch.Tensor, C: int, W: int) -> ExtendRoute:
    """The row split and window-write indices of one extend call (one host
    read of ``cache_len``, one upload of the indices). A ``cache_len`` on
    the meta device holds no values: the dry-run's prefill from an empty
    cache, every row fresh."""
    dev = cache_len.device
    cl = torch.zeros(cache_len.shape, dtype=torch.long) if dev.type == "meta" \
        else cache_len.long().cpu()
    pos = cl[:, None] + torch.arange(C)
    wb, wc = torch.nonzero(pos < W, as_tuple=True)
    idx = [torch.nonzero(cl == 0)[:, 0], torch.nonzero(cl > 0)[:, 0],
           wb, wc, pos[wb, wc]]
    return ExtendRoute(*(t.to(dev) for t in idx))


def fresh_rows_take_kernel(cfg, spec, C: int) -> bool:
    """Whether this layer's fresh rows of a C-wide chunk go to
    ``flash_prefill``: global and window attention layers always; a chunked
    layer only while the chunk lies inside the first attention chunk (C <=
    chunk_size), where its mask is plain causal. Otherwise they take
    ``flash_attention`` with the chunk mask, as continuation rows do. An MLA
    layer never does: its queries and keys are nope + rope wide and its
    values v wide, and the kernel takes one head dim (``models/mla.py``);
    nor does a state mixer (Mamba, mLSTM, sLSTM), which attends to
    nothing."""
    if spec.mixer != "attn":
        return False
    return spec.attn_kind != "chunked" or not cfg.chunk_size or C <= cfg.chunk_size


def attn_extend(p, cfg, spec, x, cache, cache_len, route: ExtendRoute,
                lora=None, lora_ids=None, tp=None):
    """Write a chunk's K/V at [cache_len, cache_len + C) of the cache window
    and attend. x: (B, C, d); cache: {"k", "v"} (B, W, KV, D), written IN
    PLACE; cache_len: (B,) tokens already in the window. Where
    ``fresh_rows_take_kernel`` holds, fresh rows go to ``flash_prefill``
    over their own first C positions (the window holds nothing else for
    them; a ragged row's padded queries are garbage no one reads, and
    causality keeps its real queries off the padding's K/V); the other rows
    go to ``flash_attention`` over the whole window with ``kv_valid =
    position < cache_len + C``, as the reference attends. Returns (out (B,
    C, d), cache)."""
    B, C, _ = x.shape
    q, k, v = _qkv(p, cfg, x, lora, lora_ids)
    pos = cache_len.long()[:, None] + torch.arange(C, device=x.device)
    if _uses_rope(cfg, spec):
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    k_new = k.to(cache["k"].dtype)  # (B, C, KV, D)
    v_new = v.to(cache["v"].dtype)
    cache["k"][route.wb, route.wp] = k_new[route.wb, route.wc]
    cache["v"][route.wb, route.wp] = v_new[route.wb, route.wc]
    window = cfg.sliding_window if spec.attn_kind == "window" else 0
    scale = _scale(cfg)
    nk = len(route.fresh) if fresh_rows_take_kernel(cfg, spec, C) else 0

    def rows(t, idx):  # no copy when idx is None: every row
        return t if idx is None else t.index_select(0, idx)

    out = None
    if nk:
        ki = None if nk == B else route.fresh
        # (B, C, heads, D) read through its strides as (B, heads, C, D)
        out = flash_prefill(rows(q, ki).transpose(1, 2),
                            local_kv(rows(k_new, ki), cfg, tp, 2).transpose(1, 2),
                            local_kv(rows(v_new, ki), cfg, tp, 2).transpose(1, 2),
                            scale=scale, window=window).transpose(1, 2)
    if nk < B:
        pi = route.cont if nk else None  # the continuation rows, or every row
        W = cache["k"].shape[1]
        kpos = torch.arange(W, device=x.device)
        oc = flash_attention(
            rows(q, pi), local_kv(rows(cache["k"], pi), cfg, tp, 2),
            local_kv(rows(cache["v"], pi), cfg, tp, 2),
            q_pos=rows(pos, pi), k_pos=kpos, kind=spec.attn_kind,
            window=cfg.sliding_window, chunk=cfg.chunk_size, scale=scale,
            kv_valid=kpos[None, :] < (rows(cache_len.long(), pi)[:, None] + C))
        if out is None:
            out = oc
        else:
            full = q.new_empty(q.shape)
            full.index_copy_(0, route.fresh, out)
            full.index_copy_(0, pi, oc)
            out = full
    return proj_out_lora(p["wo"], out, lora, lora_ids, tp), cache


# ---------------------------------------------------------------------------
# contiguous cache: one-token decode, the window ring, context parallelism
# ---------------------------------------------------------------------------

def _decode_valid(pos, L, kind: str, window: int, chunk: int):
    """Which cache positions ``pos`` (1, S) a row with ``L`` (B, 1) valid
    entries (the decoded token's included) attends to: (B, S) bool."""
    valid = pos < L
    if kind == "window" and window:
        valid = valid & (pos > L - 1 - window)
    elif kind == "chunked" and chunk:
        valid = valid & ((pos // chunk) == ((L - 1) // chunk))
    return valid


def decode_attention(q, k_cache, v_cache, total_len, *, kind: str = "global",
                     window: int = 0, chunk: int = 0, scale: float,
                     valid_override=None):
    """q: (B, 1, H, D); caches: (B, Smax, KV, D); total_len: (B,) valid
    cache entries including the token being decoded; ``valid_override``
    (B, Smax) bool replaces the mask. The twin of the reference's
    ``decode_attention``: scores are f32 products of q and the cache in
    their own dtypes, and ``p / max(l, 1e-30)`` is cast to the V cache's
    dtype before the PV product (f32 accumulation); the result is in q's
    dtype."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G, Dv = H // KV, v_cache.shape[-1]
    if valid_override is not None:
        valid = valid_override
    else:
        valid = _decode_valid(torch.arange(S, device=q.device)[None, :],
                              total_len.long()[:, None], kind, window, chunk)
    valid = valid[:, None, None, :]
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KV, G, D).float(),
                     k_cache.float()) * scale
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    p = (p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def cp_combine(m_loc, l_loc, o_loc, cp):
    """Merge each rank's flash-decode partial over the context-parallel
    group ``cp`` by exactly two all-reduces: the max of ``m_loc`` (...),
    then one sum of ``l_loc * alpha`` (...) and ``o_loc * alpha`` (..., D)
    packed into one tensor, alpha = exp(m_loc - max). All f32; returns
    ``o / max(l, 1e-30)`` (..., D), equal on every rank (the reference: one
    pmax and two psums of the same values)."""
    m_g = cp.all_reduce(m_loc.clone(), op="max")
    alpha = torch.exp(m_loc - m_g)[..., None]
    lo = cp.all_reduce(torch.cat([l_loc[..., None] * alpha, o_loc * alpha], dim=-1))
    return lo[..., 1:] / torch.clamp_min(lo[..., :1], 1e-30)


def decode_attention_cp(q, k_cache, v_cache, total_len, *, cp, kind: str = "global",
                        window: int = 0, chunk: int = 0, scale: float):
    """Context-parallel decode attention (the twin of the reference's
    ``decode_attention_cp``): this rank of the group ``cp``
    (``launch/mesh.AxisGroup``) holds cache slots [index * S_loc, (index +
    1) * S_loc) of every row, k_cache / v_cache (B, S_loc, KV, D). Each rank
    takes its flash-decode partial (m, l, o) in f32 (q, k and v upcast, as
    the reference does) and the shards merge by exactly two all-reduces:
    the max of m, then one sum of l * alpha and o * alpha packed into one
    tensor (``cp_combine``). Returns (B, 1, H, Dv) in q's dtype, equal on
    every rank."""
    B, _, H, D = q.shape
    S_loc, KV = k_cache.shape[1], k_cache.shape[2]
    G, Dv = H // KV, v_cache.shape[-1]
    pos = cp.index * S_loc + torch.arange(S_loc, device=q.device)[None, :]
    valid = _decode_valid(pos, total_len.long()[:, None], kind, window, chunk)
    valid = valid[:, None, None, :]
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KV, G, D).float(),
                     k_cache.float()) * scale
    s = torch.where(valid, s, NEG_INF)
    m_loc = s.amax(dim=-1)  # (B, KV, G)
    p = torch.where(valid, torch.exp(s - m_loc[..., None]), 0.0)
    o_loc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    o = cp_combine(m_loc, p.sum(dim=-1), o_loc, cp)
    return o.reshape(B, 1, H, Dv).to(q.dtype)


def window_ring_applies(cfg, spec, width: int, rules=None) -> bool:
    """Whether a layer's ``width``-slot cache is a ring over its sliding
    window (the reference's condition): the rules in force (``rules``, or
    ``current_rules()``) carry the "window_ring" option, the layer is
    window attention and the cache is at most ``sliding_window + 1024``
    wide."""
    rules = current_rules() if rules is None else rules
    return bool(rules is not None and rules.opt("window_ring") and spec.attn_kind == "window"
                and cfg.sliding_window and width <= cfg.sliding_window + 1024)


def attn_decode(p, cfg, spec, x, cache, cache_len, cp=None, tp=None):
    """One-token decode over a contiguous cache (the twin of the
    reference's ``attn_decode``). x: (B, 1, d); cache: {"k", "v"} (B, Smax,
    KV, D), written IN PLACE; cache_len: (B,) entries before this token,
    each row's new position (``Model.decode`` has checked that it lies in
    the cache). RoPE at that position where the layer uses it.

    * A ring (``window_ring_applies``): the token goes to slot ``pos % W``;
      slot j holds absolute position ``p_abs = L - ((L - j) % W)`` (the
      largest p <= L with p % W == j), valid where ``p_abs >= 0`` and
      ``p_abs > L - sliding_window``; global ``decode_attention`` over
      that mask. Keys are stored roped at their absolute positions, so a
      slot is reused without recomputation. Under ``cp`` every rank holds
      the whole ring and runs it so.
    * ``cp`` (a rank's ``AxisGroup``; the cache is its slice of the
      sequence): only the rank owning slot ``pos`` writes the token, then
      ``decode_attention_cp``.
    * Otherwise the token goes to slot ``pos`` and ``decode_attention``
      masks the layer's kind.

    ``tp``: as in ``attn_extend`` (the rank's heads, ``local_kv`` of the
    cache, one all-reduce after ``wo``). Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    pos = cache_len.long()
    if _uses_rope(cfg, spec):
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    k_new = k[:, 0].to(cache["k"].dtype)  # (B, KV, D)
    v_new = v[:, 0].to(cache["v"].dtype)
    bidx = torch.arange(B, device=x.device)
    W = cache["k"].shape[1]
    scale = _scale(cfg)
    if window_ring_applies(cfg, spec, W):
        slot = pos % W
        cache["k"][bidx, slot] = k_new
        cache["v"][bidx, slot] = v_new
        L = pos[:, None]
        p_abs = L - ((L - torch.arange(W, device=x.device)[None, :]) % W)
        valid = (p_abs >= 0) & (p_abs > L - cfg.sliding_window)
        out = decode_attention(q, local_kv(cache["k"], cfg, tp, 2),
                               local_kv(cache["v"], cfg, tp, 2), pos + 1, kind="global",
                               scale=scale, valid_override=valid)
    elif cp is not None:
        local = pos - cp.index * W
        mine = ((local >= 0) & (local < W))[:, None, None]
        at = local.clamp(0, W - 1)
        # rows another rank owns write back what the slot holds
        cache["k"][bidx, at] = torch.where(mine, k_new, cache["k"][bidx, at])
        cache["v"][bidx, at] = torch.where(mine, v_new, cache["v"][bidx, at])
        out = decode_attention_cp(q, local_kv(cache["k"], cfg, tp, 2),
                                  local_kv(cache["v"], cfg, tp, 2), pos + 1, cp=cp,
                                  kind=spec.attn_kind, window=cfg.sliding_window,
                                  chunk=cfg.chunk_size, scale=scale)
    else:
        cache["k"][bidx, pos] = k_new
        cache["v"][bidx, pos] = v_new
        out = decode_attention(q, local_kv(cache["k"], cfg, tp, 2),
                               local_kv(cache["v"], cfg, tp, 2), pos + 1, kind=spec.attn_kind,
                               window=cfg.sliding_window, chunk=cfg.chunk_size,
                               scale=scale)
    return proj_out_lora(p["wo"], out, tp=tp), cache


def init_attn_cache(cfg, batch, max_seq, dtype, device):
    """An empty contiguous cache {"k", "v"} (batch, max_seq, KV, D)."""
    kv = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# whole sequences (training, whisper's encoder) and cross-attention
# ---------------------------------------------------------------------------

def _kv_cut(p, cfg) -> bool:
    """Whether ``p`` holds a cut of the KV heads (the rank's, where they
    divide the model group) rather than all of them."""
    return p["wk"]["w"].shape[1] < cfg.num_kv_heads


def attn_forward(p, cfg, spec, x, positions, *, causal=True, tp=None):
    """Self-attention over a whole sequence, the twin of the reference's
    ``attn_forward``: the training forward (causal, every kind) and
    whisper's encoder (``causal=False``, every position attending to every
    other). x: (B, S, d); positions: (S,). Through the plain
    ``flash_attention`` under autograd, as the reference's training forward
    runs its plain blockwise attention, not the Pallas kernel. Returns
    (B, S, d).

    ``tp``: the rank's model group in the sharded train step; ``p`` holds
    the rank's query heads (in ``tp_layout``'s order) and ``wo`` rows, and
    its KV heads where they divide the group. x enters the rank's
    projections through ``copy_to_model``; K/V heads kept whole are
    projected from x on every rank and enter through ``copy_to_model``
    themselves, so their weights' gradients are whole on every rank; the
    local output projection is summed as the sharded paged path sums it
    (``proj_out_lora``'s ``tp``)."""
    if tp is not None:
        xm = copy_to_model(x, tp)
        q = proj_qkv(p["wq"], xm)
        if _kv_cut(p, cfg):
            k, v = proj_qkv(p["wk"], xm), proj_qkv(p["wv"], xm)
        else:
            k = copy_to_model(proj_qkv(p["wk"], x), tp)
            v = copy_to_model(proj_qkv(p["wv"], x), tp)
    else:
        q, k, v = _qkv(p, cfg, x)
    if _uses_rope(cfg, spec):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k, v = local_kv(k, cfg, tp, 2), local_kv(v, cfg, tp, 2)
    out = flash_attention(q, k, v, q_pos=positions, k_pos=positions, kind=spec.attn_kind,
                          window=cfg.sliding_window, chunk=cfg.chunk_size,
                          scale=_scale(cfg), causal=causal)
    return proj_out_lora(p["wo"], out, tp=tp)


def cross_kv(p, enc, dtype, cfg=None, tp=None):
    """A decoder layer's cross-attention keys and values over the encoder
    states enc (B, T, d): two (B, T, KV, D) tensors in ``dtype``. ``tp``
    (with ``cfg``): the sharded train step's model group, whose KV heads
    ``p`` holds where they divide it; enc enters them through
    ``copy_to_model`` (whole KV heads: their K/V enter the rank's query
    heads so), so its gradient comes out whole on every rank."""
    if tp is not None and _kv_cut(p, cfg):
        enc = copy_to_model(enc, tp)
    k, v = proj_qkv(p["wk"], enc).to(dtype), proj_qkv(p["wv"], enc).to(dtype)
    if tp is not None and not _kv_cut(p, cfg):
        k, v = copy_to_model(k, tp), copy_to_model(v, tp)
    return k, v


def cross_attend(p, cfg, x, enc_k, enc_v, tp=None):
    """Cross-attention of x (B, S, d) over every encoder position of
    enc_k / enc_v (B, T, KV, D), at the scale 1/sqrt(head_dim) (the
    reference's ``_cross_attend``, which reads no ``softmax_scale``).
    ``tp``: the rank's query heads and ``wo`` rows, x entering through
    ``copy_to_model``, one ``reduce_from_model`` after ``wo`` (before its
    bias). Returns (B, S, d)."""
    S, T = x.shape[1], enc_k.shape[1]
    q = proj_qkv(p["wq"], copy_to_model(x, tp))
    enc_k, enc_v = local_kv(enc_k, cfg, tp, 2), local_kv(enc_v, cfg, tp, 2)
    out = flash_attention(q, enc_k, enc_v, q_pos=torch.arange(S, device=x.device),
                          k_pos=torch.arange(T, device=x.device), kind="global",
                          scale=1.0 / math.sqrt(cfg.head_dim), causal=False)
    return proj_out_lora(p["wo"], out, tp=tp)
