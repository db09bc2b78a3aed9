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
Tensor parallelism comes with its own slice.

whisper's encoder self-attention (``attn_bidir``) and its decoder's
cross-attention over the encoder states (``cross_attend``) are not causal,
so ``flash_prefill`` cannot take them: both are the plain
``flash_attention`` with ``causal=False``, as the reference computes them
outside Pallas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_prefill
from repro_torch.kernels.lora.ops import bgmv_add
from repro_torch.kernels.paged_attention import (paged_attend, paged_attend_extend,
                                                paged_attend_extend_quant)
from repro_torch.models.common import apply_rope, normal_init

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


def proj_out_lora(p_wo, x, lora=None, lora_ids=None):
    """``proj_out`` plus the per-row ``wo`` adapter delta, added after the
    bias (in place, by ``bgmv_add``); the adapter's input is the
    pre-projection (B, C, H, hd) flattened to H * hd. The single-device case
    of the JAX ``proj_out_lora``."""
    out = proj_out(p_wo, x)
    if lora is not None:
        B, C, H, hd = x.shape
        out, = bgmv_add(x.reshape(B, C, H * hd), lora_ids,
                        [(lora["wo"]["a"], lora["wo"]["b"], out)])
    return out


def _uses_rope(cfg, spec) -> bool:
    return cfg.use_rope and not (cfg.nope_on_global and spec.attn_kind == "global")


def _scale(cfg) -> float:
    return cfg.softmax_scale or 1.0 / math.sqrt(cfg.head_dim)


def quantized_pages(pages) -> bool:
    """Whether a paged K/V dict holds KIVI-quantized stores (codes + scale/
    zero planes) instead of fp page tensors."""
    return isinstance(pages.get("k"), dict) and "codes" in pages["k"]


def _attn_chunk_quant(p, cfg, spec, x, pages, block_tables, lengths,
                      lora=None, lora_ids=None):
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
    return proj_out_lora(p["wo"], out, lora, lora_ids), pages, (k_new, v_new)


def attn_decode_paged(p, cfg, spec, x, pages, block_tables, lengths,
                      lora=None, lora_ids=None):
    """One-token decode directly against block-indexed page stores.

    x: (B, 1, d); pages: {"k", "v"}: (KV, NB, P, D); block_tables: (B, NP);
    lengths: (B,) valid tokens BEFORE this one. The new token's K/V is
    written in place into page [lengths // P, lengths % P], then the
    paged-attention op attends with ``lengths + 1`` valid tokens. Returns
    (out (B, 1, d), pages, (k_new, v_new)) with k_new/v_new (B, KV, D) for
    the host-store writeback. Quantized stores (``quantized_pages``) take
    ``_attn_chunk_quant`` with C = 1."""
    if quantized_pages(pages):
        out, pages, (k_new, v_new) = _attn_chunk_quant(
            p, cfg, spec, x, pages, block_tables, lengths, lora, lora_ids)
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
    return proj_out_lora(p["wo"], out, lora, lora_ids), pages, (k_new, v_new)


def attn_extend_paged(p, cfg, spec, x, pages, block_tables, lengths, *,
                      chunk_lens=None, scratch_block=None, lora=None,
                      lora_ids=None):
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
                                 lora, lora_ids)
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
    return proj_out_lora(p["wo"], out, lora, lora_ids), pages, (k_new, v_new)


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
    read of ``cache_len``, one upload of the indices)."""
    dev = cache_len.device
    cl = cache_len.long().cpu()
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
                lora=None, lora_ids=None):
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
                            rows(k_new, ki).transpose(1, 2),
                            rows(v_new, ki).transpose(1, 2),
                            scale=scale, window=window).transpose(1, 2)
    if nk < B:
        pi = route.cont if nk else None  # the continuation rows, or every row
        W = cache["k"].shape[1]
        kpos = torch.arange(W, device=x.device)
        oc = flash_attention(
            rows(q, pi), rows(cache["k"], pi), rows(cache["v"], pi),
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
    return proj_out_lora(p["wo"], out, lora, lora_ids), cache


# ---------------------------------------------------------------------------
# non-causal attention: whisper's encoder and its decoder's cross-attention
# ---------------------------------------------------------------------------

def attn_bidir(p, cfg, spec, x):
    """Bidirectional self-attention over a whole sequence (whisper's
    encoder, the twin of the reference's ``attn_forward(causal=False)``):
    x (B, S, d) -> (B, S, d), every position attending to every other."""
    S = x.shape[1]
    q, k, v = _qkv(p, cfg, x)
    pos = torch.arange(S, device=x.device)
    if _uses_rope(cfg, spec):
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention(q, k, v, q_pos=pos, k_pos=pos, kind="global",
                          scale=_scale(cfg), causal=False)
    return proj_out(p["wo"], out)


def cross_kv(p, enc, dtype):
    """A decoder layer's cross-attention keys and values over the encoder
    states enc (B, T, d): two (B, T, KV, D) tensors in ``dtype``."""
    return proj_qkv(p["wk"], enc).to(dtype), proj_qkv(p["wv"], enc).to(dtype)


def cross_attend(p, cfg, x, enc_k, enc_v):
    """Cross-attention of x (B, S, d) over every encoder position of
    enc_k / enc_v (B, T, KV, D), at the scale 1/sqrt(head_dim) (the
    reference's ``_cross_attend``, which reads no ``softmax_scale``).
    Returns (B, S, d)."""
    S, T = x.shape[1], enc_k.shape[1]
    q = proj_qkv(p["wq"], x)
    out = flash_attention(q, enc_k, enc_v, q_pos=torch.arange(S, device=x.device),
                          k_pos=torch.arange(T, device=x.device), kind="global",
                          scale=1.0 / math.sqrt(cfg.head_dim), causal=False)
    return proj_out(p["wo"], out)
