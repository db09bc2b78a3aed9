"""GQA/MQA/MHA attention on paged KV stores (the port's serving path).

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
each row's table slot; the per-row deltas come from one ``bgmv`` call per
projection. Global attention only; tensor parallelism comes with its own
slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.lora.ops import bgmv
from repro_torch.kernels.paged_attention import (paged_attend, paged_attend_extend,
                                                paged_attend_extend_quant)
from repro_torch.models.common import apply_rope, normal_init


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
    """x: (B, S, d) -> (B, S, heads, hd)."""
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
    is added after the bias (and before RoPE, which the callers apply)."""
    q, k, v = proj_qkv(p["wq"], x), proj_qkv(p["wk"], x), proj_qkv(p["wv"], x)
    if lora is not None:
        B, C, _ = x.shape
        q = q + bgmv(x, lora["wq"]["a"], lora["wq"]["b"], lora_ids).reshape(
            B, C, cfg.num_heads, cfg.head_dim)
        k = k + bgmv(x, lora["wk"]["a"], lora["wk"]["b"], lora_ids).reshape(
            B, C, cfg.num_kv_heads, cfg.head_dim)
        v = v + bgmv(x, lora["wv"]["a"], lora["wv"]["b"], lora_ids).reshape(
            B, C, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def proj_out_lora(p_wo, x, lora=None, lora_ids=None):
    """``proj_out`` plus the per-row ``wo`` adapter delta, added after the
    bias; the adapter's input is the pre-projection (B, C, H, hd) flattened
    to H * hd. The single-device case of the JAX ``proj_out_lora``."""
    out = proj_out(p_wo, x)
    if lora is not None:
        B, C, H, hd = x.shape
        out = out + bgmv(x.reshape(B, C, H * hd), lora["wo"]["a"],
                         lora["wo"]["b"], lora_ids)
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
