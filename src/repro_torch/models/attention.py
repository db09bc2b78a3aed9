"""GQA/MQA/MHA attention on paged KV stores (the port's serving path).

Twins of the paged family of ``repro.models.attention``: 3-D projections
(``(d, H, hd)`` in, ``(H, hd, d)`` out), RoPE at absolute positions, and
``attn_decode_paged`` / ``attn_extend_paged`` writing the new K/V into the
page stores before the paged-attention op attends over the block tables.
Unlike JAX, the page writes happen IN PLACE on the given tensors
(``index_put_``): the runner's device mirror is updated without a copy.
The functions still return the pages so call sites read like the JAX ones.
Global attention only; LoRA, KIVI pages and tensor parallelism come with
their own slices.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention import paged_attend, paged_attend_extend
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


def _qkv(p, cfg, x):
    return proj_qkv(p["wq"], x), proj_qkv(p["wk"], x), proj_qkv(p["wv"], x)


def proj_out_lora(p_wo, x):
    """The single-device, adapter-free case of the JAX ``proj_out_lora``
    (``tp_axis=None``, no LoRA): plain ``proj_out``."""
    return proj_out(p_wo, x)


def _uses_rope(cfg, spec) -> bool:
    return cfg.use_rope and not (cfg.nope_on_global and spec.attn_kind == "global")


def _scale(cfg) -> float:
    return cfg.softmax_scale or 1.0 / math.sqrt(cfg.head_dim)


def attn_decode_paged(p, cfg, spec, x, pages, block_tables, lengths):
    """One-token decode directly against block-indexed page stores.

    x: (B, 1, d); pages: {"k", "v"}: (KV, NB, P, D); block_tables: (B, NP);
    lengths: (B,) valid tokens BEFORE this one. The new token's K/V is
    written in place into page [lengths // P, lengths % P], then the
    paged-attention op attends with ``lengths + 1`` valid tokens. Returns
    (out (B, 1, d), pages, (k_new, v_new)) with k_new/v_new (B, KV, D) for
    the host-store writeback."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
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
    return proj_out_lora(p["wo"], out), pages, (k_new, v_new)


def attn_extend_paged(p, cfg, spec, x, pages, block_tables, lengths, *,
                      chunk_lens=None, scratch_block=None):
    """Multi-token extend directly against block-indexed page stores.

    x: (B, C, d) — C new tokens per sequence at positions [lengths,
    lengths + C). All C tokens' K/V are written in place first (writes span
    page boundaries: ``blk = table[pos // P]`` per position), then the C
    query positions attend through ``paged_attend_extend``. Ragged batches
    pass ``chunk_lens`` (B,): padded positions ``j >= chunk_lens[b]``
    redirect their write to ``scratch_block``, a block outside every real
    table, so duplicate write indices can only collide there.

    Returns (out (B, C, d), pages, (k_new, v_new)) with k_new/v_new
    (B, C, KV, D)."""
    B, C, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
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
    return proj_out_lora(p["wo"], out), pages, (k_new, v_new)
