"""Multi-head latent attention (DeepSeek-V3, arXiv:2412.19437).

The twin of ``repro.models.mla`` as plain functions on tensors. A layer
caches one latent per token: ``c_kv`` (kv_lora_rank), the normalized
down-projection of the token, and ``k_pe`` (qk_rope_head_dim), one roped
key shared by every head; at published width that is 512 + 64 values
against 128 x (192 + 128) for attention K/V. Parameters keep the
reference's tree and layouts: ``wq_a`` (d, q_lora_rank) with ``q_norm`` and
a per-head ``wq_b`` (q_lora_rank, H, nope + rope), or ``wq`` (d, H, nope +
rope) without a query rank; ``wkv_a`` (d, kv_lora_rank + rope) with
``kv_norm``; ``wkv_b`` (kv_lora_rank, H, nope + v); ``wo`` (H, v, d).

Three forms of the same attention:
  * ``mla_forward``: the expanded form over a whole sequence (K/V
    materialized per head from the latents);
  * ``mla_extend``: the serving path, the twin of
    ``repro.models.model._mla_extend``: a chunk's latents are written into
    a gathered ``{"c_kv": (B, W, r), "k_pe": (B, W, rope)}`` window in
    place, then ALL W cached latents are expanded through ``wkv_b`` and the
    chunk attends through the plain ``attention.flash_attention`` (Dqk =
    nope + rope, Dv = v), scaled by 1/sqrt(nope + rope);
  * ``mla_decode``: the absorbed form of one-token decode (queries
    multiplied by ``wkv_b``'s key half, scores taken against the latents),
    which no serving path calls; it checks ``mla_extend`` at C = 1.
No kernel runs here: the reference's ``_mla_extend`` calls its plain
blockwise attention too, and ``flash_prefill`` takes only Dqk == Dv.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, apply_rope, dense, make_dense,
                                       make_norm, normal_init)

NEG_INF = -1e30


def make_mla_params(gen, cfg, dtype, device):
    """Per-head matrices stored 3-D (rank, heads, head_dim), as in JAX."""
    d, H = cfg.d_model, cfg.num_heads
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = make_dense(gen, d, cfg.q_lora_rank, dtype, device)
        p["q_norm"] = make_norm("rmsnorm", cfg.q_lora_rank, dtype, device)
        p["wq_b"] = {"w": normal_init(gen, (cfg.q_lora_rank, H, qk_dim), dtype,
                                      1.0 / math.sqrt(cfg.q_lora_rank), device)}
    else:
        p["wq"] = {"w": normal_init(gen, (d, H, qk_dim), dtype, 1.0 / math.sqrt(d),
                                    device)}
    p["wkv_a"] = make_dense(gen, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype,
                            device)
    p["kv_norm"] = make_norm("rmsnorm", cfg.kv_lora_rank, dtype, device)
    p["wkv_b"] = {"w": normal_init(
        gen, (cfg.kv_lora_rank, H, cfg.qk_nope_head_dim + cfg.v_head_dim), dtype,
        1.0 / math.sqrt(cfg.kv_lora_rank), device)}
    p["wo"] = {"w": normal_init(gen, (H, cfg.v_head_dim, d), dtype,
                                1.0 / math.sqrt(H * cfg.v_head_dim), device)}
    return p


def _project_q(p, cfg, x):
    """x: (B, S, d) -> (q_nope (B, S, H, nope), q_pe (B, S, H, rope)),
    q_pe not yet roped."""
    if cfg.q_lora_rank:
        q = apply_norm("rmsnorm", p["q_norm"], dense(p["wq_a"], x))
        q = torch.einsum("bsr,rhk->bshk", q, p["wq_b"]["w"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"]["w"])
    return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]


def _latent_kv(p, cfg, x, positions):
    """-> c_kv (B, S, r) normalized, k_pe (B, S, 1, rope) roped at
    ``positions`` ((S,) or (B, S))."""
    kv = dense(p["wkv_a"], x)
    c_kv, k_pe = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = apply_norm("rmsnorm", p["kv_norm"], c_kv)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_pe


def _split_wkv_b(p, cfg):
    """``wkv_b`` (r, H, nope + v) -> the key half (r, H, nope) and the value
    half (r, H, v)."""
    w = p["wkv_b"]["w"]
    return w[..., :cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _expand(p, cfg, q_nope, q_pe, c_kv, k_pe, dtype):
    """Queries (B, S, H, nope + rope), and keys (B, Sk, H, nope + rope) and
    values (B, Sk, H, v) expanded from latents c_kv (B, Sk, r) and roped
    shared keys k_pe (B, Sk, rope), both in ``dtype``."""
    w_uk, w_uv = _split_wkv_b(p, cfg)
    c = c_kv.to(dtype)
    k_nope = torch.einsum("bsr,rhn->bshn", c, w_uk)
    v = torch.einsum("bsr,rhn->bshn", c, w_uv)
    B, Sk = c.shape[:2]
    k = torch.cat([k_nope, k_pe[:, :, None, :].to(dtype).expand(
        B, Sk, cfg.num_heads, cfg.qk_rope_head_dim)], dim=-1)
    return torch.cat([q_nope, q_pe], dim=-1), k, v


def mla_forward(p, cfg, spec, x, positions, *, kv_valid=None, causal=True):
    """Expanded form over a whole sequence. x: (B, S, d); positions: (S,).
    Returns (out (B, S, d), (c_kv (B, S, r), k_pe (B, S, rope)))."""
    q_nope, q_pe = _project_q(p, cfg, x)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv, k_pe = _latent_kv(p, cfg, x, positions)
    q, k, v = _expand(p, cfg, q_nope, q_pe, c_kv, k_pe[:, :, 0], x.dtype)
    out = attn.flash_attention(q, k, v, q_pos=positions, k_pos=positions,
                               kind=spec.attn_kind, window=cfg.sliding_window,
                               chunk=cfg.chunk_size, scale=_scale(cfg),
                               causal=causal, kv_valid=kv_valid)
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"]["w"])
    return out, (c_kv, k_pe[:, :, 0])


def mla_extend(p, cfg, spec, x, cache, cache_len, route=None):
    """Write a chunk's latents at [cache_len, cache_len + C) of the window
    and attend. x: (B, C, d); cache: {"c_kv": (B, W, r), "k_pe": (B, W,
    rope)}, written IN PLACE (slots past W dropped, as ``route`` gives
    them); cache_len: (B,). Every W cached latent is expanded through
    ``wkv_b`` and the chunk attends through the plain ``flash_attention``
    with ``kv_valid = position < cache_len + C``. Returns (out (B, C, d),
    cache)."""
    B, C, _ = x.shape
    W = cache["c_kv"].shape[1]
    if route is None:
        route = attn.extend_route(cache_len, C, W)
    pos = cache_len.long()[:, None] + torch.arange(C, device=x.device)
    q_nope, q_pe = _project_q(p, cfg, x)
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    c_new, pe_new = _latent_kv(p, cfg, x, pos)
    c_cache, pe_cache = cache["c_kv"], cache["k_pe"]
    c_cache[route.wb, route.wp] = c_new[route.wb, route.wc].to(c_cache.dtype)
    pe_cache[route.wb, route.wp] = pe_new[route.wb, route.wc, 0].to(pe_cache.dtype)
    q, k, v = _expand(p, cfg, q_nope, q_pe, c_cache, pe_cache, x.dtype)
    kpos = torch.arange(W, device=x.device)
    out = attn.flash_attention(
        q, k, v, q_pos=pos, k_pos=kpos, kind=spec.attn_kind,
        window=cfg.sliding_window, chunk=cfg.chunk_size, scale=_scale(cfg),
        kv_valid=kpos[None, :] < (cache_len.long()[:, None] + C))
    return torch.einsum("bshv,hvd->bsd", out, p["wo"]["w"]), cache


def mla_decode(p, cfg, spec, x, cache, cache_len):
    """Absorbed-form one-token decode. x: (B, 1, d); cache: {"c_kv": (B,
    Smax, r), "k_pe": (B, Smax, rope)}, the new token's latents written IN
    PLACE at ``cache_len``. Scores are taken against the cached latents in
    their own dtype with f32 products, as the reference's
    ``preferred_element_type`` does. Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    pos = cache_len.long()
    q_nope, q_pe = _project_q(p, cfg, x)  # (B, 1, H, *)
    q_pe = apply_rope(q_pe, pos[:, None], cfg.rope_theta)
    c_new, pe_new = _latent_kv(p, cfg, x, pos[:, None])
    c_cache, pe_cache = cache["c_kv"], cache["k_pe"]
    bidx = torch.arange(B, device=x.device)
    c_cache[bidx, pos] = c_new[:, 0].to(c_cache.dtype)
    pe_cache[bidx, pos] = pe_new[:, 0, 0].to(pe_cache.dtype)
    w_uk, w_uv = _split_wkv_b(p, cfg)
    # absorb: q_eff[h, r] = sum_n q_nope[h, n] * w_uk[r, h, n]
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk.float())
    c32, pe32 = c_cache.float(), pe_cache.float()
    s = torch.einsum("bhr,bsr->bhs", q_eff.to(c_cache.dtype).float(), c32)
    s = s + torch.einsum("bhe,bse->bhs", q_pe[:, 0].to(pe_cache.dtype).float(), pe32)
    valid = (torch.arange(c_cache.shape[1], device=x.device)[None, :]
             < (pos + 1)[:, None])[:, None, :]
    s = torch.where(valid, s * _scale(cfg), NEG_INF)
    pr = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    pr = pr / torch.clamp_min(pr.sum(dim=-1, keepdim=True), 1e-30)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(c_cache.dtype).float(), c32)
    out_h = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float())
    out = torch.einsum("bhv,hvd->bd", out_h.to(x.dtype), p["wo"]["w"])[:, None, :]
    return out, cache


def init_mla_cache(cfg, batch, max_seq, dtype, device):
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim), dtype=dtype,
                                device=device)}
