"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, pre-up-projection)
and sLSTM (scalar memory with recurrent gating, post-up gated FFN).

The twin of ``repro.models.xlstm`` as plain functions on tensors. Both
carry fixed-size state per sequence instead of a KV cache, held in the
engine's state slots: mLSTM ``conv`` (3, d_inner) in the activation dtype
and ``C`` (H, dh, dh), ``n`` (H, dh), ``m`` (H,) in f32; sLSTM ``c``,
``n``, ``h`` (d,) and ``m`` (H,) in f32. An empty history has ``m =
-1e30`` (the exponential gates' stabilizer), the rest zeros
(``init_mlstm_cache``, ``init_slstm_cache``).

The recurrences are plain loops over time, as the reference's are
``lax.scan`` bodies outside any Pallas kernel; under a gradient (training)
each step-by-step loop runs through ``common.chunked_scan`` (64-step chunks
recomputed in the backward pass, the reference's ``chunked_scan``), and
serving calls them under ``torch.no_grad()`` (``Model.extend``). The
mLSTM takes the reference's branch: the chunkwise-parallel form (64-step
chunks: masked (L, L) score matmuls inside a chunk, (C, n, m) carried
between chunks) when S >= 128 and S % 64 == 0, the step-by-step
recurrence otherwise (decode, short chunks). The sLSTM's recurrent weights
``r`` are block-diagonal, one (dh, 4 dh) block per head; each step's
recurrent pre-activations are reordered head-major -> gate-major to match
``wx``'s layout, and the stabilizer uses each head's mean pre-activation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (act_fn, apply_norm, chunked_scan, dense,
                                       dense_axes, make_dense, make_norm, norm_axes,
                                       normal_init)
from repro_torch.models.mamba import causal_conv

NEG_INF = -1e30


def mlstm_d_inner(cfg) -> int:
    return int(cfg.mlstm_proj_factor * cfg.d_model)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def make_mlstm_params(gen, cfg, dtype, device):
    d, di, H = cfg.d_model, mlstm_d_inner(cfg), cfg.num_heads
    return {
        "up_proj": make_dense(gen, d, 2 * di, dtype, device),
        "conv_w": normal_init(gen, (4, di), dtype, 0.5, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq": make_dense(gen, di, di, dtype, device),
        "wk": make_dense(gen, di, di, dtype, device),
        "wv": make_dense(gen, di, di, dtype, device),
        "w_if": make_dense(gen, di, 2 * H, dtype, device, bias=True),
        "head_norm": make_norm("layernorm", di // H, dtype, device),
        "down_proj": make_dense(gen, di, d, dtype, device, scale=1.0 / math.sqrt(di)),
    }


def mlstm_param_axes(cfg):
    """The logical axes of ``make_mlstm_params``' leaves (the reference's)."""
    return {"up_proj": dense_axes(("embed", "lstm_inner")),
            "conv_w": ("conv", "lstm_inner"), "conv_b": ("lstm_inner",),
            "wq": dense_axes(("lstm_inner", None)), "wk": dense_axes(("lstm_inner", None)),
            "wv": dense_axes(("lstm_inner", "lstm_inner")),
            "w_if": dense_axes(("lstm_inner", None), bias=True),
            "head_norm": norm_axes("layernorm"),
            "down_proj": dense_axes(("lstm_inner", "embed"))}


def mlstm_recurrence(q, k, v, ig, fg, state):
    """q, k, v: (B, S, H, dh); ig, fg: (B, S, H) (fg a log-sigmoid);
    state: (C (B, H, dh, dh), n (B, H, dh), m (B, H)) f32. Returns (h (B, S,
    H, dh) f32, the state after the last step)."""
    def run(xs, state):
        q, k, v, ig, fg = xs
        C, n, m = state
        hs = []
        for t in range(q.shape[1]):
            q_t, k_t, v_t, i_t, f_t = q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t]
            m_new = torch.maximum(f_t + m, i_t)
            i_p = torch.exp(i_t - m_new)
            f_p = torch.exp(f_t + m - m_new)
            C = f_p[..., None, None] * C + i_p[..., None, None] * (
                v_t[..., :, None] * k_t[..., None, :])  # (B, H, dh_v, dh_k)
            n = f_p[..., None] * n + i_p[..., None] * k_t
            num = torch.einsum("bhvk,bhk->bhv", C, q_t)
            den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)), 1.0)
            hs.append(num / den[..., None])
            m = m_new
        return torch.stack(hs, dim=1), (C, n, m)

    return chunked_scan(run, tuple(a.float() for a in (q, k, v, ig, fg)), tuple(state))


def mlstm_chunkwise(q, k, v, ig, fg, state, *, chunk: int = 64):
    """The chunkwise-parallel form of ``mlstm_recurrence`` (the xLSTM
    paper's parallel form, the reference's ``_mlstm_chunkwise``): within a
    chunk, with b_t the inclusive cumulative log forget gate and g_s = log
    i_s - b_s, the stabilizer M_t = max(m_prev, cummax g) and

      h_t ∝ e^{m_prev - M_t} (C_prev q_t) + Σ_{s<=t} e^{g_s - M_t} (q_t·k_s) v_s

    with n_t likewise; (C, n, m) pass from chunk to chunk. S is a multiple
    of ``chunk`` (``mlstm_forward`` takes this form only then)."""
    B, S, H, dh = q.shape
    assert S % chunk == 0, (S, chunk)
    C_p, n_p, m_p = state
    L = chunk
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, S, L):
        qc, kc, vc = (a[:, c0: c0 + L].float() for a in (q, k, v))  # (B, L, H, dh)
        ic, fc = ig[:, c0: c0 + L].float(), fg[:, c0: c0 + L].float()  # (B, L, H)
        b = torch.cumsum(fc, dim=1)
        g = ic - b
        M = torch.maximum(m_p[:, None, :], torch.cummax(g, dim=1).values)
        scores = torch.einsum("blhd,bshd->bhls", qc, kc)
        decay = torch.exp(g.transpose(1, 2)[:, :, None, :]
                          - M.transpose(1, 2)[:, :, :, None])  # (B, H, L, L)
        w = torch.where(mask, scores * decay, 0.0)
        num_intra = torch.einsum("bhls,bshd->blhd", w, vc)
        n_intra = torch.einsum("bhls,bshd->blhd", torch.where(mask, decay, 0.0), kc)
        alpha = torch.exp(m_p[:, None, :] - M)  # (B, L, H)
        num_inter = torch.einsum("blhk,bhvk->blhv", qc, C_p)
        num = alpha[..., None] * num_inter + num_intra
        n_t = alpha[..., None] * n_p[:, None] + n_intra
        den = torch.clamp_min(torch.abs(torch.einsum("blhd,blhd->blh", n_t, qc)), 1.0)
        hs.append(num / den[..., None])
        # end-of-chunk state: weights e^{g_s + b_L - m_new}
        bL = b[:, -1]  # (B, H)
        m_new = bL + torch.maximum(m_p, g.amax(dim=1))
        beta = torch.exp(m_p + bL - m_new)
        w_state = torch.exp(g + bL[:, None, :] - m_new[:, None, :])  # (B, L, H)
        C_p = beta[..., None, None] * C_p + torch.einsum(
            "bshd,bshk->bhdk", w_state[..., None] * vc, kc)
        n_p = beta[..., None] * n_p + torch.einsum("bsh,bshd->bhd", w_state, kc)
        m_p = m_new
    return torch.cat(hs, dim=1), (C_p, n_p, m_p)


def mlstm_forward(p, cfg, x, *, state=None):
    """x: (B, S, d); state: {"conv", "C", "n", "m"} or None (an empty
    history). Returns (y (B, S, d), the new state dict)."""
    B, S, _ = x.shape
    di, H = mlstm_d_inner(cfg), cfg.num_heads
    dh = di // H
    xin, z = torch.chunk(dense(p["up_proj"], x), 2, dim=-1)
    xc, new_conv = causal_conv(p["conv_w"], p["conv_b"], xin,
                               None if state is None else state["conv"])
    xc = F.silu(xc)
    q = dense(p["wq"], xc).reshape(B, S, H, dh)
    k = (dense(p["wk"], xc) / math.sqrt(dh)).reshape(B, S, H, dh)
    v = dense(p["wv"], xin).reshape(B, S, H, dh)
    gates = dense(p["w_if"], xin).float()  # (B, S, 2H)
    ig, fg = gates[..., :H], F.logsigmoid(gates[..., H:])
    if state is None:
        s = init_mlstm_cache(cfg, B, x.dtype, x.device)
        s0 = (s["C"], s["n"], s["m"])
    else:
        s0 = (state["C"], state["n"], state["m"])
    # long chunks take the chunkwise-parallel form, short ones and decode
    # the recurrence (the same function, other summation order)
    if S >= 128 and S % 64 == 0:
        h, (C, n, m) = mlstm_chunkwise(q, k, v, ig, fg, s0, chunk=64)
    else:
        h, (C, n, m) = mlstm_recurrence(q, k, v, ig, fg, s0)
    h = apply_norm("layernorm", p["head_norm"], h.to(x.dtype))
    h = h.reshape(B, S, di) * F.silu(z)
    return dense(p["down_proj"], h), {"conv": new_conv, "C": C, "n": n, "m": m}


def init_mlstm_cache(cfg, batch, dtype, device):
    di, H = mlstm_d_inner(cfg), cfg.num_heads
    dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
            "C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), NEG_INF, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def make_slstm_params(gen, cfg, dtype, device):
    d, H = cfg.d_model, cfg.num_heads
    dh, df = d // H, int(cfg.slstm_proj_factor * d)
    return {
        "wx": make_dense(gen, d, 4 * d, dtype, device),
        # block-diagonal recurrent weights, one (dh, 4 dh) block per head
        "r": normal_init(gen, (H, dh, 4 * dh), dtype, 1.0 / math.sqrt(dh), device),
        "group_norm": make_norm("layernorm", d, dtype, device),
        "ffn_up": make_dense(gen, d, 2 * df, dtype, device),
        "ffn_down": make_dense(gen, df, d, dtype, device, scale=1.0 / math.sqrt(df)),
    }


def slstm_param_axes(cfg):
    """The logical axes of ``make_slstm_params``' leaves (the reference's)."""
    return {"wx": dense_axes(("embed", "lstm_inner")), "r": (None, None, None),
            "group_norm": norm_axes("layernorm"),
            "ffn_up": dense_axes(("embed", "ff")), "ffn_down": dense_axes(("ff", "embed"))}


def slstm_recurrence(gx, r, state, H, dh):
    """gx: (B, S, 4d) input pre-activations; r: (H, dh, 4 dh); state: (c, n,
    h (B, d), m (B, H)) f32. Returns (h (B, S, d) f32, the new state)."""
    r = r.float()
    B = gx.shape[0]

    def run(xs, state):
        gx, = xs
        c, n, h, m = state
        hs = []
        for t in range(gx.shape[1]):
            rec = torch.einsum("bhd,hdk->bhk", h.reshape(B, H, dh), r)  # (B, H, 4dh)
            # head-major (H, 4, dh) -> gate-major (4, H, dh), wx's layout
            rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * H * dh)
            gi, gf, gz, go = torch.chunk(gx[:, t] + rec, 4, dim=-1)  # (B, d) each
            gih = gi.reshape(B, H, dh)
            gfh = F.logsigmoid(gf).reshape(B, H, dh)
            # per-head scalar stabilizer from the head-mean pre-activations
            m_new = torch.maximum(gfh.mean(-1) + m, gih.mean(-1))
            i_p = torch.exp(gih - m_new[..., None]).reshape(gi.shape)
            f_p = torch.exp(gfh + (m - m_new)[..., None]).reshape(gf.shape)
            c = f_p * c + i_p * torch.tanh(gz)
            n = f_p * n + i_p
            h = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
            m = m_new
            hs.append(h)
        return torch.stack(hs, dim=1), (c, n, h, m)

    return chunked_scan(run, (gx.float(),), tuple(state))


def slstm_forward(p, cfg, x, *, state=None):
    """x: (B, S, d); state: {"c", "n", "h", "m"} or None. Returns (y (B, S,
    d), the new state dict)."""
    B, S, d = x.shape
    H = cfg.num_heads
    if state is None:
        state = init_slstm_cache(cfg, B, x.dtype, x.device)
    hs, (c, n, h, m) = slstm_recurrence(
        dense(p["wx"], x), p["r"], (state["c"], state["n"], state["h"], state["m"]),
        H, d // H)
    hs = apply_norm("layernorm", p["group_norm"], hs.to(x.dtype))
    # post-up gated FFN (proj factor 4/3)
    a, g = torch.chunk(dense(p["ffn_up"], hs), 2, dim=-1)
    return dense(p["ffn_down"], act_fn("gelu")(g) * a), {"c": c, "n": n, "h": h, "m": m}


def init_slstm_cache(cfg, batch, dtype, device):
    """``dtype`` is unused (every sLSTM leaf is f32); kept for the common
    signature of the ``init_*_cache`` functions."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, cfg.num_heads), NEG_INF, **f32)}
