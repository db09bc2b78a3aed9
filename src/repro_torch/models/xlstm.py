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

Under ``tp`` (the sharded train step's model group; ``cfg.num_heads`` is
then the rank's count, ``TrainSharding.layer_cfg``) each rank runs the
recurrences of its own heads, x entering through ``copy_to_model``:

* mLSTM: ``up_proj`` (its [xin ; z] columns in ``piece_order``), ``conv_w``
  and ``conv_b`` are the rank's channels; ``wq``, ``wk``, ``wv`` and
  ``w_if`` hold the rank's rows, so their products are partial sums of
  every column, packed into one ``reduce_scatter_to_model`` that leaves
  each rank its heads' q, k, v and gates (all-gather backward). The
  replicated ``w_if`` bias and ``head_norm`` are used on the rank's heads
  only and enter through ``copy_to_model`` (their gradients summed over the
  group); one ``reduce_from_model`` after ``down_proj``'s rows.
* sLSTM: ``wx`` holds the rank's heads' four gates (gate-major columns in
  ``piece_order``), and the rank uses its heads' blocks of the replicated,
  block-diagonal ``r`` (through ``copy_to_model``). The group norm spans
  all of d, so the states are gathered over the group first
  (``gather_from_model``), and the FFN runs as ``slstm_ffn_cut`` says:
  "pairs" (``ffn_up``'s [a ; g] in ``piece_order``, ``ffn_down``'s rows,
  one ``reduce_from_model``), "gather" (``ffn_up`` cut but its pieces do
  not split: gathered where it is used, ``ffn_down`` whole), or whole.

A tensor-parallel prefill or decode step passes the same ``tp`` with the
rank's states (its heads' ``C``, ``n``, ``m`` and its channels' ``conv``;
its heads' slices of the sLSTM's ``c``, ``n``, ``h``, ``m``) and gets
them back: a chunk or one token from them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import (act_fn, apply_norm, chunked_scan, dense,
                                       dense_axes, make_dense, make_norm, norm_axes,
                                       normal_init, time_loop)
from repro_torch.models.mamba import causal_conv
from repro_torch.sharding.collectives import (copy_to_model, gather_from_model,
                                              reduce_from_model, reduce_scatter_to_model)

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

        def step(t, state):
            C, n, m = state
            q_t, k_t, v_t, i_t, f_t = q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t]
            m_new = torch.maximum(f_t + m, i_t)
            i_p = torch.exp(i_t - m_new)
            f_p = torch.exp(f_t + m - m_new)
            C = f_p[..., None, None] * C + i_p[..., None, None] * (
                v_t[..., :, None] * k_t[..., None, :])  # (B, H, dh_v, dh_k)
            n = f_p[..., None] * n + i_p[..., None] * k_t
            num = torch.einsum("bhvk,bhk->bhv", C, q_t)
            den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)), 1.0)
            return num / den[..., None], (C, n, m_new)
        hs, state = time_loop(step, q.shape[1], state)
        return torch.stack(hs, dim=1), state

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

    def step(j, state):
        C_p, n_p, m_p = state
        c0 = j * L
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
        h = num / den[..., None]
        # end-of-chunk state: weights e^{g_s + b_L - m_new}
        bL = b[:, -1]  # (B, H)
        m_new = bL + torch.maximum(m_p, g.amax(dim=1))
        beta = torch.exp(m_p + bL - m_new)
        w_state = torch.exp(g + bL[:, None, :] - m_new[:, None, :])  # (B, L, H)
        C_p = beta[..., None, None] * C_p + torch.einsum(
            "bshd,bshk->bhdk", w_state[..., None] * vc, kc)
        n_p = beta[..., None] * n_p + torch.einsum("bsh,bshd->bhd", w_state, kc)
        return h, (C_p, n_p, m_new)
    hs, state = time_loop(step, S // L, (C_p, n_p, m_p))
    return torch.cat(hs, dim=1), state


def _mlstm_inputs_tp(p, xc, xin, H, tp):
    """The rank's heads' q, k (unscaled), v and gates (bias added) under
    ``tp``: the row-cut products' partial sums, laid out (B, S, ranks,
    [q_i, k_i, v_i, ig_i, fg_i]) and reduce-scattered over the ranks."""
    B, S, di = xin.shape
    mp, i = tp.size, tp.index
    parts = [(xc @ p["wq"]["w"]).reshape(B, S, mp, di),
             (xc @ p["wk"]["w"]).reshape(B, S, mp, di),
             (xin @ p["wv"]["w"]).reshape(B, S, mp, di),
             (xin @ p["w_if"]["w"]).reshape(B, S, 2, mp, H).transpose(2, 3).reshape(
                 B, S, mp, 2 * H)]
    mine = reduce_scatter_to_model(torch.cat(parts, dim=-1), tp, 2)[:, :, 0]
    q, k, v, gates = torch.split(mine, [di, di, di, 2 * H], dim=-1)
    bias = copy_to_model(p["w_if"]["b"], tp).reshape(2, mp, H)[:, i].reshape(2 * H)
    return q, k, v, gates + bias


def mlstm_forward(p, cfg, x, *, state=None, tp=None):
    """x: (B, S, d); state: {"conv", "C", "n", "m"} or None (an empty
    history). ``tp``: the rank's model group, whose heads run here (see the
    module docstring). Returns (y (B, S, d), the new state dict: the
    rank's heads' states under ``tp``)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    xin, z = torch.chunk(dense(p["up_proj"], copy_to_model(x, tp)), 2, dim=-1)
    di = xin.shape[-1]
    dh = di // H
    xc, new_conv = causal_conv(p["conv_w"], p["conv_b"], xin,
                               None if state is None else state["conv"])
    xc = F.silu(xc)
    if tp is None:
        q, k, v = dense(p["wq"], xc), dense(p["wk"], xc), dense(p["wv"], xin)
        gates = dense(p["w_if"], xin)
    else:
        q, k, v, gates = _mlstm_inputs_tp(p, xc, xin, H, tp)
    q = q.reshape(B, S, H, dh)
    k = (k / math.sqrt(dh)).reshape(B, S, H, dh)
    v = v.reshape(B, S, H, dh)
    gates = gates.float()  # (B, S, 2H)
    ig, fg = gates[..., :H], F.logsigmoid(gates[..., H:])
    s = _mlstm_memory(B, H, dh, x.device) if state is None else state
    s0 = (s["C"], s["n"], s["m"])
    # long chunks take the chunkwise-parallel form, short ones and decode
    # the recurrence (the same function, other summation order)
    if S >= 128 and S % 64 == 0:
        h, (C, n, m) = mlstm_chunkwise(q, k, v, ig, fg, s0, chunk=64)
    else:
        h, (C, n, m) = mlstm_recurrence(q, k, v, ig, fg, s0)
    norm = {name: copy_to_model(t, tp) for name, t in p["head_norm"].items()}
    h = apply_norm("layernorm", norm, h.to(x.dtype))
    h = h.reshape(B, S, di) * F.silu(z)
    y = reduce_from_model(dense(p["down_proj"], h), tp)
    return y, {"conv": new_conv, "C": C, "n": n, "m": m}


def _mlstm_memory(batch, H, dh, device):
    """An empty history of H heads of width dh: f32 ``C``, ``n`` zeros,
    ``m`` at -1e30."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), NEG_INF, **f32)}


def init_mlstm_cache(cfg, batch, dtype, device):
    di, H = mlstm_d_inner(cfg), cfg.num_heads
    return {"conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
            **_mlstm_memory(batch, H, di // H, device)}


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

        def step(t, state):
            c, n, h, m = state
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
            return h, (c, n, h, m_new)
        hs, state = time_loop(step, gx.shape[1], state)
        return torch.stack(hs, dim=1), state

    return chunked_scan(run, (gx.float(),), tuple(state))


def slstm_ffn_cut(cfg, mp: int):
    """How the sLSTM's FFN runs on a model axis of ``mp``: "pairs" where its
    df = int(slstm_proj_factor * d) units split over the ranks (``ffn_up``
    in ``piece_order``, ``ffn_down``'s rows cut), "gather" where only
    ``ffn_up``'s 2 df columns do (the rules cut it, ``ffn_down`` stays
    whole: smoke width's df = 341 on 2 ranks), None where neither is cut."""
    df = int(cfg.slstm_proj_factor * cfg.d_model)
    if mp == 1 or (2 * df) % mp:
        return None
    return "pairs" if df % mp == 0 else "gather"


def slstm_forward(p, cfg, x, *, state=None, tp=None):
    """x: (B, S, d); state: {"c", "n", "h", "m"} or None. ``tp``: the rank's
    model group, whose heads run here (see the module docstring). Returns
    (y (B, S, d), the new state dict: the rank's heads' states under
    ``tp``)."""
    B, S, d = x.shape
    H = cfg.num_heads
    r = p["r"]
    dh = r.shape[1]
    if tp is not None:
        r = copy_to_model(r, tp)[tp.index * H:(tp.index + 1) * H]
    if state is None:
        state = _slstm_state(B, H, dh, x.device)
    hs, (c, n, h, m) = slstm_recurrence(
        dense(p["wx"], copy_to_model(x, tp)), r,
        (state["c"], state["n"], state["h"], state["m"]), H, dh)
    hs = hs.to(x.dtype)
    cut = None
    if tp is not None:
        hs = gather_from_model(hs, tp, -1)
        cut = slstm_ffn_cut(cfg, tp.size)
    hs = apply_norm("layernorm", p["group_norm"], hs)
    # post-up gated FFN (proj factor 4/3)
    up = p["ffn_up"]
    if cut == "gather":
        up = {"w": gather_from_model(up["w"], tp, 1)}
    elif cut == "pairs":
        hs = copy_to_model(hs, tp)
    a, g = torch.chunk(dense(up, hs), 2, dim=-1)
    y = dense(p["ffn_down"], act_fn("gelu")(g) * a)
    if cut == "pairs":
        y = reduce_from_model(y, tp)
    return y, {"c": c, "n": n, "h": h, "m": m}


def _slstm_state(batch, H, dh, device):
    """An empty history of H heads of width dh: f32 ``c``, ``n``, ``h``
    zeros, ``m`` at -1e30."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H * dh), **f32), "n": torch.zeros((batch, H * dh), **f32),
            "h": torch.zeros((batch, H * dh), **f32), "m": torch.full((batch, H), NEG_INF, **f32)}


def init_slstm_cache(cfg, batch, dtype, device):
    """``dtype`` is unused (every sLSTM leaf is f32); kept for the common
    signature of the ``init_*_cache`` functions."""
    return _slstm_state(batch, cfg.num_heads, cfg.d_model // cfg.num_heads, device)
