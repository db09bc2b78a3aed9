"""Mamba-1 selective SSM mixer (Jamba's recurrent layer, arXiv:2403.19887).

The twin of ``repro.models.mamba`` as plain functions on tensors. A layer
carries no KV cache: its serving state per sequence is fixed-size, the
causal conv's last K-1 inputs ``conv`` (K-1, d_inner) in the activation
dtype and the SSM state ``ssm`` (d_inner, d_state) in f32, held in the
engine's state slots (``core/executor/state.py``). Parameters keep the
reference's tree: ``in_proj`` (d, 2 d_inner), ``conv_w`` (K, d_inner) and
``conv_b``, ``x_proj`` (d_inner, dt_rank + 2 N), ``dt_proj`` (dt_rank,
d_inner) with a bias, ``A_log`` (d_inner, N) and ``D`` (d_inner,) in f32,
``out_proj`` (d_inner, d).

The selective scan is a plain loop over time under ``torch.no_grad()``:
``dA`` and ``dBx`` are formed inside each step, never as a (B, S, d_inner,
N) tensor, with the state in f32. The reference scans with
``lax.scan`` outside any Pallas kernel (its ``chunked_scan`` only changes
memory under a gradient), so no kernel is ported here; each step is a
handful of launches (ROADMAP: a fused selective-scan kernel). Every call
goes through that loop, one decode token included: the reference's
single-step branch only spares ``lax.scan`` a trace.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense, make_dense, normal_init


def d_inner_of(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank_of(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def make_mamba_params(gen, cfg, dtype, device):
    d, di, dr, N = cfg.d_model, d_inner_of(cfg), dt_rank_of(cfg), cfg.ssm_d_state
    return {
        "in_proj": make_dense(gen, d, 2 * di, dtype, device),
        "conv_w": normal_init(gen, (cfg.ssm_d_conv, di), dtype, 0.5, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": make_dense(gen, di, dr + 2 * N, dtype, device),
        "dt_proj": make_dense(gen, dr, di, dtype, device, bias=True),
        # S4D-real init of A
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device)
                           ).expand(di, N).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": make_dense(gen, di, d, dtype, device, scale=1.0 / math.sqrt(di)),
    }


def causal_conv(w, b, x, state=None):
    """Depthwise causal conv over the sequence. x: (B, S, di); w: (K, di);
    state: (B, K-1, di), the previous K-1 inputs, or None (zeros). Returns
    (out (B, S, di), the new state: the last K-1 inputs)."""
    K = w.shape[0]
    pad = x.new_zeros((x.shape[0], K - 1, x.shape[2])) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S + K - 1, di)
    S = x.shape[1]
    out = sum(xp[:, i: i + S] * w[i] for i in range(K))
    return out + b, xp[:, xp.shape[1] - (K - 1):]


def ssm_scan(A, Bc, Cc, dt, x, h):
    """A: (di, N) f32; Bc, Cc: (B, S, N); dt, x: (B, S, di) f32; h: (B, di,
    N) f32. Returns (y (B, S, di) f32, h after the last step)."""
    Bc, Cc = Bc.float(), Cc.float()
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * A) * h + dt_t * Bc[:, t, None, :] * x[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    return torch.stack(ys, dim=1), h


@torch.no_grad()
def mamba_forward(p, cfg, x, *, conv_state=None, ssm_state=None):
    """x: (B, S, d); ``conv_state`` (B, K-1, di) and ``ssm_state`` (B, di,
    N) f32, or None for an empty history. Returns (y (B, S, d), (conv, ssm))
    with the states after the last position."""
    dr, N = dt_rank_of(cfg), cfg.ssm_d_state
    xin, z = torch.chunk(dense(p["in_proj"], x), 2, dim=-1)
    xc, new_conv = causal_conv(p["conv_w"], p["conv_b"], xin, conv_state)
    xc = F.silu(xc)
    dt, Bc, Cc = torch.split(dense(p["x_proj"], xc), [dr, N, N], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt)).float()
    A = -torch.exp(p["A_log"])
    xf = xc.float()
    h0 = ssm_state if ssm_state is not None else xf.new_zeros((x.shape[0], xf.shape[2], N))
    y, h = ssm_scan(A, Bc, Cc, dt, xf, h0)
    y = y + xf * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return dense(p["out_proj"], y), (new_conv, h.float())


def init_mamba_cache(cfg, batch, dtype, device):
    """An empty history: zero conv window (activation dtype) and zero f32
    SSM state."""
    di = d_inner_of(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, cfg.ssm_d_state), dtype=torch.float32,
                               device=device)}
