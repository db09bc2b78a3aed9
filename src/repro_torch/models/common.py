"""Shared building blocks on torch tensors: norms, dense, activations, RoPE,
sinusoidal positions, initializers. Twins of ``repro.models.common`` with the JAX numerics:
norms compute in fp32 with the population variance, ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default), and RoPE rotates the two HALVES
of the head in fp32. Parameters are plain nested dicts of tensors; the
logical-axis annotations and ``lconstraint`` of the JAX package have no
counterpart here (no sharding rules yet).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, scale, device):
    """``scale * N(0, 1)`` drawn in fp32 from ``gen``, cast to ``dtype``;
    scaled in place, so a large bf16 leaf (a 256-expert ``w1``) costs one
    fp32 copy on the way, not two."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def make_dense(gen, in_dim, out_dim, dtype, device, *, bias=False,
               scale: Optional[float] = None):
    """A (in, out) weight (+ optional bias) with fan-in init."""
    scale = (1.0 / math.sqrt(in_dim)) if scale is None else scale
    p = {"w": normal_init(gen, (in_dim, out_dim), dtype, scale, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def make_norm(kind: str, dim: int, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "rmsnorm_p1":  # gemma: (1 + w), w initialized at 0
        return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p, x, eps: float = 1e-5):
    xf = x.float()
    if kind in ("rmsnorm", "rmsnorm_p1"):
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        scale = p["scale"].float()
        if kind == "rmsnorm_p1":
            scale = 1.0 + scale
        return (y * scale).to(x.dtype)
    # layer norm (parametric or not); population variance like jnp.var
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def act_fn(name: str):
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "silu": F.silu,
    }[name]


def is_glu(activation: str) -> bool:
    return activation.endswith("_glu")


def glu_inner_act(activation: str):
    return act_fn(activation.split("_")[0] if is_glu(activation) else activation)


def gated(activation: str, h):
    """The feed-forward activation of a hidden state: for a gated
    (``*_glu``) activation, act(g) * u with u the FIRST half of h and the
    gate g the second; else act(h)."""
    if is_glu(activation):
        u, g = torch.chunk(h, 2, dim=-1)
        return glu_inner_act(activation)(g) * u
    return glu_inner_act(activation)(h)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Rotates the two halves [x1, x2] of each head in fp32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------

def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (length, dim) in fp32: the sines
    of ``dim // 2`` geometric frequencies, then their cosines."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
