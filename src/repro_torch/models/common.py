"""Shared building blocks on torch tensors: norms, dense, activations, RoPE,
sinusoidal positions, initializers. Twins of ``repro.models.common`` with the JAX numerics:
norms compute in fp32 with the population variance, ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default), and RoPE rotates the two HALVES
of the head in fp32. Parameters are plain nested dicts of tensors. The
logical axes the JAX package annotates each parameter with live apart, in
a tree of the same structure (``models.model.param_axes``, built from
``dense_axes`` / ``norm_axes`` here and the mixers' ``*_param_axes``): the
sharded paged runner splits a parameter by those names, never by its shape.
``lconstraint`` has no counterpart.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, scale, device):
    """``scale * N(0, 1)`` drawn in fp32 from ``gen``, cast to ``dtype``;
    scaled in place, so a large bf16 leaf (a 256-expert ``w1``) costs one
    fp32 copy on the way, not two. On the meta device only the shape is
    made (a meta draw would go through torch's reference kernels, seconds
    of imports in a fresh process)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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


def dense_axes(axes, *, bias=False, bias_axis=None):
    """The logical axes of ``make_dense``'s leaves, as the reference's
    ``make_dense`` names them: the bias takes ``bias_axis`` or the weight's
    output axis."""
    out = {"w": tuple(axes)}
    if bias:
        out["b"] = (bias_axis if bias_axis else axes[-1],)
    return out


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


def norm_axes(kind: str):
    """``make_norm``'s leaves, replicated: one unnamed axis each."""
    names = {"rmsnorm": ("scale",), "rmsnorm_p1": ("scale",),
             "layernorm": ("scale", "bias"), "nonparam_ln": ()}[kind]
    return {name: (None,) for name in names}


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


# ---------------------------------------------------------------------------
# chunked (sqrt-remat) time loop
# ---------------------------------------------------------------------------

_loop = threading.local()  # the cost counter that asks loops to run one step


class counted_loops:
    """While active (``launch/op_cost.py``'s counter enters it), every
    ``time_loop`` of this thread runs its first step alone inside
    ``scale(n)``: a context manager that multiplies the counts of the ops
    inside it by the trip count ``n``. Loops over tens of thousands of
    positions then cost one step's dispatches to count."""

    def __init__(self, scale):
        self.scale = scale

    def __enter__(self):
        self.prev = getattr(_loop, "scale", None)
        _loop.scale = self.scale
        return self

    def __exit__(self, *exc):
        _loop.scale = self.prev


def time_loop(step, n: int, carry):
    """``step(t, carry) -> (y, carry)`` for t in range(n): the list of the
    ys and the last carry. The one loop of the state mixers' recurrences
    (Mamba's selective scan, the mLSTM's steps and chunks, the sLSTM's
    steps). Under ``counted_loops`` (the cost counter alone) it runs step 0
    with its counts multiplied by n, and the list repeats that step's y n
    times: the shapes, and the counts, of the whole loop."""
    scale = getattr(_loop, "scale", None)
    if scale is None or n <= 1:
        ys = []
        for t in range(n):
            y, carry = step(t, carry)
            ys.append(y)
        return ys, carry
    with scale(n):
        y, carry = step(0, carry)
    return [y] * n, carry


def chunked_scan(run, xs, carry, *, chunk: int = 64):
    """``run(xs, carry) -> (ys, carry)``: a Python loop over the time axis
    (dim 1) of every tensor in the tuple ``xs``, ``ys`` stacked along it.
    Under a gradient, with S > ``chunk`` and S a multiple of it, the loop
    runs chunk by chunk, each under ``torch.utils.checkpoint``: the
    backward pass keeps one carry per chunk and recomputes the steps inside
    (the reference's ``chunked_scan``: sqrt-remat over time instead of
    depth). It changes memory only: every step computes what it computes
    in one pass."""
    S = xs[0].shape[1]
    if not torch.is_grad_enabled() or S <= chunk or S % chunk:
        return run(xs, carry)
    ys = []
    for c0 in range(0, S, chunk):
        y, carry = checkpoint(run, tuple(a[:, c0:c0 + chunk] for a in xs), carry,
                              use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, dim=1), carry
