"""Plain PyTorch versions of the per-page KIVI pack and unpack.

Twins of ``repro.kernels.kv_quant.ref``: the CPU path of the port, and the
yardstick the CUDA kernels in ``csrc/kv_quant.cu`` are held against on the
card (codes and planes byte-equal). Every step is one IEEE-rounded f32
operation — ``(hi - lo) / qmax``, ``(x - lo) / scale``, ``codes * scale``
then ``+ zero`` — and rounding is half to even, as in ``jnp.round``.
"""
from __future__ import annotations

import torch


def quantize_pages_ref(pages, *, bits: int, axis: str):
    """pages: (NP, P, C). axis: "channel" (keys: min/max over the P tokens,
    planes (NP, 1, C)) or "token" (values: min/max over the C channels,
    planes (NP, P, 1)). Returns (codes uint8 (NP, P, C), scale f32, zero f32)."""
    x = pages.float()
    red = 1 if axis == "channel" else 2  # reduce over the other axis
    lo = torch.amin(x, dim=red, keepdim=True)
    hi = torch.amax(x, dim=red, keepdim=True)
    qmax = float(2 ** bits - 1)
    # a tensor divisor: on CUDA PyTorch turns division by a Python scalar
    # into a product with its reciprocal, which may differ in the last bit
    scale = (hi - lo) / torch.full_like(hi, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round((x - lo) / scale), 0, qmax).to(torch.uint8)
    return codes, scale, lo


def dequantize_pages_ref(codes, scale, zero, *, out_dtype=torch.float32):
    """codes (NP, P, C) uint8 with planes (NP, 1, C) or (NP, P, 1) ->
    ``codes * scale + zero`` in ``out_dtype``."""
    return (codes.float() * scale.float() + zero.float()).to(out_dtype)
