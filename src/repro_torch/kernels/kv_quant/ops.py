"""Entry points for paged KV quantization, dispatched by device.

Twins of ``repro.kernels.kv_quant.ops`` without the ``impl`` switch: CUDA
tensors launch the hand-written kernels (``kv_quant.quantize_pages`` /
``dequantize_pages``), CPU tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kv_quant import kv_quant as _kernel


def quantize_kv_pages(pages, *, bits: int = 8, axis: str = "channel",
                      plane_dtype=torch.float32):
    """pages (NP, P, C) in their own float dtype (the kernel upcasts in
    registers; the CPU path computes in f32) -> (codes uint8 (NP, P, C),
    scale, zero), planes (NP, 1, C) for ``axis="channel"`` and (NP, P, 1)
    for ``"token"`` in ``plane_dtype`` (f32 or f16, rounded once)."""
    return _kernel.quantize_pages(pages.contiguous(), bits=bits, axis=axis,
                                  plane_dtype=plane_dtype)


def dequantize_kv_pages(codes, scale, zero, *, out_dtype=torch.float32):
    """The inverse map: ``codes * scale + zero`` (NP, P, C) in ``out_dtype``."""
    return _kernel.dequantize_pages(codes.contiguous(), scale.float().contiguous(),
                                    zero.float().contiguous(), out_dtype=out_dtype)
