"""Entry points for paged KV quantization, dispatched by device.

Twins of ``repro.kernels.kv_quant.ops`` without the ``impl`` switch: CUDA
tensors launch the hand-written kernels (``kv_quant.quantize_pages`` /
``dequantize_pages``), CPU tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kv_quant import kv_quant as _kernel


def quantize_kv_pages(pages, *, bits: int = 8, axis: str = "channel"):
    """pages (NP, P, C) -> (codes uint8 (NP, P, C), scale, zero) f32, planes
    (NP, 1, C) for ``axis="channel"`` and (NP, P, 1) for ``"token"``."""
    return _kernel.quantize_pages(pages.float().contiguous(), bits=bits, axis=axis)


def dequantize_kv_pages(codes, scale, zero, *, out_dtype=torch.float32):
    """The inverse map: ``codes * scale + zero`` (NP, P, C) in ``out_dtype``."""
    return _kernel.dequantize_pages(codes.contiguous(), scale.float().contiguous(),
                                    zero.float().contiguous(), out_dtype=out_dtype)
