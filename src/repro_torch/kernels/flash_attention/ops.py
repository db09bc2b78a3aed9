"""Entry point for the causal flash prefill attention, dispatched by device.

The twin of ``repro.kernels.flash_attention.ops.flash_prefill_attention``
without the ``impl`` switch and the block sizes: CUDA tensors launch the
hand-written kernel (``flash_attention.flash_prefill``), CPU tensors take
the plain version in ``ref.py``. There is no fallback from one to the
other.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention as _kernel


def flash_prefill(q, k, v, *, scale: float, window: int = 0):
    """q: (B, H, S, D); k/v: (B, KV, S, D), any strides with D contiguous ->
    (B, H, S, D) in q's dtype: causal attention of each sequence over its
    own first S positions, query head h reading KV head h // (H // KV),
    and with ``window > 0`` only keys j > i - window."""
    return _kernel.flash_prefill(q, k, v, scale=scale, window=window)
