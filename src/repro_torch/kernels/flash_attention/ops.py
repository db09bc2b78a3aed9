"""Entry point for the causal flash prefill attention, dispatched by device.

The twin of ``repro.kernels.flash_attention.ops.flash_prefill_attention``
without the ``impl`` switch and the block sizes: CUDA tensors launch the
hand-written kernel (``flash_attention.flash_prefill``), CPU tensors take
the plain version in ``ref.py``. There is no fallback from one to the
other.

The entry point is the ``torch.library`` custom op
``repro_torch::flash_prefill``, so a dispatch mode sees one op where the
kernel runs: on the meta device its fake implementation gives the output's
shape and computes nothing (the dry-run, ``launch/dryrun.py``), and
``flash_prefill_cost`` is the work the dry-run's counter
(``launch/op_cost.py``) registers for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel


@torch.library.custom_op("repro_torch::flash_prefill", mutates_args=())
def _flash_prefill_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      window: int) -> torch.Tensor:
    return _kernel.flash_prefill(q, k, v, scale=scale, window=window)


@_flash_prefill_op.register_fake
def _(q, k, v, scale, window):
    return torch.empty_like(q)


def flash_prefill(q, k, v, *, scale: float, window: int = 0):
    """q: (B, H, S, D); k/v: (B, KV, S, D), any strides with D contiguous ->
    (B, H, S, D) in q's dtype: causal attention of each sequence over its
    own first S positions, query head h reading KV head h // (H // KV),
    and with ``window > 0`` only keys j > i - window."""
    return _flash_prefill_op(q, k, v, float(scale), int(window))


def causal_pairs(S: int, window: int = 0) -> int:
    """The (query, key) pairs a causal attention over S positions takes,
    each query i over keys max(0, i - window + 1)..i under ``window > 0``."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_prefill_cost(q, k, v, out, window: int = 0) -> dict:
    """The work of one ``flash_prefill``: flops 4 * B * H * D * (causal pairs
    inside the window) (QK^T and PV, two flops a multiply-add), the
    softmax's exponentials one a pair and head, and bytes q, k and v read
    once and the output written once."""
    B, H, S, D = q.shape
    pairs = causal_pairs(S, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    return {"flops": 4.0 * B * H * D * pairs, "transcendentals": float(B * H * pairs),
            "eltwise": 0.0, "bytes": float(nbytes)}
