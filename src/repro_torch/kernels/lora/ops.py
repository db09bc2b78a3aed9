"""Entry point for the batched grouped LoRA matmul, dispatched by device.

The twin of ``repro.kernels.lora.ops.bgmv`` without the ``impl`` switch:
CUDA tensors launch the hand-written kernel (``bgmv.bgmv``), CPU tensors
take the plain version in ``ref.py``. The LoRA scale ``alpha / rank`` is
folded into the B table when an adapter is loaded
(``core/lora/store.py``), so it is not an argument here. ``bgmv_add`` is
the op the models call: up to three sites that share x (an attention
layer's wq, wk and wv) in one launch, each delta added to its site's base
output in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lora import bgmv as _kernel


def bgmv(x, a, b, idx):
    """Per-row ``y[b] = x[b] @ a[idx[b]] @ b[idx[b]]`` over stacked adapter
    tables. x: (B, C, Din); a: (T, Din, R); b: (T, R, Dout); idx: (B,) of
    any integer dtype -> (B, C, Dout) in x's dtype. Slot 0 of the tables is
    the null adapter (zeros) by engine convention."""
    return _kernel.bgmv(x.contiguous(), a.contiguous(), b.contiguous(),
                        idx.to(torch.int32).contiguous())


def bgmv_add(x, idx, sites):
    """Per site ``(a, b, base)``: ``base + x @ a[idx] @ b[idx]`` written
    into ``base`` in place (base (B, C, Dout) in x's dtype, contiguous; None
    returns the delta), 1 to 3 sites of one rank sharing x, one kernel
    launch on the card. Returns the sites' outputs."""
    return _kernel.bgmv_add(x.contiguous(), idx.to(torch.int32).contiguous(),
                            [(a.contiguous(), b.contiguous(), base)
                             for a, b, base in sites])
