"""Plain PyTorch version of the batched grouped LoRA matmul.

The twin of ``repro.kernels.lora.ref``: the CPU path of the port, and the
yardstick the CUDA kernel in ``csrc/bgmv.cu`` is held against on the card.
Every batch row carries its own adapter id; one call computes

    y[b] = (x[b] @ A[idx[b]]) @ B[idx[b]]

over the whole heterogeneous batch. Slot 0 of the tables is the engine's
null adapter (all zeros), so base-model rows get a delta of exactly 0.
``bgmv_add_ref`` is the plain version of the fused op: per site, the delta
added to the site's base output (in place), or returned where there is none.
"""
from __future__ import annotations

import torch


def bgmv_ref(x, a, b, idx):
    """x: (B, C, Din); a: (T, Din, R); b: (T, R, Dout); idx: (B,) int ->
    (B, C, Dout) in x's dtype (f32 accumulation, one rounding at the end)."""
    idx = idx.long()
    ag = a.index_select(0, idx).float()  # (B, Din, R)
    bg = b.index_select(0, idx).float()  # (B, R, Dout)
    h = torch.einsum("bcd,bdr->bcr", x.float(), ag)
    return torch.einsum("bcr,bro->bco", h, bg).to(x.dtype)


def bgmv_add_ref(x, idx, sites):
    """x: (B, C, Din); idx: (B,) int; sites: ``(a, b, base)`` with base
    (B, C, Dout) in x's dtype or None -> per site ``base`` updated in place
    to ``base + bgmv_ref(x, a, b, idx)``, or the delta where base is None."""
    out = []
    for a, b, base in sites:
        delta = bgmv_ref(x, a, b, idx)
        out.append(delta if base is None else base.add_(delta))
    return out
