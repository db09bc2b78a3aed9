"""Plain PyTorch version of the causal flash prefill attention (GQA-aware).

The twin of ``repro.kernels.flash_attention.ref``: the CPU path of the
port, and the yardstick the CUDA kernel in ``csrc/flash_prefill.cu`` is
held against on the card. The same ``NEG_INF``, masked probabilities set to
0 and the row sum floored at 1e-30.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_prefill_ref(q, k, v, *, scale: float, window: int = 0):
    """q: (B, H, S, D); k/v: (B, KV, S, D) -> (B, H, S, D) in q's dtype.
    Causal (key j attends to query i iff j <= i); ``window > 0`` also
    requires j > i - window. Any strides; math in f32."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    qr = q.reshape(B, KV, G, S, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qr, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= j > i - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p / torch.clamp_min(l, 1e-30), v.float())
    return o.reshape(B, H, S, D).to(q.dtype)
