"""Plain PyTorch oracles for paged decode attention (fp pages).

Twins of ``repro.kernels.paged_attention.ref.paged_attention_ref`` and
``paged_attention_chunked_ref``, with the same masking: invalid positions
score ``NEG_INF`` and get probability exactly 0, and the normalizer is
clamped at ``1e-30`` so a row with no valid position returns zeros.

Semantics: one query token per sequence attends over a paged KV cache.
``lengths[b]`` counts valid tokens; page contents beyond it are garbage and
must not influence the output. Pages are gathered by ``block_tables``.
These run wherever their tensors live: the CPU path of the port, and the
yardstick the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(KV, NB, P, D) pages, (B, NP) tables -> (B, KV, NP * P, D)."""
    KV, _, P, D = pages.shape
    B, NP = block_tables.shape
    g = pages[:, block_tables.long()]  # (KV, B, NP, P, D)
    return g.transpose(0, 1).reshape(B, KV, NP * P, D)


def _softmax(s, valid):
    """s: (..., S) f32 scores, valid: bool broadcastable to s -> attention
    probabilities, exactly 0 where invalid. Shared masking of both oracles."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.clamp(l, min=1e-30)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *, scale):
    """q: (B, KV, G, D); k_pages/v_pages: (KV, NB, P, D);
    block_tables: (B, NP) int; lengths: (B,) int -> (B, KV, G, D)."""
    NP, P = block_tables.shape[1], k_pages.shape[2]
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k) * scale
    pos = torch.arange(NP * P, device=q.device)
    valid = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    p = _softmax(s, valid)
    return torch.einsum("bkgs,bksd->bkgd", p, v).to(q.dtype)


def paged_attention_chunked_ref(q, k_pages, v_pages, block_tables, lengths,
                                *, scale):
    """Direct-masking oracle for chunked extend attention (paged prefill).

    q: (B, C, KV, G, D); query j of sequence b sits at absolute position
    ``lengths[b] + j`` and the chunk's K/V is ALREADY in the pages. Row
    (b, j) sees positions ``pos <= lengths[b] + j``: the page-resident
    prefix plus in-chunk causality, in one mask. Padding rows of ragged
    chunks compute well-defined garbage the caller ignores.
    Returns (B, C, KV, G, D)."""
    C = q.shape[1]
    NP, P = block_tables.shape[1], k_pages.shape[2]
    k = _gather(k_pages, block_tables).float()
    v = _gather(v_pages, block_tables).float()
    s = torch.einsum("bckgd,bksd->bckgs", q.float(), k) * scale
    pos = torch.arange(NP * P, device=q.device)
    qpos = lengths.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    valid = (pos[None, None, :] <= qpos[:, :, None])[:, :, None, None, :]
    p = _softmax(s, valid)
    return torch.einsum("bckgs,bksd->bckgd", p, v).to(q.dtype)
