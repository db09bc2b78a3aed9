"""Entry points for paged decode / extend attention, dispatched by device.

Twins of ``repro.kernels.paged_attention.ops``, with the same layouts:

  * ``paged_decode_attention`` — kernel layout: q (B, KV, G, D), pages
    (KV, NB, P, D), per-sequence block tables (B, NP);
  * ``paged_attend`` — model layout: q (B, 1, H, D); casts engine int64
    tables to int32 and regroups heads into (KV, G = H // KV);
  * ``paged_attend_extend`` — chunked extend: q (B, C, H, D).

Dispatch is by the tensors' device and nothing else: CUDA tensors run the
hand-written kernel (``paged_attention.paged_attention``), CPU tensors the
plain PyTorch oracles in ``ref.py``. There is no implementation switch and
no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_attention as _kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_chunked_ref


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale: float):
    """Kernel layout: q (B, KV, G, D) -> (B, KV, G, D). CUDA tensors launch
    the kernel; CPU tensors run ``paged_attention_ref``."""
    return _kernel.paged_attention(
        q.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), scale=scale)


def paged_attend(q, k_pages, v_pages, block_tables, lengths, *, scale: float):
    """Model-layout adapter: q (B, 1, H, D) -> out (B, 1, H, D).

    k_pages/v_pages: (KV, NB, P, D); block_tables: (B, NP) any int dtype;
    lengths: (B,) valid tokens INCLUDING the one being decoded. Heads are
    grouped (KV, G = H // KV) consecutively."""
    B, _, H, D = q.shape
    KV = k_pages.shape[0]
    out = paged_decode_attention(q.reshape(B, KV, H // KV, D), k_pages,
                                 v_pages, block_tables, lengths, scale=scale)
    return out.reshape(B, 1, H, D)


def paged_attend_extend_folded(q, k_pages, v_pages, block_tables, lengths, *,
                               scale: float):
    """Chunked extend through the single-token op: the C query positions
    FOLD INTO THE BATCH AXIS. Row b*C + j attends over sequence b's table
    with validity ``lengths[b] + j + 1`` (page-resident prefix plus
    in-chunk causality), so one kernel launch covers all B*C rows. This is
    the CUDA path of ``paged_attend_extend``; on CPU tensors it runs the
    plain decode oracle per folded row, which the tests hold against the
    chunked oracle."""
    B, C, H, D = q.shape
    qf = q.reshape(B * C, 1, H, D)  # b-major: row b*C + j is (seq b, query j)
    row_len = (lengths.to(torch.int32)[:, None]
               + torch.arange(C, dtype=torch.int32, device=q.device)[None, :]
               + 1).reshape(B * C)
    tables_f = torch.repeat_interleave(block_tables, C, dim=0)
    out = paged_attend(qf, k_pages, v_pages, tables_f, row_len, scale=scale)
    return out.reshape(B, C, H, D)


def paged_attend_extend(q, k_pages, v_pages, block_tables, lengths, *,
                        scale: float):
    """Chunked extend attention (paged prefill): q (B, C, H, D) -> out
    (B, C, H, D). Query j of sequence b sits at absolute position
    ``lengths[b] + j``; the chunk's K/V must already be in the pages.

    CUDA: the batch-axis fold into the decode kernel
    (``paged_attend_extend_folded``). CPU: the direct chunked oracle, which
    gathers each sequence's pages once rather than C times. Padding rows of
    ragged chunks compute well-defined garbage the caller slices off."""
    B, C, H, D = q.shape
    if q.device.type == "cuda":
        return paged_attend_extend_folded(q, k_pages, v_pages, block_tables,
                                          lengths, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attend_extend: no path for device {q.device}")
    KV = k_pages.shape[0]
    out = paged_attention_chunked_ref(
        q.reshape(B, C, KV, H // KV, D), k_pages, v_pages,
        block_tables.to(torch.int32), lengths.to(torch.int32), scale=scale)
    return out.reshape(B, C, H, D)
