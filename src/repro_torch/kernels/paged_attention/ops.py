"""Entry points for paged decode / extend attention, dispatched by device.

Twins of ``repro.kernels.paged_attention.ops``, with the same layouts:

  * ``paged_decode_attention`` — kernel layout: q (B, KV, G, D), pages
    (KV, NB, P, D), per-sequence block tables (B, NP);
  * ``paged_attend`` — model layout: q (B, 1, H, D); casts engine int64
    tables to int32 and regroups heads into (KV, G = H // KV);
  * ``paged_attend_extend`` — chunked extend: q (B, C, H, D);
  * ``paged_decode_attention_quant`` / ``paged_attend_quant`` /
    ``paged_attend_extend_quant`` — the same three over KIVI pages:
    ``{"codes", "scale", "zero"}`` dicts plus a full-precision tail; bf16 /
    f16 extend runs the kernel's native chunked path there too.

Dispatch is by the tensors' device and nothing else: CUDA tensors run the
hand-written kernels (``paged_attention.paged_attention``,
``paged_attention_quant.paged_attention_quant``), CPU tensors the plain
PyTorch oracles in ``ref.py``. There is no implementation switch and no
fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_attention as _kernel
from repro_torch.kernels.paged_attention import paged_attention_quant as _qkernel
from repro_torch.kernels.paged_attention.ref import paged_attention_chunked_quant_ref


def _i32(t):
    return t.to(torch.int32).contiguous()


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale: float):
    """Kernel layout: q (B, KV, G, D) -> (B, KV, G, D). CUDA tensors launch
    the kernel; CPU tensors run ``paged_attention_ref``."""
    return _kernel.paged_attention(
        q.contiguous(), k_pages, v_pages, _i32(block_tables), _i32(lengths),
        scale=scale)


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
    FOLD INTO THE BATCH AXIS, the reference's strategy. Row b*C + j attends
    over sequence b's table with validity ``lengths[b] + j + 1``
    (page-resident prefix plus in-chunk causality), so one kernel launch
    covers all B*C rows, but every row re-reads its sequence's pages. This
    is the CUDA path of ``paged_attend_extend`` for fp32 only (the
    ``cuda_core`` route takes decode rows only); on CPU tensors it runs the
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

    CUDA bf16 / f16: one launch of the kernel's native chunked path
    (``rows_per_seq=C``), which reads each page once per (sequence, KV
    head, row tile). CUDA fp32: the batch-axis fold
    (``paged_attend_extend_folded``), by ``kernel_route``. CPU: the direct
    chunked oracle, which gathers each sequence's pages once. Padding rows
    of ragged chunks compute well-defined garbage the caller slices off."""
    B, C, H, D = q.shape
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_attend_extend: no path for device {q.device}")
    if q.device.type == "cuda" and _kernel.kernel_route(q.dtype, D) == "cuda_core":
        return paged_attend_extend_folded(q, k_pages, v_pages, block_tables,
                                          lengths, scale=scale)
    KV = k_pages.shape[0]
    out = _kernel.paged_attention(
        q.reshape(B, C, KV, H // KV, D).contiguous(), k_pages, v_pages,
        _i32(block_tables), _i32(lengths), scale=scale, rows_per_seq=C)
    return out.reshape(B, C, H, D)


# ---------------------------------------------------------------------------
# quantized pages (KIVI at rest)
# ---------------------------------------------------------------------------

def paged_decode_attention_quant(q, k_pages, v_pages, k_tail, v_tail,
                                 block_tables, lengths, tail_start, *,
                                 scale: float, deq_dtype=torch.float32,
                                 rows_per_seq: int = 1):
    """Kernel layout over quantized pages. ``k_pages``/``v_pages`` are
    {"codes", "scale", "zero"} dicts (codes (KV, NB, P, D) uint8, key planes
    (KV, NB, 1, D), value planes (KV, NB, P, 1)); ``k_tail``/``v_tail``
    (B, T, KV, D) hold positions ``tail_start`` up. ``deq_dtype`` is the
    cache's logical dtype. CUDA tensors launch the kernel; CPU tensors run
    ``paged_attention_quant_ref``."""
    return _qkernel.paged_attention_quant(
        q.contiguous(), k_pages["codes"], k_pages["scale"], k_pages["zero"],
        v_pages["codes"], v_pages["scale"], v_pages["zero"],
        k_tail.contiguous(), v_tail.contiguous(), _i32(block_tables),
        _i32(lengths), _i32(tail_start), scale=scale, deq_dtype=deq_dtype,
        rows_per_seq=rows_per_seq)


def paged_attend_quant(q, k_pages, v_pages, k_tail, v_tail, block_tables,
                       lengths, tail_start, *, scale: float,
                       deq_dtype=torch.float32):
    """Model-layout adapter for quantized pages: q (B, 1, H, D) ->
    (B, 1, H, D), heads regrouped like ``paged_attend``. ``lengths`` counts
    valid tokens INCLUDING the tail tokens this row attends; ``tail_start``
    counts the tokens resident in the quantized pages."""
    B, _, H, D = q.shape
    KV = k_pages["codes"].shape[0]
    out = paged_decode_attention_quant(
        q.reshape(B, KV, H // KV, D), k_pages, v_pages, k_tail, v_tail,
        block_tables, lengths, tail_start, scale=scale, deq_dtype=deq_dtype)
    return out.reshape(B, 1, H, D)


def paged_attend_extend_quant(q, k_pages, v_pages, k_tail, v_tail,
                              block_tables, lengths, tail_start, *,
                              scale: float, deq_dtype=torch.float32):
    """Chunked extend attention over quantized pages: q (B, C, H, D) ->
    (B, C, H, D), query j of sequence b at position ``lengths[b] + j``.

    Quantized page slots serve positions ``< tail_start[b]``; everything from
    ``tail_start`` up — the still-filling page AND this chunk's own K/V,
    already at their tail slots — comes from the fp tail (B, T, KV, D).
    CUDA: one kernel launch per call with ``rows_per_seq=C``: row b*C + j
    has length ``lengths[b] + j + 1`` (in-chunk causality) and takes
    sequence b's table, ``tail_start`` and tail, which are not repeated in
    memory. On the mma route (bf16 / f16 q dequantizing into its own dtype,
    ``paged_attention_quant.kernel_route``) that is the native chunked
    path: each page is read and dequantized once per (sequence, KV head,
    16-row tile of the C x G rows). On the CUDA-core route it is the
    batch-axis fold: a CTA per row, each re-reading its sequence's pages.
    CPU: the direct chunked oracle, which dequantizes each sequence's pages
    once rather than C times."""
    B, C, H, D = q.shape
    KV = k_pages["codes"].shape[0]
    G = H // KV
    if q.device.type == "cuda":
        row_len = (lengths.to(torch.int32)[:, None]
                   + torch.arange(C, dtype=torch.int32, device=q.device)[None, :]
                   + 1).reshape(B * C)
        out = paged_decode_attention_quant(
            q.reshape(B * C, KV, G, D), k_pages, v_pages, k_tail, v_tail,
            block_tables, row_len, tail_start, scale=scale, deq_dtype=deq_dtype,
            rows_per_seq=C)
        return out.reshape(B, C, H, D)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attend_extend_quant: no path for device {q.device}")
    out = paged_attention_chunked_quant_ref(
        q.reshape(B, C, KV, G, D),
        k_pages["codes"], k_pages["scale"], k_pages["zero"],
        v_pages["codes"], v_pages["scale"], v_pages["zero"],
        k_tail, v_tail, block_tables.to(torch.int32), lengths.to(torch.int32),
        tail_start.to(torch.int32), scale=scale, deq_dtype=deq_dtype)
    return out.reshape(B, C, H, D)
