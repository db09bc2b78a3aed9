"""Hand-written CUDA paged attention over KIVI pages for Hopper (decode and
chunked extend), and its wrapper.

``csrc/paged_attention_quant.cu`` replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention_quant``;
it is built and bound by ``kernels/_build.py``.

``paged_attention_quant`` dispatches on the device its tensors live on: CPU
tensors take the plain PyTorch version (``ref.paged_attention_quant_ref``,
or its split-K twin ``paged_attention_quant_split_ref`` when ``splits`` is
given), CUDA tensors launch a kernel, anything else raises. A CUDA call
never falls back: a failed build or launch raises with the compiler's or
the CUDA runtime's message. Which of the source's two kernels a CUDA call
launches depends on dtypes alone (``kernel_route``); how many CTAs split
each row tile's key axis is planned on the host from shapes alone
(``plan_splits``), never from ``lengths``. ``paged_attention_quant.launches``
counts the calls that launched a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.paged_attention import (
    MAX_GRID_Y, plan_tile_splits)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_quant_ref, paged_attention_quant_split_ref)

SOURCE = Path(__file__).resolve().with_name("csrc") / "paged_attention_quant.cu"
SIGNATURES = {
    "paged_attention_quant_launch": (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "paged_attention_quant_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "paged_attention_quant_ctas_per_sm": ([ctypes.c_int] * 2, ctypes.c_int),
    "paged_attention_quant_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
_PAGE_SIZES = (4, 8, 16, 32)
# the source's kernels, by the route code its C entry point takes
ROUTES = {"cuda_core": 0, "mma": 1}
PAGE_TILE = 64      # page positions per page tile of the mma kernel (kTK)
TAIL_TILE = 32      # tail slots per tail tile (kTT)
ROWS_PER_CTA = 16   # query rows (c, g) per CTA of the mma kernel (kRows)


def kernel_route(dtype: torch.dtype, deq_dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches: ``"mma"`` (the tensor-core kernel,
    decode and chunked extend, split-K) where q is bf16 / f16 and the pages
    dequantize into q's own dtype, at every accepted head_dim (32, 64, 128,
    256): a dequantized value is then exactly a tensor-core operand.
    ``"cuda_core"`` otherwise: for fp32 TF32 would break the 1e-5
    tolerance, and a ``deq_dtype`` other than q's would be rounded a second
    time on its way into the tensor cores, which the plain version does not
    do. The CUDA-core kernel gives every query row its own CTA: extend
    through it is the batch-axis fold, each row re-reading the pages."""
    if dtype in (torch.bfloat16, torch.float16) and deq_dtype == dtype \
            and head_dim in _HEAD_DIMS:
        return "mma"
    return "cuda_core"


def plan_splits(ctas: int, page_keys: int, tail_keys: int, sm_count: int,
                ctas_per_sm: int = 2) -> int:
    """How many CTAs split each row tile's key axis (mma route). ``ctas``:
    B * KV * row tiles; ``page_keys``: NP * P, the table width; ``tail_keys``:
    T, the tail's width (not the lengths or tail_start, which would cost a
    device-to-host read per layer). The key axis is ceil(page_keys / 64)
    page tiles and ceil(tail_keys / 32) tail tiles; the rule is
    ``paged_attention.plan_splits``'s (waves of ``sm_count`` x
    ``ctas_per_sm`` CTAs, a split of ``per`` tiles costing ``per + 1``
    tile times): at least one split, never more than tiles."""
    tiles = -(-page_keys // PAGE_TILE) + -(-tail_keys // TAIL_TILE)
    return plan_tile_splits(ctas, tiles, sm_count, ctas_per_sm)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(dtype_code: int, head_dim: int) -> int:
    """The mma kernel's CTAs per SM (the CUDA occupancy query)."""
    n = _load().paged_attention_quant_ctas_per_sm(dtype_code, head_dim)
    if n <= 0:
        raise RuntimeError(f"paged_attention_quant: occupancy query failed ({n})")
    return n


def planned_splits(q, block_tables, k_codes, k_tail, rows_per_seq: int = 1) -> int:
    """The split count a CUDA call with these tensors plans (mma route)."""
    R, KV, G, D = q.shape
    B = block_tables.shape[0]
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return plan_splits(B * KV * math.ceil(rows_per_seq * G / ROWS_PER_CTA),
                       block_tables.shape[1] * k_codes.shape[2], k_tail.shape[1],
                       _sm_count(index), _ctas_per_sm(_DTYPE_CODES[q.dtype], D))


def _load() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def _check(q, kc, ks, kz, vc, vs, vz, kt, vt, tables, lengths, tail_start,
           rows_per_seq) -> None:
    """Everything the kernel assumes, checked before a pointer leaves Python."""
    name = "paged_attention_quant"
    if q.dim() != 4 or kc.dim() != 4 or kc.shape != vc.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be (R, KV, G, D), codes "
                         f"{tuple(kc.shape)} / {tuple(vc.shape)} equal (KV, NB, P, D)")
    R, KV, G, D = q.shape
    _, NB, P, _ = kc.shape
    B = tables.shape[0] if tables.dim() == 2 else -1
    T = kt.shape[1] if kt.dim() == 4 else -1
    want = {"k_codes": (kc, (KV, NB, P, D)), "k_scale": (ks, (KV, NB, 1, D)),
            "k_zero": (kz, (KV, NB, 1, D)), "v_scale": (vs, (KV, NB, P, 1)),
            "v_zero": (vz, (KV, NB, P, 1)), "k_tail": (kt, (B, T, KV, D)),
            "v_tail": (vt, (B, T, KV, D)), "lengths": (lengths, (R,)),
            "tail_start": (tail_start, (B,))}
    for arg, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} must be {shape} for q "
                             f"{tuple(q.shape)}, tables {tuple(tables.shape)}")
    if B * rows_per_seq != R:
        raise ValueError(f"{name}: {R} query rows are not {B} sequences x "
                         f"rows_per_seq {rows_per_seq}")
    if q.dtype not in _DTYPE_CODES or kt.dtype != q.dtype or vt.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype} and tails {kt.dtype}/{vt.dtype} must "
                        "share one of float32/bfloat16/float16")
    if kc.dtype != torch.uint8 or vc.dtype != torch.uint8:
        raise TypeError(f"{name}: codes must be uint8")
    if any(t.dtype != torch.float16 for t in (ks, kz, vs, vz)):
        raise TypeError(f"{name}: scale/zero planes must be float16")
    if any(t.dtype != torch.int32 for t in (tables, lengths, tail_start)):
        raise TypeError(f"{name}: block_tables, lengths and tail_start must be int32")
    if D not in _HEAD_DIMS or P not in _PAGE_SIZES:
        raise ValueError(f"{name}: head_dim {D} not in {_HEAD_DIMS} or page size "
                         f"{P} not in {_PAGE_SIZES}")
    args = dict(q=q, k_codes=kc, k_scale=ks, k_zero=kz, v_codes=vc, v_scale=vs,
                v_zero=vz, k_tail=kt, v_tail=vt, block_tables=tables,
                lengths=lengths, tail_start=tail_start)
    for arg, t in args.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def paged_attention_quant(q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero,
                          k_tail, v_tail, block_tables, lengths, tail_start, *,
                          scale: float, deq_dtype=torch.float32,
                          rows_per_seq: int = 1, splits: Optional[int] = None):
    """q (R, KV, G, D) with R = B * rows_per_seq; codes (KV, NB, P, D) uint8;
    key planes (KV, NB, 1, D) and value planes (KV, NB, P, 1) f16; tails
    (B, T, KV, D) in q's dtype; block_tables (B, NP), tail_start (B,) and
    lengths (R,) int32 -> (R, KV, G, D) in q's dtype. Row r is sequence
    r // rows_per_seq (see ``ref.paged_attention_quant_ref`` for the rest);
    rows_per_seq = C is chunked extend, q (B, C, KV, G, D) in memory.

    ``splits``: CTAs per row tile along the key axis of the mma route; None
    plans it (``plan_splits``). On CPU tensors a given ``splits`` runs the
    split-K twin ``paged_attention_quant_split_ref``, else the plain
    version."""
    args = (q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail, v_tail,
            block_tables, lengths, tail_start)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"paged_attention_quant: tensors on several devices {devices}")
    if q.device.type == "cpu":
        if splits is not None:
            return paged_attention_quant_split_ref(
                *args, scale=scale, splits=splits, deq_dtype=deq_dtype,
                rows_per_seq=rows_per_seq)
        return paged_attention_quant_ref(*args, scale=scale, deq_dtype=deq_dtype,
                                         rows_per_seq=rows_per_seq)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant: no kernel for device {q.device}")
    out = _launch(kernel_route(q.dtype, deq_dtype, q.shape[-1]), *args, scale=scale,
                  deq_dtype=deq_dtype, rows_per_seq=rows_per_seq, splits=splits)
    paged_attention_quant.launches += 1
    return out


def _launch(route, q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail,
            v_tail, block_tables, lengths, tail_start, *, scale, deq_dtype,
            rows_per_seq, splits):
    """Check CUDA tensors and launch ``route``'s kernel: the wrapper passes
    ``kernel_route``'s choice; ``chip_smoke.py`` times the CUDA-core kernel
    at the mma route's 16-bit shapes beside it."""
    args = (q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail, v_tail,
            block_tables, lengths, tail_start)
    _check(*args, rows_per_seq)
    if deq_dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention_quant: deq_dtype {deq_dtype} not in "
                        f"{tuple(_DTYPE_CODES)}")
    R, KV, G, D = q.shape
    _, NB, P, _ = k_codes.shape
    NP, T = block_tables.shape[1], k_tail.shape[1]
    lib = _load()
    if route == "cuda_core":
        if splits not in (None, 1):
            raise ValueError(f"paged_attention_quant: the {route} kernel takes no "
                             f"splits (splits={splits}); it serves {q.dtype} q with "
                             f"deq_dtype {deq_dtype}")
        smem = lib.paged_attention_quant_smem_bytes(ROUTES[route], G, D)
        if smem > _build.MAX_SMEM_BYTES:
            raise ValueError(f"paged_attention_quant: G={G}, D={D} needs {smem} bytes "
                             f"of shared memory, more than {_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if route == "cuda_core":
        splits = 1
    elif splits is None:
        splits = planned_splits(q, block_tables, k_codes, k_tail, rows_per_seq)
    if not 1 <= splits <= MAX_GRID_Y:
        raise ValueError(f"paged_attention_quant: splits={splits} not in "
                         f"[1, {MAX_GRID_Y}]")
    ws = torch.empty(splits * R * KV * G * (D + 2) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.paged_attention_quant_launch(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[deq_dtype], ROUTES[route],
            *(t.data_ptr() for t in args), out.data_ptr(), ws.data_ptr(),
            R, rows_per_seq, KV, G, D, NB, P, NP, T, splits, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.paged_attention_quant_error_string,
                        "paged_attention_quant", err)
    return out


paged_attention_quant.launches = 0
