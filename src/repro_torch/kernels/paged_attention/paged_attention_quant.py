"""Hand-written CUDA paged decode attention over KIVI pages, and its wrapper.

``csrc/paged_attention_quant.cu`` replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention_quant``;
it is built and bound by ``kernels/_build.py``.

``paged_attention_quant`` dispatches on the device its tensors live on: CPU
tensors take the plain PyTorch version (``ref.paged_attention_quant_ref``),
CUDA tensors launch the kernel, anything else raises. A CUDA call never
falls back. ``paged_attention_quant.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_quant_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "paged_attention_quant.cu"
SIGNATURES = {
    "paged_attention_quant_launch": (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "paged_attention_quant_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_longlong),
    "paged_attention_quant_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
_PAGE_SIZES = (4, 8, 16, 32)


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
                          rows_per_seq: int = 1):
    """q (R, KV, G, D) with R = B * rows_per_seq; codes (KV, NB, P, D) uint8;
    key planes (KV, NB, 1, D) and value planes (KV, NB, P, 1) f16; tails
    (B, T, KV, D) in q's dtype; block_tables (B, NP), tail_start (B,) and
    lengths (R,) int32 -> (R, KV, G, D) in q's dtype. Row r is sequence
    r // rows_per_seq (see ``ref.paged_attention_quant_ref`` for the rest)."""
    args = (q, k_codes, k_scale, k_zero, v_codes, v_scale, v_zero, k_tail, v_tail,
            block_tables, lengths, tail_start)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"paged_attention_quant: tensors on several devices {devices}")
    if q.device.type == "cpu":
        return paged_attention_quant_ref(*args, scale=scale, deq_dtype=deq_dtype,
                                         rows_per_seq=rows_per_seq)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant: no kernel for device {q.device}")
    _check(*args, rows_per_seq)
    if deq_dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention_quant: deq_dtype {deq_dtype} not in "
                        f"{tuple(_DTYPE_CODES)}")
    R, KV, G, D = q.shape
    _, NB, P, _ = k_codes.shape
    NP, T = block_tables.shape[1], k_tail.shape[1]
    lib = _build.load(SOURCE, SIGNATURES)
    smem = lib.paged_attention_quant_smem_bytes(G, D)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"paged_attention_quant: G={G}, D={D} needs {smem} bytes of "
                         f"shared memory, more than {_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if R * KV == 0:
        return out
    with torch.cuda.device(q.device):
        err = lib.paged_attention_quant_launch(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[deq_dtype],
            *(t.data_ptr() for t in args), out.data_ptr(),
            R, rows_per_seq, KV, G, D, NB, P, NP, T, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.paged_attention_quant_error_string,
                        "paged_attention_quant", err)
    paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0
