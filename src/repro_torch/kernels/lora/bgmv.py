"""Hand-written CUDA batched grouped LoRA matmul for Hopper, and its wrapper.

``csrc/bgmv.cu`` replaces the Pallas TPU kernel
``repro/kernels/lora/lora.py::bgmv``; it is built and bound by
``kernels/_build.py``.

``bgmv`` dispatches on the device its tensors live on: CPU tensors take the
plain PyTorch version (``ref.bgmv_ref``), CUDA tensors launch the kernel,
anything else raises; a CUDA call never falls back. ``bgmv.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora.ref import bgmv_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "bgmv.cu"
SIGNATURES = {
    "bgmv_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p], ctypes.c_int),
    "bgmv_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

MAX_RANK = 64  # kMaxRank in csrc/bgmv.cu
MAX_ROWS = 65535  # batch rows: the grid's z extent
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(x, a, b, idx) -> None:
    """Everything the kernel assumes, checked before a pointer leaves Python."""
    if x.dim() != 3 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"bgmv: x {tuple(x.shape)} must be (B, C, Din), a "
                         f"{tuple(a.shape)} (T, Din, R), b {tuple(b.shape)} (T, R, Dout)")
    B, _, Din = x.shape
    T, _, R = a.shape
    if a.shape[1] != Din or b.shape[0] != T or b.shape[1] != R:
        raise ValueError(f"bgmv: a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)} as (T, Din, R) and (T, R, Dout)")
    if tuple(idx.shape) != (B,):
        raise ValueError(f"bgmv: idx {tuple(idx.shape)} must be (B={B},)")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bgmv: x is {x.dtype}; need one of float32/bfloat16/float16")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"bgmv: a and b must be float32, got {a.dtype} and {b.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"bgmv: idx must be int32, got {idx.dtype}")
    if not 1 <= R <= MAX_RANK:
        raise ValueError(f"bgmv: rank {R} not in [1, {MAX_RANK}]")
    if B > MAX_ROWS:
        raise ValueError(f"bgmv: {B} rows, more than {MAX_ROWS}")
    for name, t in (("x", x), ("a", a), ("b", b), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"bgmv: {name} must be contiguous")


def bgmv(x, a, b, idx):
    """x: (B, C, Din); a: (T, Din, R) f32; b: (T, R, Dout) f32; idx: (B,)
    int32 -> (B, C, Dout) in x's dtype: ``y[b] = x[b] @ a[idx[b]] @
    b[idx[b]]``, accumulated in f32. Ids must lie in [0, T): on the card a
    row with any other id comes back as NaN."""
    devices = {t.device for t in (x, a, b, idx)}
    if len(devices) != 1:
        raise ValueError(f"bgmv: tensors on several devices {devices}")
    if x.device.type == "cpu":
        return bgmv_ref(x, a, b, idx)
    if x.device.type != "cuda":
        raise ValueError(f"bgmv: no kernel for device {x.device}")
    _check(x, a, b, idx)
    B, C, Din = x.shape
    T, _, R = a.shape
    Dout = b.shape[2]
    y = torch.empty((B, C, Dout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.bgmv_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), a.data_ptr(), b.data_ptr(),
            idx.data_ptr(), y.data_ptr(), B, C, Din, R, Dout, T,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.bgmv_error_string, "bgmv", err)
    bgmv.launches += 1
    return y


bgmv.launches = 0
