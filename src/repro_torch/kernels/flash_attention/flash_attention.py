"""Hand-written CUDA causal flash prefill attention for Hopper, and its wrapper.

``csrc/flash_prefill.cu`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_prefill``; it is
built and bound by ``kernels/_build.py``. Unlike the TPU kernel it reads
q/k/v through their strides (so a ``(B, S, H, D)`` activation transposed
to ``(B, H, S, D)`` is read in place) and takes any sequence length.

``flash_prefill`` dispatches on the device its tensors live on: CPU tensors
take the plain PyTorch version (``ref.flash_prefill_ref``), CUDA tensors
launch the kernel, anything else raises; a CUDA call never falls back.
Which of the source's two kernels a CUDA call launches depends on dtype and
head_dim alone (``kernel_route``). ``flash_prefill.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_prefill_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "flash_prefill.cu"
SIGNATURES = {
    "flash_prefill_launch": (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int),
    "flash_prefill_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "flash_prefill_smem_bytes": ([ctypes.c_int] * 2, ctypes.c_int),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
MAX_GRID_YZ = 65535  # the grid's y and z extents: heads, batch rows, row tiles
# the source's kernels, by the route code its C entry point takes
ROUTES = {"cuda_core": 0, "wgmma": 1}


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches: ``"wgmma"`` (TMA-fed tensor-core
    kernel) for bf16 / f16 at head_dim 64 or 128, else ``"cuda_core"``
    (fp32, where TF32 would break the f32 tolerance; head_dim 256, too wide
    for the wgmma kernel's shared memory; 16-bit head_dim 32)."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim in (64, 128):
        return "wgmma"
    return "cuda_core"


def _check(q, k, v, window) -> None:
    """Everything the kernel assumes, checked before a pointer leaves Python."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} must be (B, H, S, D), "
                         f"k {tuple(k.shape)} and v {tuple(v.shape)} equal (B, KV, S, D)")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} as (B, KV, S, D) with H % KV == 0")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill: dtypes q={q.dtype} k={k.dtype} v={v.dtype}; "
                        "need one of float32/bfloat16/float16 for all three")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {D} not in {_HEAD_DIMS}")
    if H > MAX_GRID_YZ or B > MAX_GRID_YZ or S > MAX_GRID_YZ * 128:
        raise ValueError(f"flash_prefill: B={B}, H={H}, S={S}; at most {MAX_GRID_YZ} "
                         f"each, S at most {MAX_GRID_YZ * 128}")
    if int(window) < 0:
        raise ValueError(f"flash_prefill: window {window} must be >= 0")
    isz = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_prefill: {name} must be contiguous along D "
                             f"(strides {t.stride()})")
        if any(s * isz % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_prefill: {name} rows must be 16-byte aligned "
                             f"(strides {t.stride()}, {isz}-byte elements)")


def flash_prefill(q, k, v, *, scale: float, window: int = 0):
    """q: (B, H, S, D); k/v: (B, KV, S, D) -> (B, H, S, D) in q's dtype, in
    q's memory layout. Causal; ``window > 0`` adds j > i - window."""
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_prefill: tensors on several devices {devices}")
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    _check(q, k, v, window)
    B, H, S, D = q.shape
    out = torch.empty_like(q)  # keeps q's strides when q is dense
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_prefill_launch(
            _DTYPE_CODES[q.dtype], ROUTES[kernel_route(q.dtype, D)], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], S, D,
            ctypes.addressof(strides), float(scale), int(window),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.flash_prefill_error_string, "flash_prefill", err)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
