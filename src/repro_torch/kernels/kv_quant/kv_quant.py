"""Hand-written CUDA per-page KIVI pack and unpack for Hopper, and wrappers.

``csrc/kv_quant.cu`` replaces the Pallas TPU kernels
``repro/kernels/kv_quant/kv_quant.py::quantize_pages`` and
``::dequantize_pages``; it is built and bound by ``kernels/_build.py``.

Both wrappers dispatch on the device their tensors live on: CPU tensors take
the plain PyTorch versions (``ref.py``), CUDA tensors launch the kernel,
anything else raises; a CUDA call never falls back. ``quantize_pages.launches``
and ``dequantize_pages.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant.ref import dequantize_pages_ref, quantize_pages_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "kv_quant.cu"
SIGNATURES = {
    "kv_quantize_pages_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int),
    "kv_dequantize_pages_launch": (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p], ctypes.c_int),
    "kv_quant_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

BITS = (2, 4, 8)
AXES = ("channel", "token")
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _device(name, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def _plane_shape(NP, P, C, axis):
    return (NP, 1, C) if axis == "channel" else (NP, P, 1)


def quantize_pages(pages, *, bits: int = 8, axis: str = "channel"):
    """pages (NP, P, C) f32 -> (codes uint8 (NP, P, C), scale, zero) f32
    with planes (NP, 1, C) for ``axis="channel"``, (NP, P, 1) for "token"."""
    dev = _device("quantize_pages", pages)
    if dev.type == "cpu":
        return quantize_pages_ref(pages, bits=bits, axis=axis)
    if bits not in BITS or axis not in AXES:
        raise ValueError(f"quantize_pages: bits {bits} not in {BITS} or axis "
                         f"{axis!r} not in {AXES}")
    if pages.dim() != 3 or pages.dtype != torch.float32 or not pages.is_contiguous():
        raise ValueError(f"quantize_pages: pages must be contiguous (NP, P, C) "
                         f"float32, got {tuple(pages.shape)} {pages.dtype}")
    NP, P, C = pages.shape
    codes = torch.empty((NP, P, C), dtype=torch.uint8, device=dev)
    scale = torch.empty(_plane_shape(NP, P, C, axis), dtype=torch.float32, device=dev)
    zero = torch.empty_like(scale)
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.kv_quantize_pages_launch(
            pages.data_ptr(), codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            NP, P, C, bits, int(axis == "channel"),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.kv_quant_error_string, "quantize_pages", err)
    quantize_pages.launches += 1
    return codes, scale, zero


def dequantize_pages(codes, scale, zero, *, out_dtype=torch.float32):
    """codes (NP, P, C) uint8, f32 planes (NP, 1, C) or (NP, P, 1) ->
    ``codes * scale + zero`` (NP, P, C) in ``out_dtype``."""
    dev = _device("dequantize_pages", codes, scale, zero)
    if dev.type == "cpu":
        return dequantize_pages_ref(codes, scale, zero, out_dtype=out_dtype)
    if codes.dim() != 3 or codes.dtype != torch.uint8:
        raise ValueError(f"dequantize_pages: codes must be (NP, P, C) uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    NP, P, C = codes.shape
    if tuple(scale.shape) == (NP, 1, C):
        axis = "channel"
    elif tuple(scale.shape) == (NP, P, 1):
        axis = "token"
    else:
        raise ValueError(f"dequantize_pages: planes {tuple(scale.shape)} fit "
                         f"neither (NP, 1, C) nor (NP, P, 1) for codes {tuple(codes.shape)}")
    if zero.shape != scale.shape or scale.dtype != torch.float32 or \
            zero.dtype != torch.float32:
        raise ValueError("dequantize_pages: scale and zero must be float32 of one shape")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"dequantize_pages: out_dtype {out_dtype} not in "
                         f"{tuple(_OUT_DTYPES)}")
    for name, t in (("codes", codes), ("scale", scale), ("zero", zero)):
        if not t.is_contiguous():
            raise ValueError(f"dequantize_pages: {name} must be contiguous")
    out = torch.empty((NP, P, C), dtype=out_dtype, device=dev)
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.kv_dequantize_pages_launch(
            _OUT_DTYPES[out_dtype], codes.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), out.data_ptr(), NP, P, C, int(axis == "channel"),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.kv_quant_error_string, "dequantize_pages", err)
    dequantize_pages.launches += 1
    return out


quantize_pages.launches = 0
dequantize_pages.launches = 0
