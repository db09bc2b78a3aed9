"""Hand-written CUDA per-page KIVI pack and unpack for Hopper, and wrappers.

``csrc/kv_quant.cu`` replaces the Pallas TPU kernels
``repro/kernels/kv_quant/kv_quant.py::quantize_pages`` and
``::dequantize_pages``; it is built and bound by ``kernels/_build.py``.

Both wrappers dispatch on the device their tensors live on: CPU tensors take
the plain PyTorch versions (``ref.py``), CUDA tensors launch a kernel,
anything else raises; a CUDA call never falls back. Each launch follows a
plan computed here from the shapes and the SM count (``pack_plan``,
``unpack_plan``), so the CPU tests can check it: which kernel (the route),
and its grid. ``quantize_pages.launches`` and ``dequantize_pages.launches``
count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant.ref import dequantize_pages_ref, quantize_pages_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "kv_quant.cu"
SIGNATURES = {
    "kv_quantize_pages_launch": (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_void_p], ctypes.c_int),
    "kv_dequantize_pages_launch": (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_void_p], ctypes.c_int),
    "kv_quant_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

BITS = (2, 4, 8)
AXES = ("channel", "token")
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # pages, unpack out
PLANE_DTYPES = (torch.float32, torch.float16)

# the pack's warp kernel (a warp per page): its instances' C, and the most
# warps a CTA has
WARP_C = (32, 64, 128, 256)
CTA_WARPS = 4
# CTAs of the generic pack (``THREADS`` each) an SM holds at once: up to this
# many pages an SM, a CTA per page beat a warp per page on the H100 (PERF.md)
ONE_WAVE_CTAS = 8
# the generic pack, the scalar unpack and the vector unpack: threads per CTA;
# the vector unpack's CTAs per SM and rows per thread (kUnpackRows)
THREADS = 256
UNPACK_CTAS_PER_SM = 8
UNPACK_ROWS = 4


class PackPlan(NamedTuple):
    """One pack launch. ``route``: "generic" (one CTA of ``THREADS`` per
    page, any C), "bulk" (C in ``WARP_C``: a warp per page, the page brought
    into the warp's shared memory by one bulk copy) or "direct" (the same
    kernel, lanes loading their 16-byte vectors from HBM); ``grid`` CTAs of
    ``warps`` warps."""
    route: str
    warps: int
    grid: int


class UnpackPlan(NamedTuple):
    """One unpack launch: "vector" (C a multiple of 16, P of
    ``UNPACK_ROWS``: a grid-stride loop over units of ``UNPACK_ROWS`` rows
    x the channels of one 16-byte store) or "scalar" (one CTA per page), on
    ``grid`` CTAs of ``THREADS``."""
    route: str
    grid: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def bulk_smem(warps: int, page_bytes: int) -> int:
    """Dynamic shared memory of a "bulk" CTA: a page for each warp, then an
    8-byte mbarrier for each (the kernel's layout)."""
    return warps * (page_bytes + 8)


def pack_plan(NP: int, P: int, C: int, itemsize: int, axis: str,
              sm_count: int) -> PackPlan:
    """The pack's launch, from shapes and the SM count.

    - "generic", a CTA per page: any C outside ``WARP_C``, a page too large
      for shared memory, and any C while the pages fit one wave
      (``ONE_WAVE_CTAS`` a SM: 1056 on the H100, so a decode step's fill of
      256), where 8 warps on each page ran faster than one (PERF.md);
    - past one wave, a warp per page in CTAs of ``CTA_WARPS``: per channel
      (two passes over the page) "bulk", in fewer warps where their pages
      would not fit a CTA's shared memory; per token (one pass) "direct".
    """
    page = P * C * itemsize
    if C not in WARP_C or NP <= ONE_WAVE_CTAS * sm_count or \
            bulk_smem(1, page) > _build.MAX_SMEM_BYTES:
        return PackPlan("generic", THREADS // 32, NP)
    if axis == "token":
        return PackPlan("direct", CTA_WARPS, _ceil_div(NP, CTA_WARPS))
    warps = CTA_WARPS
    while bulk_smem(warps, page) > _build.MAX_SMEM_BYTES:
        warps -= 1
    return PackPlan("bulk", warps, _ceil_div(NP, warps))


def unpack_plan(NP: int, P: int, C: int, out_itemsize: int, sm_count: int) -> UnpackPlan:
    """The unpack's launch: the vector kernel where C is a multiple of 16
    and P of ``UNPACK_ROWS``, on enough CTAs to fill the card
    (``UNPACK_CTAS_PER_SM``) and no more than its units (``UNPACK_ROWS``
    rows x the channels of one 16-byte store) need; the scalar kernel, one
    CTA per page, otherwise."""
    if C % 16 or P % UNPACK_ROWS:
        return UnpackPlan("scalar", NP)
    units = NP * P * C // (UNPACK_ROWS * 16 // out_itemsize)
    return UnpackPlan("vector", max(1, min(_ceil_div(units, THREADS),
                                           sm_count * UNPACK_CTAS_PER_SM)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check_aligned(name, **tensors) -> None:
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte boundary "
                             f"(got address {t.data_ptr():#x})")


def quantize_pages(pages, *, bits: int = 8, axis: str = "channel",
                   plane_dtype=torch.float32):
    """pages (NP, P, C) f32, bf16 or f16 -> (codes uint8 (NP, P, C), scale,
    zero) with planes (NP, 1, C) for ``axis="channel"``, (NP, P, 1) for
    "token", in ``plane_dtype`` (f32, or f16 rounded once from the f32
    planes). The codes are those of the f32 pack of ``pages.float()``."""
    if plane_dtype not in PLANE_DTYPES:
        raise ValueError(f"quantize_pages: plane_dtype {plane_dtype} not in {PLANE_DTYPES}")
    dev = _device("quantize_pages", pages)
    if dev.type == "cpu":
        codes, scale, zero = quantize_pages_ref(pages, bits=bits, axis=axis)
        return codes, scale.to(plane_dtype), zero.to(plane_dtype)
    if bits not in BITS or axis not in AXES:
        raise ValueError(f"quantize_pages: bits {bits} not in {BITS} or axis "
                         f"{axis!r} not in {AXES}")
    if pages.dim() != 3 or pages.dtype not in DTYPES or not pages.is_contiguous():
        raise ValueError(f"quantize_pages: pages must be contiguous (NP, P, C) "
                         f"float32, bfloat16 or float16, got {tuple(pages.shape)} "
                         f"{pages.dtype}")
    NP, P, C = pages.shape
    plan = pack_plan(NP, P, C, pages.element_size(), axis, _sm_count(dev.index or 0))
    if plan.route != "generic":
        _check_aligned("quantize_pages", pages=pages)
    codes = torch.empty((NP, P, C), dtype=torch.uint8, device=dev)
    scale = torch.empty(_plane_shape(NP, P, C, axis), dtype=plane_dtype, device=dev)
    zero = torch.empty_like(scale)
    if NP == 0:
        return codes, scale, zero
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.kv_quantize_pages_launch(
            DTYPES[pages.dtype], int(plane_dtype == torch.float16), pages.data_ptr(),
            codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), NP, P, C, bits,
            int(axis == "channel"), int(plan.route == "generic"), plan.warps,
            int(plan.route == "bulk"), plan.grid, torch.cuda.current_stream().cuda_stream)
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
    if out_dtype not in DTYPES:
        raise ValueError(f"dequantize_pages: out_dtype {out_dtype} not in "
                         f"{tuple(DTYPES)}")
    for name, t in (("codes", codes), ("scale", scale), ("zero", zero)):
        if not t.is_contiguous():
            raise ValueError(f"dequantize_pages: {name} must be contiguous")
    if NP * P * C // 16 >= 2 ** 31:
        raise ValueError(f"dequantize_pages: {NP * P * C} codes, more than the "
                         "kernel's 32-bit indices reach")
    plan = unpack_plan(NP, P, C, torch.finfo(out_dtype).bits // 8,
                       _sm_count(dev.index or 0))
    if plan.route == "vector":
        _check_aligned("dequantize_pages", codes=codes, scale=scale, zero=zero)
    out = torch.empty((NP, P, C), dtype=out_dtype, device=dev)
    if NP == 0:
        return out
    lib = _build.load(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.kv_dequantize_pages_launch(
            DTYPES[out_dtype], codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            out.data_ptr(), NP, P, C, int(axis == "channel"),
            0 if plan.route == "vector" else 1, plan.grid,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.kv_quant_error_string, "dequantize_pages", err)
    dequantize_pages.launches += 1
    return out


quantize_pages.launches = 0
dequantize_pages.launches = 0
