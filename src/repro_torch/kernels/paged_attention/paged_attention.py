"""Hand-written CUDA paged decode attention for Hopper, and its wrapper.

``csrc/paged_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention``. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use (``kernels/_build.py``: cached in ``build/kernels/``
by source hash) and loaded with ``ctypes``; the launch runs on PyTorch's
current stream.

``paged_attention`` dispatches on the device its tensors live on: CPU
tensors take the plain PyTorch version (``ref.paged_attention_ref``), CUDA
tensors launch the kernel, anything else raises. A CUDA call never falls
back: a failed build or launch raises with the compiler's or the CUDA
runtime's message. ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "paged_attention.cu"
SIGNATURES = {
    "paged_attention_launch": (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "paged_attention_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "paged_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)


def build(build_dir: Optional[Path] = None) -> Tuple[Path, str]:
    """Compile ``csrc/paged_attention.cu`` (see ``kernels/_build.py``).
    Returns (library path, compiler output); raises with nvcc's output."""
    return _build.build(SOURCE, build_dir)


def _load() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def _check(q, k_pages, v_pages, block_tables, lengths) -> None:
    """Everything the kernel assumes, checked before a pointer leaves Python."""
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be (B, KV, "
                         f"G, D), pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} equal (KV, NB, P, D)")
    B, KV, G, D = q.shape
    if k_pages.shape[0] != KV or k_pages.shape[3] != D:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention: tables {tuple(block_tables.shape)} "
                         f"must be (B={B}, NP), lengths {tuple(lengths.shape)} (B,)")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: dtypes q={q.dtype} k={k_pages.dtype} "
                        f"v={v_pages.dtype}; need one of float32/bfloat16/float16")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and lengths must be int32")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: float):
    """q: (B, KV, G, D); k_pages/v_pages: (KV, NB, P, D); block_tables:
    (B, NP) int32; lengths: (B,) int32 -> (B, KV, G, D) in q's dtype."""
    devices = {t.device for t in (q, k_pages, v_pages, block_tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention: tensors on several devices {devices}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _check(q, k_pages, v_pages, block_tables, lengths)
    B, KV, G, D = q.shape
    _, NB, P, _ = k_pages.shape
    NP = block_tables.shape[1]
    lib = _load()
    smem = lib.paged_attention_smem_bytes(G, D, q.element_size())
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"paged_attention: G={G}, D={D}, {q.dtype} needs {smem} "
                         f"bytes of shared memory, more than {_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if B * KV == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, KV, G, D, NB, P, NP, float(scale), stream)
    _build.check_launch(lib.paged_attention_error_string, "paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
