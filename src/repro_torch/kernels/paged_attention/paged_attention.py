"""Hand-written CUDA paged attention for Hopper (decode and chunked extend),
and its wrapper.

``csrc/paged_attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention``. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use (``kernels/_build.py``: cached in ``build/kernels/``
by source hash) and loaded with ``ctypes``; the launch runs on PyTorch's
current stream.

``paged_attention`` dispatches on the device its tensors live on: CPU
tensors take the plain PyTorch versions (``ref.py``), CUDA tensors launch the
kernel, anything else raises. A CUDA call never falls back: a failed build
or launch raises with the compiler's or the CUDA runtime's message. Which of
the source's two kernels a CUDA call launches depends on dtype alone
(``kernel_route``); how many CTAs split each row's key axis is planned on the
host from shapes alone (``plan_splits``), never from ``lengths``.
``paged_attention.launches`` counts the calls that launched a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_chunked_ref, paged_attention_ref, paged_attention_split_ref)

SOURCE = Path(__file__).resolve().with_name("csrc") / "paged_attention.cu"
SIGNATURES = {
    "paged_attention_launch": (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "paged_attention_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "paged_attention_ctas_per_sm": ([ctypes.c_int] * 2, ctypes.c_int),
    "paged_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128, 256)
# the source's kernels, by the route code its C entry point takes
ROUTES = {"cuda_core": 0, "mma": 1}
KEY_TILE = 64        # keys per tile of the mma kernel (kTK in the source)
ROWS_PER_CTA = 16    # query rows (c, g) per CTA of the mma kernel (kRows)
MAX_SPLITS = 64
MAX_GRID_Y = 65535


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches: ``"mma"`` (the tensor-core kernel,
    decode and native chunked extend, split-K) for bf16 / f16 at every
    accepted head_dim (32, 64, 128, 256); ``"cuda_core"`` for fp32, where
    TF32 would break the 1e-5 tolerance. The CUDA-core kernel takes decode
    rows only: extend reaches it through the batch-axis fold
    (``ops.paged_attend_extend_folded``)."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim in _HEAD_DIMS:
        return "mma"
    return "cuda_core"


def plan_splits(ctas: int, keys: int, sm_count: int, ctas_per_sm: int = 2) -> int:
    """How many CTAs split each row tile's key axis. ``ctas``: B * KV * row
    tiles; ``keys``: NP * P, the table width (not the lengths, which would
    cost a device-to-host read per layer); ``sm_count`` SMs holding
    ``ctas_per_sm`` CTAs each. A split of ``per`` key tiles runs in about
    ``per + 1`` tile times (one for its start and its partials), and the
    grid in ceil(ctas * splits / slots) such waves: the plan takes the split
    count with the fewest tile times, the smallest on a tie. Every split
    then has at least one key tile of the table: never more splits than key
    tiles, and at least one."""
    return plan_tile_splits(ctas, -(-keys // KEY_TILE), sm_count, ctas_per_sm)


def plan_tile_splits(ctas: int, tiles: int, sm_count: int, ctas_per_sm: int = 2) -> int:
    """``plan_splits`` over a count of key tiles: the rule both paged
    kernels share (the quantized one counts page and tail tiles)."""
    if ctas <= 0 or tiles <= 0:
        return 1
    slots = max(1, sm_count * ctas_per_sm)
    best, best_cost = 1, None
    for want in range(1, min(tiles, MAX_SPLITS) + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        cost = -(-ctas * splits // slots) * (per + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(dtype_code: int, head_dim: int) -> int:
    """The mma kernel's CTAs per SM (the CUDA occupancy query)."""
    n = _load().paged_attention_ctas_per_sm(dtype_code, head_dim)
    if n <= 0:
        raise RuntimeError(f"paged_attention: occupancy query failed ({n})")
    return n


def planned_splits(q, block_tables, k_pages, rows_per_seq=None) -> int:
    """The split count a CUDA call with these tensors plans (mma route)."""
    B, KV, G, D = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    R = (rows_per_seq or 1) * G
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return plan_splits(B * KV * math.ceil(R / ROWS_PER_CTA),
                       block_tables.shape[1] * k_pages.shape[2], _sm_count(index),
                       _ctas_per_sm(_DTYPE_CODES[q.dtype], D))


def build(build_dir: Optional[Path] = None) -> Tuple[Path, str]:
    """Compile ``csrc/paged_attention.cu`` (see ``kernels/_build.py``).
    Returns (library path, compiler output); raises with nvcc's output."""
    return _build.build(SOURCE, build_dir)


def _load() -> ctypes.CDLL:
    return _build.load(SOURCE, SIGNATURES)


def _check(q, k_pages, v_pages, block_tables, lengths, rows_per_seq) -> None:
    """Everything the kernel assumes, checked before a pointer leaves Python."""
    want = "(B, KV, G, D)" if rows_per_seq is None else "(B, C, KV, G, D)"
    if q.dim() != (4 if rows_per_seq is None else 5) or k_pages.dim() != 4 or \
            k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be {want}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)} equal "
                         f"(KV, NB, P, D)")
    if rows_per_seq is not None and q.shape[1] != rows_per_seq:
        raise ValueError(f"paged_attention: rows_per_seq={rows_per_seq} but q "
                         f"{tuple(q.shape)} holds {q.shape[1]} rows per sequence")
    B, KV, G, D = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
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
                    scale: float, rows_per_seq: Optional[int] = None,
                    splits: Optional[int] = None):
    """Decode: q (B, KV, G, D), row (b, g) sees positions < lengths[b].
    Chunked extend (``rows_per_seq=C``): q (B, C, KV, G, D), row (b, c, g)
    sees positions < lengths[b] + c + 1 (the chunk's K/V already in the
    pages). k_pages/v_pages: (KV, NB, P, D); block_tables: (B, NP) int32;
    lengths: (B,) int32. Returns q's shape in q's dtype.

    ``splits``: CTAs per row tile along the key axis; None plans it
    (``plan_splits``). On CPU tensors a given ``splits`` runs the split-K
    twin ``paged_attention_split_ref``, else the plain version."""
    devices = {t.device for t in (q, k_pages, v_pages, block_tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"paged_attention: tensors on several devices {devices}")
    if q.device.type == "cpu":
        if splits is not None:
            return paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths,
                                             scale=scale, splits=splits,
                                             rows_per_seq=rows_per_seq)
        if rows_per_seq is None:
            return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                       scale=scale)
        return paged_attention_chunked_ref(q, k_pages, v_pages, block_tables, lengths,
                                           scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _check(q, k_pages, v_pages, block_tables, lengths, rows_per_seq)
    B, KV, G, D = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    C = 1 if rows_per_seq is None else rows_per_seq
    _, NB, P, _ = k_pages.shape
    NP = block_tables.shape[1]
    route = kernel_route(q.dtype, D)
    lib = _load()
    if route == "cuda_core":
        if rows_per_seq is not None or splits not in (None, 1):
            raise ValueError(f"paged_attention: the {q.dtype} kernel takes decode rows "
                             "only, unsplit; chunked extend goes through the batch-axis "
                             "fold (ops.paged_attend_extend_folded)")
        smem = lib.paged_attention_smem_bytes(G, D, q.element_size())
        if smem > _build.MAX_SMEM_BYTES:
            raise ValueError(f"paged_attention: G={G}, D={D}, {q.dtype} needs {smem} "
                             f"bytes of shared memory, more than {_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    R = C * G
    if route == "cuda_core":
        splits = 1
    elif splits is None:
        splits = planned_splits(q, block_tables, k_pages, rows_per_seq)
    if not 1 <= splits <= MAX_GRID_Y:
        raise ValueError(f"paged_attention: splits={splits} not in [1, {MAX_GRID_Y}]")
    ws = torch.empty(splits * B * KV * R * (D + 2) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], ROUTES[route], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, KV, G, C, int(rows_per_seq is not None),
            D, NB, P, NP, splits, float(scale), stream)
    _build.check_launch(lib.paged_attention_error_string, "paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
