"""Hand-written CUDA batched grouped LoRA matmul for Hopper, and its wrapper.

``csrc/bgmv.cu`` replaces the Pallas TPU kernel
``repro/kernels/lora/lora.py::bgmv``; it is built and bound by
``kernels/_build.py``. One launch serves up to three adapter sites that
share their input (an attention layer's wq, wk and wv) and may add each
site's delta to a base output in place.

``bgmv_add`` dispatches on the device its tensors live on: CPU tensors take
the plain PyTorch version (``ref.bgmv_add_ref``), CUDA tensors launch the
kernel, anything else raises; a CUDA call never falls back.
``bgmv_add.launches`` counts kernel launches, not sites. ``bgmv`` (one
site, no base) is the TPU kernel's direct counterpart, through the same
kernel and the same count.

``plan`` lays out the grid from shapes alone (pure Python, so the CPU tests
cover it): the rank instance, the rows of C per CTA, the thread block
cluster that splits the shrink over Din, and each site's CTAs and columns
per CTA.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora.ref import bgmv_add_ref

SOURCE = Path(__file__).resolve().with_name("csrc") / "bgmv.cu"

# the kernel's constants (csrc/bgmv.cu)
RANKS = (8, 16, 32, 64)  # rank instances; R <= 64 takes the next one up
MAX_RANK = RANKS[-1]
ROW_TILES = (1, 2, 4, 8, 16, 32, 64)  # rows of C per CTA
MAX_VALUES = 512  # rows * rank instance: the h one CTA holds
REG_RANKS = 16  # above this rank instance the expand holds <= 4 rows' sums
MAX_SITES = 3
MAX_CLUSTER = 8
MAX_ROWS = 65535  # batch rows and row tiles: the grid's z and y extents
SPAN = 1024  # columns per CTA the plan starts from: two passes after one shrink
MIN_SHARE = 256  # Din per cluster rank below which the cluster shrinks no further
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class _Site(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("base", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("dout", ctypes.c_int), ("num_slots", ctypes.c_int),
                ("ctas", ctypes.c_int), ("span", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("site", _Site * MAX_SITES), ("nsites", ctypes.c_int),
                ("x", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("B", ctypes.c_int), ("C", ctypes.c_int), ("Din", ctypes.c_int),
                ("R", ctypes.c_int), ("row_tiles", ctypes.c_int),
                ("cluster", ctypes.c_int), ("d_share", ctypes.c_int)]


SIGNATURES = {
    "bgmv_launch": ([ctypes.c_int] * 3 + [ctypes.POINTER(_Args), ctypes.c_void_p],
                    ctypes.c_int),
    "bgmv_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's grid: (sum(ctas), row_tiles, B) CTAs in clusters of
    ``cluster`` along x. Site s owns ``ctas[s]`` consecutive CTAs (a
    multiple of ``cluster``); its CTA j writes columns [j * span[s], (j + 1)
    * span[s]) of rows [t * rows, (t + 1) * rows) of C (clipped to Dout and
    C), and cluster rank j % cluster shrinks Din [rank * d_share, (rank + 1)
    * d_share)."""
    rank: int  # the kernel's rank instance
    rows: int
    row_tiles: int
    cluster: int
    d_share: int
    ctas: Tuple[int, ...]
    spans: Tuple[int, ...]

    def tiles(self, B: int, C: int, douts: Sequence[int]):
        """Every CTA's work, as the kernel derives it from its block index:
        (site, b, c0, c1, n0, n1, d0, d1) per CTA of the grid."""
        for s, (n, span) in enumerate(zip(self.ctas, self.spans)):
            for j in range(n):
                rank = j % self.cluster
                for t in range(self.row_tiles):
                    for b in range(B):
                        yield (s, b, t * self.rows, min(C, (t + 1) * self.rows),
                               j * span, min(douts[s], (j + 1) * span),
                               rank * self.d_share, (rank + 1) * self.d_share)


def instance_ok(rank: int, rows: int) -> bool:
    """Whether the kernel has the (rank instance, rows) instance."""
    return rows * rank <= MAX_VALUES if rank <= REG_RANKS else rows <= 4


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _ceil_div(n: int, m: int) -> int:
    return -(-n // m)


def _round_up(n: int, m: int) -> int:
    return _ceil_div(n, m) * m


@functools.lru_cache(maxsize=None)
def plan(B: int, C: int, Din: int, R: int, douts: Tuple[int, ...], sm_count: int,
         x_itemsize: int) -> Plan:
    """The grid of one launch, from shapes and the SM count.

    - Rank: the smallest instance of ``RANKS`` >= R.
    - Cluster: the shrink splits Din over up to 8 CTAs, each keeping at
      least ``MIN_SHARE`` of it (a Din of 2048 or more takes 8), so a slot's
      A and the rows of x are read once per cluster, not once per CTA.
    - Columns: each site's Dout in spans of up to ``SPAN`` columns, over a
      multiple of the cluster of CTAs (a narrow site's CTAs take fewer).
    - Rows of C per CTA: the most (a power of two up to C, an instance the
      kernel has) that still give every SM a CTA; C = 1 gives one row, so
      decode does no padded work. A CTA reads its columns of B once for
      all its rows.
    - Where that gives more than 8 CTAs per SM, one CTA expands more
      columns after its single shrink (the count halves until it fits or
      each site has one cluster).
    Refuses R outside [1, 64], more than 3 sites, and B or a row-tile
    count above 65535."""
    if not 1 <= R <= MAX_RANK:
        raise ValueError(f"bgmv: rank {R} not in [1, {MAX_RANK}]")
    if not 1 <= len(douts) <= MAX_SITES:
        raise ValueError(f"bgmv: {len(douts)} sites; one launch takes 1 to {MAX_SITES}")
    if B > MAX_ROWS:
        raise ValueError(f"bgmv: {B} batch rows, more than {MAX_ROWS}")
    rank = next(r for r in RANKS if r >= R)
    cluster = 1
    while cluster < MAX_CLUSTER and Din >= 2 * cluster * MIN_SHARE:
        cluster *= 2
    g = 16 // x_itemsize  # x values per 16-byte load
    d_share = _round_up(_ceil_div(Din, cluster), g)
    spans0 = [max(1, _ceil_div(d, SPAN)) for d in douts]
    ctas = [_round_up(n, cluster) for n in spans0]
    fits = [r for r in ROW_TILES if r <= _pow2_at_least(max(C, 1)) and instance_ok(rank, r)]
    rows = next((r for r in reversed(fits)
                 if B * _ceil_div(C, r) * sum(ctas) >= sm_count), fits[0])
    row_tiles = _ceil_div(C, rows)
    if row_tiles > MAX_ROWS:
        raise ValueError(f"bgmv: {row_tiles} row tiles of {rows}, more than {MAX_ROWS}")
    per_cta = 1
    while True:
        ctas = [_round_up(_ceil_div(n, per_cta), cluster) for n in spans0]
        if B * row_tiles * sum(ctas) <= 8 * sm_count or all(n == cluster for n in ctas):
            break
        per_cta *= 2
    spans = [_round_up(_ceil_div(d, n), 4) for d, n in zip(douts, ctas)]
    return Plan(rank, rows, row_tiles, cluster, d_share, tuple(ctas), tuple(spans))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check(x, idx, sites) -> None:
    """Everything the kernel assumes, checked before a pointer leaves Python."""
    if x.dim() != 3:
        raise ValueError(f"bgmv: x {tuple(x.shape)} must be (B, C, Din)")
    B, C, Din = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bgmv: x is {x.dtype}; need one of float32/bfloat16/float16")
    if tuple(idx.shape) != (B,):
        raise ValueError(f"bgmv: idx {tuple(idx.shape)} must be (B={B},)")
    if idx.dtype != torch.int32:
        raise TypeError(f"bgmv: idx must be int32, got {idx.dtype}")
    if not 1 <= len(sites) <= MAX_SITES:
        raise ValueError(f"bgmv: {len(sites)} sites; one launch takes 1 to {MAX_SITES}")
    ranks = {a.shape[-1] for a, _, _ in sites}
    if len(ranks) != 1:
        raise ValueError(f"bgmv: the sites of one launch share one rank, got {ranks}")
    named = [("x", x), ("idx", idx)]
    bases = set()
    for i, (a, b, base) in enumerate(sites):
        if a.dim() != 3 or b.dim() != 3 or a.shape[1] != Din or b.shape[0] != a.shape[0] \
                or b.shape[1] != a.shape[2]:
            raise ValueError(f"bgmv: site {i}: a {tuple(a.shape)} and b {tuple(b.shape)} "
                             f"do not match x {tuple(x.shape)} as (T, Din, R) and "
                             "(T, R, Dout)")
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"bgmv: site {i}: a and b must be float32, got {a.dtype} "
                            f"and {b.dtype}")
        named += [(f"site {i} a", a), (f"site {i} b", b)]
        if base is None:
            continue
        if tuple(base.shape) != (B, C, b.shape[2]):
            raise ValueError(f"bgmv: site {i}: base {tuple(base.shape)} must be "
                             f"(B, C, Dout) = {(B, C, b.shape[2])}")
        if base.dtype != x.dtype:
            raise TypeError(f"bgmv: site {i}: base is {base.dtype}, x is {x.dtype}")
        if base.data_ptr() in bases or base.data_ptr() == x.data_ptr():
            raise ValueError(f"bgmv: site {i}: base shares its storage with x or "
                             "another site's base")
        bases.add(base.data_ptr())
        named.append((f"site {i} base", base))
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"bgmv: {name} must be contiguous")
        if not _aligned(t):
            raise ValueError(f"bgmv: {name} must start 16-byte aligned")
    rank = next(iter(ranks))
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"bgmv: rank {rank} not in [1, {MAX_RANK}]")
    if B > MAX_ROWS:
        raise ValueError(f"bgmv: {B} batch rows, more than {MAX_ROWS}")


def _args(x, idx, sites, outs, p: Plan):
    args = _Args()
    for i, ((a, b, base), out) in enumerate(zip(sites, outs)):
        args.site[i] = _Site(a.data_ptr(), b.data_ptr(),
                             base.data_ptr() if base is not None else None,
                             out.data_ptr(), b.shape[2], a.shape[0], p.ctas[i], p.spans[i])
    B, C, Din = x.shape
    args.nsites = len(sites)
    args.x, args.idx = x.data_ptr(), idx.data_ptr()
    args.B, args.C, args.Din, args.R = B, C, Din, sites[0][0].shape[2]
    args.row_tiles, args.cluster, args.d_share = p.row_tiles, p.cluster, p.d_share
    return args


def bgmv_add(x, idx, sites):
    """x: (B, C, Din); idx: (B,) int32; sites: 1 to 3 ``(a, b, base)`` with
    a (T, Din, R) f32, b (T, R, Dout) f32 and base (B, C, Dout) in x's dtype
    or None; every site of a launch has the same R. Per site, ``delta =
    x @ a[idx] @ b[idx]`` accumulated in f32 and rounded once to x's dtype;
    returns per site ``base``, updated IN PLACE to ``base + delta``
    (PyTorch's own add of the rounded delta), or a new tensor holding the
    delta. Ids must lie in [0, T): on the card a row with any other id
    comes back NaN."""
    sites = list(sites)
    tensors = [x, idx] + [t for site in sites for t in site if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"bgmv: tensors on several devices {devices}")
    if x.device.type == "cpu":
        return bgmv_add_ref(x, idx, sites)
    if x.device.type != "cuda":
        raise ValueError(f"bgmv: no kernel for device {x.device}")
    _check(x, idx, sites)
    B, C, Din = x.shape
    outs = [base if base is not None else
            torch.empty((B, C, b.shape[2]), dtype=x.dtype, device=x.device)
            for _, b, base in sites]
    if B == 0 or C == 0:
        return outs
    p = plan(B, C, Din, sites[0][0].shape[2], tuple(b.shape[2] for _, b, _ in sites),
             _sm_count(x.device.index or 0), x.element_size())
    lib = _build.load(SOURCE, SIGNATURES)
    args = _args(x, idx, sites, outs, p)
    with torch.cuda.device(x.device):
        err = lib.bgmv_launch(_DTYPE_CODES[x.dtype], p.rank, p.rows, ctypes.byref(args),
                              torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib.bgmv_error_string, "bgmv", err)
    bgmv_add.launches += 1
    return outs


bgmv_add.launches = 0


def bgmv(x, a, b, idx):
    """x: (B, C, Din); a: (T, Din, R) f32; b: (T, R, Dout) f32; idx: (B,)
    int32 -> (B, C, Dout) in x's dtype: ``y[b] = x[b] @ a[idx[b]] @
    b[idx[b]]``, accumulated in f32. One site of ``bgmv_add`` with no base:
    the same kernel, counted in ``bgmv_add.launches``. Ids must lie in
    [0, T): on the card a row with any other id comes back as NaN."""
    return bgmv_add(x, idx, [(a, b, None)])[0]
