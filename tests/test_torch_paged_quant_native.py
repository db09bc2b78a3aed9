"""The port's split-K paged attention over KIVI pages vs the JAX reference,
on the CPU.

The CUDA kernel (``csrc/paged_attention_quant.cu``) runs bf16 / f16 q whose
pages dequantize into q's own dtype on the tensor cores: each (sequence, KV
head, 16-row tile) walks its page tiles and then its tail tiles, splits that
stream over CTAs and merges their fp32 partials (m, l, acc); chunked extend
runs natively (``rows_per_seq=C``) instead of re-reading the pages per row.
What of that is plain Python or plain PyTorch is held here against the JAX
package on the same numpy inputs (seeded): the route helper
(``kernel_route``), the split plan (``plan_splits``), the split-K twin of
the kernel's algebra (``paged_attention_quant_split_ref``) against JAX's
decode and chunked oracles, with poisoned dead slots, and the wrapper's CPU
paths. Tolerances: f32 ``atol 1e-5`` (summation order only); bf16 and f16
outputs ``atol 2e-2`` (both sides compute in fp32 on the same rounded
inputs and round the output once). The kernel itself runs only on the
card: ``gpu`` tests in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ref as jref
from repro_torch.kernels.kv_quant.ref import quantize_pages_ref
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import paged_attention_quant as tq
from repro_torch.kernels.paged_attention import ref as tref

ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
DTYPES = list(ATOL)
QCASES = [
    # B, KV, G, D, P, NB, NP — tests/test_torch_cuda.py's quantized shape cases
    (1, 1, 8, 64, 16, 8, 4),     # MQA (gemma-style)
    (2, 2, 4, 64, 16, 16, 4),    # GQA
    (3, 4, 1, 32, 8, 16, 8),     # MHA
    (2, 2, 5, 128, 32, 8, 2),    # odd group, big pages
    (2, 2, 2, 256, 4, 16, 3),    # the largest head_dim, the smallest page
]
# page and tail tiles: the kernel's, and small ones so that a few pages
# make many splits (most of them past some row's end)
TILES = [(64, 32), (8, 4)]


def _pages(rng, KV, NB, P, D, bits):
    """KIVI leaves packed by the port's plain pack (equal to JAX's, see
    test_torch_kv_quant.py), planes f16 as the engine stores them."""
    leaves = []
    for axis in ("channel", "token"):
        fp = torch.from_numpy(rng.normal(size=(KV * NB, P, D)).astype(np.float32))
        codes, scale, zero = quantize_pages_ref(fp, bits=bits, axis=axis)
        leaves += [t.reshape((KV, NB) + t.shape[1:]).numpy()
                   for t in (codes, scale.half(), zero.half())]
    return leaves


def _rounded(a, dtype):
    """numpy f32 values that ``dtype`` represents exactly."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _case(seed, B, KV, G, D, P, NB, NP, T, bits, dtype, C=1, tail_start=None,
          lengths=None):
    """q (B * C, KV, G, D), the leaves, tails, per-row tables, tail_start
    and per-row lengths, as numpy; q and tails representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    q = _rounded(rng.normal(size=(B * C, KV, G, D)).astype(np.float32), dtype)
    leaves = _pages(rng, KV, NB, P, D, bits)
    tails = [_rounded(rng.normal(size=(B, T, KV, D)).astype(np.float32), dtype)
             for _ in range(2)]
    tables = np.stack([rng.choice(NB, size=NP, replace=False)
                       for _ in range(B)]).astype(np.int32)
    if tail_start is None:
        tail_start = rng.integers(0, NP * P + 1, size=(B,))
        tail_start[0] = P + P // 2 - 1  # mid-page
    if lengths is None:
        lengths = np.asarray(tail_start) + rng.integers(0, T + 1, size=(B,))
    return [q, *leaves, *tails, tables, np.asarray(lengths, np.int32),
            np.asarray(tail_start, np.int32)]


def _torch(arrays, dtype):
    """The argument tuple on CPU tensors: q and tails in ``dtype``."""
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    for i in (0, 7, 8):
        out[i] = out[i].to(getattr(torch, dtype))
    return out


def _jax(arrays, dtype):
    out = [jnp.asarray(a) for a in arrays]
    for i in (0, 7, 8):
        out[i] = out[i].astype(jnp.dtype(dtype))
    return out


def _poison(arrays, P, C=1):
    """A copy with every slot no row may read poisoned: page slots at or
    past tail_start (codes 255, value planes Inf), the key planes of pages
    wholly past it (+-Inf), tail slots past every row's end (+-Inf)."""
    bad = [a.copy() for a in arrays]
    kc, ks, kz, vc, vs, vz, kt, vt, tables, lengths, ts = bad[1:12]
    for b in range(tables.shape[0]):
        for page in range(tables.shape[1]):
            blk = tables[b, page]
            dead = slice(max(0, int(ts[b]) - page * P), P)
            kc[:, blk, dead] = vc[:, blk, dead] = 255
            vs[:, blk, dead] = np.inf
            if page * P >= ts[b]:
                ks[:, blk], kz[:, blk] = np.inf, -np.inf
        end = max(0, int(lengths[b * C:(b + 1) * C].max()) - int(ts[b]))
        kt[b, end:], vt[b, end:] = np.inf, -np.inf
    return bad


# --------------------------------------------------------------------------
# the route and the split plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("deq", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_route(dtype, deq, D):
    """bf16 / f16 q whose pages dequantize into q's own dtype take the mma
    kernel at every accepted head_dim; fp32, and any other deq_dtype, keep
    the CUDA-core kernel (extend through it folds)."""
    want = "mma" if dtype != "float32" and deq == dtype else "cuda_core"
    assert tq.kernel_route(getattr(torch, dtype), getattr(torch, deq), D) == want
    assert tq.kernel_route(getattr(torch, dtype), getattr(torch, deq), 48) == "cuda_core"


@pytest.mark.parametrize("ctas", [1, 128, 1000])
@pytest.mark.parametrize("page_keys", [0, 64, 1024, 4096])
@pytest.mark.parametrize("tail_keys", [0, 17, 80])
@pytest.mark.parametrize("sm_count,per_sm", [(132, 2), (8, 3)])
def test_plan_splits_bounds(ctas, page_keys, tail_keys, sm_count, per_sm):
    """At least one split; never more splits than page tiles (64 keys) plus
    tail tiles (32 slots); every split starts inside the tile count."""
    tiles = -(-page_keys // tq.PAGE_TILE) + -(-tail_keys // tq.TAIL_TILE)
    s = tq.plan_splits(ctas, page_keys, tail_keys, sm_count, per_sm)
    assert 1 <= s <= max(1, tiles)
    per = -(-max(1, tiles) // s)
    assert (s - 1) * per < max(1, tiles)


def test_plan_splits_at_the_timed_shapes():
    """An H100 has 132 SMs; the mma kernel holds 2 CTAs per SM at D <= 128
    (111 KB of shared memory at D = 128) and 1 at D = 256. A 1024-slot table
    and a 17-slot tail are 16 + 1 tiles: olmo-1b decode (B=8, KV=16: 128
    CTAs) takes 2 splits, qwen2.5-32b's heads (KV=8: 64 CTAs) 4, gemma-2b's
    (KV=1: 8 CTAs, one per SM) 9; the olmo-1b extend layer (B=4, C=64: 256
    CTAs, 80 tail slots) fills the card unsplit."""
    assert tq.plan_splits(128, 1024, 17, 132, 2) == 2
    assert tq.plan_splits(64, 1024, 17, 132, 2) == 4
    assert tq.plan_splits(8, 1024, 17, 132, 1) == 9
    assert tq.plan_splits(256, 1024, 80, 132, 2) == 1
    assert tq.plan_splits(0, 1024, 17, 132, 2) == 1
    assert tq.plan_splits(64, 0, 0, 132, 2) == 1


# --------------------------------------------------------------------------
# the split-K twin against JAX's quantized oracles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", QCASES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_ref_decode_matches_jax(case, bits, dtype, splits):
    """Decode (rows_per_seq 1) with a 17-slot tail and a mid-page tail_start
    in the first row: the split twin at the kernel's tiles and at small ones
    == JAX's paged_attention_quant_ref, with deq_dtype = q's dtype (the mma
    route's condition)."""
    B, KV, G, D, P, NB, NP = case
    arrays = _case(sum(case) + bits + splits, *case, 17, bits, dtype)
    want = np.asarray(jref.paged_attention_quant_ref(
        *_jax(arrays, dtype), scale=D ** -0.5, deq_dtype=jnp.dtype(dtype)), np.float32)
    args = _torch(arrays, dtype)
    for page_tile, tail_tile in TILES:
        got = tref.paged_attention_quant_split_ref(
            *args, scale=D ** -0.5, splits=splits, deq_dtype=getattr(torch, dtype),
            page_tile=page_tile, tail_tile=tail_tile)
        assert got.dtype == getattr(torch, dtype) and got.shape == args[0].shape
        np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL[dtype])


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_ref_extend_matches_jax_chunked(G, dtype, splits):
    """Chunked extend (rows_per_seq = C; row (b, c) has length starts[b] + c
    + 1; tail_start = starts // P * P, mid-page for two rows, 0 for one):
    the split twin == JAX's paged_attention_chunked_quant_ref."""
    B, C, KV, D, P, NB, NP = 3, 6, 2, 32, 8, 16, 4
    starts = np.asarray([0, 13, 29], np.int32)
    ts = starts // P * P
    row_len = (starts[:, None] + np.arange(C)[None, :] + 1).reshape(-1)
    arrays = _case(50 + G + splits, B, KV, G, D, P, NB, NP, P + C, 8, dtype, C=C,
                   tail_start=ts, lengths=row_len)
    jargs = _jax(arrays, dtype)
    jargs[0] = jargs[0].reshape(B, C, KV, G, D)
    jargs[10] = jnp.asarray(starts)
    want = np.asarray(jref.paged_attention_chunked_quant_ref(
        *jargs, scale=0.2, deq_dtype=jnp.dtype(dtype)), np.float32).reshape(B * C, KV, G, D)
    args = _torch(arrays, dtype)
    for page_tile, tail_tile in TILES:
        got = tref.paged_attention_quant_split_ref(
            *args, scale=0.2, splits=splits, deq_dtype=getattr(torch, dtype),
            rows_per_seq=C, page_tile=page_tile, tail_tile=tail_tile)
        np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL[dtype])


@pytest.mark.parametrize("path", ["decode", "extend"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_ref_ignores_poison(path, splits):
    """Rows: tail only (tail_start 0), pages only (lengths == tail_start),
    nothing valid, a tail_start mid-page (13 with P = 8). Every slot the
    rows must not read is poisoned (codes 255, value planes Inf, dead pages'
    key planes +-Inf, tail slots +-Inf): the twin, like the kernel, lets
    none of it reach a sum, equals JAX's oracle on the clean inputs, and
    the row with nothing valid is 0."""
    B, KV, G, D, P, NB, NP, T = 4, 2, 2, 64, 8, 20, 4, 5
    if path == "decode":
        C, ts, lengths = 1, [0, 16, 0, 13], [4, 16, 0, 17]
    else:
        C, starts = 3, np.asarray([2, 16, 9, 13])
        ts = [0, 16, 8, 8]
        lengths = (starts[:, None] + np.arange(C)[None, :] + 1).reshape(-1)
        T = 8
    arrays = _case(7 + splits, B, KV, G, D, P, NB, NP, T, 8, "float32", C=C,
                   tail_start=ts, lengths=lengths)
    arrays[9] = np.arange(B * NP, dtype=np.int32).reshape(B, NP)  # disjoint rows
    kw = dict(scale=0.2, splits=splits, rows_per_seq=C, page_tile=8, tail_tile=4)
    clean = tref.paged_attention_quant_split_ref(*_torch(arrays, "float32"), **kw)
    bad = tref.paged_attention_quant_split_ref(*_torch(_poison(arrays, P, C), "float32"),
                                               **kw)
    assert torch.isfinite(bad).all()
    np.testing.assert_allclose(bad.numpy(), clean.numpy(), atol=1e-6)
    jargs = _jax(arrays, "float32")
    if path == "decode":
        want = jref.paged_attention_quant_ref(*jargs, scale=0.2)
        assert torch.equal(clean[2], torch.zeros_like(clean[2]))
    else:
        jargs[0] = jargs[0].reshape(B, C, KV, G, D)
        jargs[10] = jnp.asarray(starts, jnp.int32)
        want = jref.paged_attention_chunked_quant_ref(*jargs, scale=0.2).reshape(
            B * C, KV, G, D)
    np.testing.assert_allclose(clean.numpy(), np.asarray(want), atol=ATOL["float32"])


# --------------------------------------------------------------------------
# the wrapper's CPU paths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_cpu_paths(dtype):
    """On CPU tensors the wrapper takes the plain version without
    ``splits`` and the split twin with it, decode and extend; the extend
    op's CPU path is the chunked oracle, equal to both."""
    B, C, KV, G, D, P, NB, NP = 2, 4, 2, 3, 32, 8, 8, 3
    starts = np.asarray([3, 17], np.int32)
    ts = starts // P * P
    row_len = (starts[:, None] + np.arange(C)[None, :] + 1).reshape(-1)
    args = _torch(_case(9, B, KV, G, D, P, NB, NP, P + C, 4, dtype, C=C, tail_start=ts,
                        lengths=row_len), dtype)
    deq = getattr(torch, dtype)
    kw = dict(scale=0.3, deq_dtype=deq)
    before = tq.paged_attention_quant.launches
    plain = tref.paged_attention_quant_ref(*args, rows_per_seq=C, **kw)
    assert torch.equal(tq.paged_attention_quant(*args, rows_per_seq=C, **kw), plain)
    for splits in (1, 3):
        got = tq.paged_attention_quant(*args, rows_per_seq=C, splits=splits, **kw)
        assert torch.equal(got, tref.paged_attention_quant_split_ref(
            *args, rows_per_seq=C, splits=splits, **kw))
        np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                                   atol=ATOL[dtype])
    k = dict(zip(("codes", "scale", "zero"), args[1:4]))
    v = dict(zip(("codes", "scale", "zero"), args[4:7]))
    ext = tops.paged_attend_extend_quant(
        args[0].reshape(B, C, KV * G, D), k, v, args[7], args[8], args[9].long(),
        torch.from_numpy(starts), torch.from_numpy(ts), **kw)
    np.testing.assert_allclose(ext.float().numpy(),
                               plain.reshape(B, C, KV * G, D).float().numpy(),
                               atol=ATOL[dtype])
    assert tq.paged_attention_quant.launches == before  # the CPU launches nothing
