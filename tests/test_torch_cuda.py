"""The port's CUDA kernels vs their plain PyTorch versions, on the card:
paged attention over fp pages (fp32 on the CUDA cores; bf16 / f16 on the
tensor cores at forced and planned split counts, decode and native chunked
extend), paged attention over KIVI pages, the
per-page pack and unpack, the batched grouped LoRA matmul (``bgmv``: one
site, and up to three sites in one launch with each delta added to its base
in place), and the causal flash prefill (``flash_prefill``) with the
gathered extend's row split.
Every test here is marked ``gpu`` and skips without CUDA.

This file imports neither JAX nor ``repro``, so it runs on a machine with
only PyTorch and the CUDA toolkit. ``tests/conftest.py`` imports JAX, so
there it runs without the conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances: f32 ``atol 1e-5`` (summation order only); bf16 ``atol 2e-2``
(both compute in fp32 and round the output once; for ``bgmv``, whose
outputs reach a few units, one bf16 step: ``rtol 2^-7``; for ``bgmv`` in
f32, ``atol 1e-5`` beyond the plain version's own distance from f64;
``flash_prefill`` bf16 and f16 ``3e-2``, as ``tests/test_kernels_flash.py``
gives bf16). The
pack and
unpack are byte-equal: every step of both is one IEEE-rounded f32 operation.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as kmod
from repro_torch.kernels.paged_attention import ref

CASES = [
    # B, KV, G, D, P, NB, NP — the shape cases of tests/test_kernels_paged.py
    (1, 1, 8, 64, 16, 8, 4),     # MQA (gemma-style)
    (2, 2, 4, 64, 16, 16, 4),    # GQA
    (3, 4, 1, 32, 8, 16, 8),     # MHA
    (2, 2, 5, 128, 32, 8, 2),    # odd group, big pages
    (2, 2, 2, 256, 8, 8, 3),     # the largest head_dim the kernel takes
]
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: see README)")
    return torch.device("cuda")


def _inputs(seed, B, KV, G, D, P, NB, NP, dtype, dev):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
               for s in ((B, KV, G, D), (KV, NB, P, D), (KV, NB, P, D)))
    tables = np.stack([rng.choice(NB, size=NP, replace=False) for _ in range(B)])
    lengths = rng.integers(1, NP * P + 1, size=(B,))
    return (q, k, v, torch.tensor(tables, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_version(cuda, case, dtype):
    q, k, v, tables, lengths = _inputs(9, *case, dtype, cuda)
    scale = case[3] ** -0.5
    before = kmod.paged_attention.launches
    out = kmod.paged_attention(q, k, v, tables, lengths, scale=scale)
    want = ref.paged_attention_ref(q, k, v, tables, lengths, scale=scale)
    torch.cuda.synchronize()
    assert kmod.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_extend_fold_matches_chunked_oracle(cuda, dtype):
    B, C, KV, G, D, P, NB, NP = 3, 8, 2, 4, 64, 16, 32, 4
    q, k, v, tables, _ = _inputs(4, B, KV, G, D, P, NB, NP, dtype, cuda)
    qc = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, C, KV * G, D)).astype(np.float32)).to(cuda, dtype)
    lengths = torch.tensor([0, P - 1, 2 * P], dtype=torch.int32, device=cuda)
    out = ops.paged_attend_extend(qc, k, v, tables, lengths, scale=0.125)
    want = ref.paged_attention_chunked_ref(qc.reshape(B, C, KV, G, D), k, v,
                                           tables, lengths, scale=0.125)
    torch.testing.assert_close(out.float(), want.reshape(B, C, KV * G, D).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.gpu
def test_poisoned_slots_and_empty_rows(cuda):
    """Slots at or past the length hold +-1e6 and +-inf: the kernel never
    reads them into a sum. A row of length 0 returns zeros."""
    q, k, v, _, _ = _inputs(2, 1, 2, 2, 32, 8, 8, 4, torch.float32, cuda)
    tables = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([13], dtype=torch.int32, device=cuda)
    clean = kmod.paged_attention(q, k, v, tables, lengths, scale=0.2)
    k2, v2 = k.clone(), v.clone()
    k2[:, 1, 5:], v2[:, 1, 5:] = 1e6, -1e6
    k2[:, 2:], v2[:, 2:] = float("inf"), float("-inf")
    poisoned = kmod.paged_attention(q, k2, v2, tables, lengths, scale=0.2)
    zero = kmod.paged_attention(q, k, v, tables, torch.zeros_like(lengths), scale=0.2)
    torch.cuda.synchronize()
    torch.testing.assert_close(poisoned, clean, atol=1e-6, rtol=0)
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, tables, lengths = _inputs(3, 1, 1, 2, 32, 8, 4, 2, torch.float32, cuda)
    with pytest.raises(TypeError, match="int32"):
        kmod.paged_attention(q, k, v, tables.long(), lengths, scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        kmod.paged_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                             v[..., :16].contiguous(), tables, lengths, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.cat([q, q], dim=3)[..., ::2]  # q's shape, stride 2
        kmod.paged_attention(strided, k, v, tables, lengths, scale=1.0)


# ---------------------------------------------------------------------------
# the bf16 / f16 tensor-core kernel: split-K, native chunked extend
# ---------------------------------------------------------------------------

MMA_CASES = CASES + [(3, 1, 5, 256, 16, 12, 4), (2, 1, 8, 256, 16, 8, 4)]
HALF = [torch.bfloat16, torch.float16]
SPLITS = [1, 2, 7, None]  # forced, and None = the wrapper's plan


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_CASES)
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("splits", SPLITS)
def test_mma_kernel_matches_plain_version(cuda, case, dtype, splits):
    q, k, v, tables, lengths = _inputs(11, *case, dtype, cuda)
    scale = case[3] ** -0.5
    assert kmod.kernel_route(dtype, case[3]) == "mma"
    before = kmod.paged_attention.launches
    out = kmod.paged_attention(q, k, v, tables, lengths, scale=scale, splits=splits)
    want = ref.paged_attention_ref(q, k, v, tables, lengths, scale=scale)
    torch.cuda.synchronize()
    assert kmod.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL[torch.bfloat16], rtol=0)


EXTEND_CASES = [
    # B, C, KV, G, D, P, NB, NP, chunk starts: ragged chunks with GQA; rows
    # running past the table (start + C > NP * P); more than one 16-row tile
    (3, 8, 2, 4, 64, 16, 32, 4, [0, 15, 32]),
    (2, 5, 2, 5, 128, 8, 16, 4, [29, 3]),
    (2, 24, 1, 8, 256, 16, 8, 3, [40, 0]),
    (2, 70, 2, 1, 32, 32, 8, 3, [10, 50]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", EXTEND_CASES)
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("splits", SPLITS)
def test_native_extend_matches_chunked_oracle(cuda, case, dtype, splits):
    B, C, KV, G, D, P, NB, NP, starts = case
    _, k, v, tables, _ = _inputs(12, B, KV, G, D, P, NB, NP, dtype, cuda)
    q = torch.from_numpy(np.random.default_rng(13).normal(
        size=(B, C, KV, G, D)).astype(np.float32)).to(cuda, dtype)
    lengths = torch.tensor(starts, dtype=torch.int32, device=cuda)
    before = kmod.paged_attention.launches
    out = kmod.paged_attention(q, k, v, tables, lengths, scale=D ** -0.5, rows_per_seq=C,
                               splits=splits)
    want = ref.paged_attention_chunked_ref(q, k, v, tables, lengths, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert kmod.paged_attention.launches == before + 1  # one launch, B * C rows
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("splits", SPLITS)
def test_mma_poisoned_dead_slots_and_zero_rows(cuda, dtype, splits):
    """Dead slots of the last partial page and the pages past it hold +-inf
    and +-1e6: decode rows see 13 positions (and a row of length 0 writes
    0), extend rows at most 13 (chunk starts 10 and 7, C = 3)."""
    q, k, v, _, _ = _inputs(14, 2, 2, 4, 64, 8, 8, 4, dtype, cuda)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32, device=cuda)
    qc = torch.from_numpy(np.random.default_rng(15).normal(
        size=(2, 3, 2, 4, 64)).astype(np.float32)).to(cuda, dtype)
    for qq, lens, rows, dead in ((q, [13, 0], None, [13, 0]), (qc, [10, 7], 3, [13, 10])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
        k2, v2 = k.clone(), v.clone()
        for b in range(2):
            for pos in range(dead[b], 32):
                blk = int(tables[b, pos // 8])
                val = float("inf") if pos % 2 else 1e6
                k2[:, blk, pos % 8], v2[:, blk, pos % 8] = val, -val
        kw = dict(scale=0.2, rows_per_seq=rows, splits=splits)
        clean = kmod.paged_attention(qq, k, v, tables, lengths, **kw)
        poisoned = kmod.paged_attention(qq, k2, v2, tables, lengths, **kw)
        plain = (ref.paged_attention_ref if rows is None else ref.paged_attention_chunked_ref)(
            qq, k, v, tables, lengths, scale=0.2)
        torch.cuda.synchronize()
        assert torch.equal(poisoned, clean)
        torch.testing.assert_close(clean.float(), plain.float(), atol=ATOL[torch.bfloat16],
                                   rtol=0)
        if rows is None:
            assert torch.equal(clean[1], torch.zeros_like(clean[1]))


@pytest.mark.gpu
def test_extend_routes_by_dtype(cuda):
    """bf16 extend is one launch of the native chunked path; fp32 extend
    folds into the batch axis, and its results equal the fold's to the
    digit (the CUDA-core kernel is unchanged)."""
    B, C, KV, G, D, P, NB, NP = 2, 6, 2, 2, 64, 16, 8, 3
    for dtype in (torch.bfloat16, torch.float32):
        _, k, v, tables, _ = _inputs(16, B, KV, G, D, P, NB, NP, dtype, cuda)
        q = torch.from_numpy(np.random.default_rng(17).normal(
            size=(B, C, KV * G, D)).astype(np.float32)).to(cuda, dtype)
        lengths = torch.tensor([5, 20], dtype=torch.int32, device=cuda)
        before = kmod.paged_attention.launches
        out = ops.paged_attend_extend(q, k, v, tables, lengths, scale=0.125)
        assert kmod.paged_attention.launches == before + 1
        if dtype == torch.float32:
            fold = ops.paged_attend_extend_folded(q, k, v, tables, lengths, scale=0.125)
            torch.cuda.synchronize()
            assert torch.equal(out, fold)


@pytest.mark.gpu
def test_wrapper_refuses_bad_chunked_calls(cuda):
    q, k, v, tables, lengths = _inputs(18, 2, 2, 2, 64, 8, 8, 2, torch.bfloat16, cuda)
    q5 = q[:, None].expand(2, 3, 2, 2, 64).contiguous()
    with pytest.raises(ValueError, match="rows_per_seq=4"):
        kmod.paged_attention(q5, k, v, tables, lengths, scale=1.0, rows_per_seq=4)
    with pytest.raises(ValueError, match=r"\(B, C, KV, G, D\)"):
        kmod.paged_attention(q, k, v, tables, lengths, scale=1.0, rows_per_seq=3)
    with pytest.raises(ValueError, match="splits=0"):
        kmod.paged_attention(q, k, v, tables, lengths, scale=1.0, splits=0)
    f32 = [t.float() for t in (q5, k, v)]
    with pytest.raises(ValueError, match="batch-axis fold"):
        kmod.paged_attention(*f32, tables, lengths, scale=1.0, rows_per_seq=3)
    with pytest.raises(ValueError, match="batch-axis fold"):
        kmod.paged_attention(q.float(), k.float(), v.float(), tables, lengths, scale=1.0,
                             splits=2)


# ---------------------------------------------------------------------------
# KIVI: the pack / unpack kernels and paged attention over quantized pages
# ---------------------------------------------------------------------------

from repro_torch.kernels.kv_quant import kv_quant as kvmod  # noqa: E402
from repro_torch.kernels.kv_quant import ref as kvref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_quant as qmod  # noqa: E402

QCASES = CASES[:4] + [(2, 2, 2, 256, 4, 16, 3)]  # (B, KV, G, D, P, NB, NP)


def _pack_pages(seed, NP, P, C, dev):
    """Random f32 pages, page 0 constant (scale 0 -> 1), page 1 seven
    repeated values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NP, P, C)).astype(np.float32) * 3
    x[0] = -0.75
    x[1] = ((np.arange(P)[:, None] + np.arange(C)[None, :]) % 7 + 0.5) / 7
    return torch.from_numpy(x).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", ["channel", "token"])
def test_pack_kernel_byte_equal_to_plain(cuda, bits, axis):
    x = _pack_pages(bits, 37, 16, 128, cuda)
    before = kvmod.quantize_pages.launches
    got = kvmod.quantize_pages(x, bits=bits, axis=axis)
    want = kvref.quantize_pages_ref(x, bits=bits, axis=axis)
    torch.cuda.synchronize()
    assert kvmod.quantize_pages.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # and the CPU plain version computes the same bytes
    for g, w in zip(got, kvref.quantize_pages_ref(x.cpu(), bits=bits, axis=axis)):
        assert torch.equal(g.cpu(), w)


def _edge_pages(bits, axis, P, C, dtype, dev):
    """Four pages: groups spanning [0, qmax] with every other value on an
    exact .5 tie; +-1e38 (+-6e4 in f16) and +-1e-39 (subnormal), where the
    pack's reciprocal estimate gives way to the division; random."""
    rng = np.random.default_rng(bits)
    qmax = 2 ** bits - 1
    t, c = np.meshgrid(np.arange(P), np.arange(C), indexing="ij")
    ties = ((t + c) % qmax + 0.5).astype(np.float32)
    if axis == "channel":
        ties[0], ties[1] = 0, qmax
    else:
        ties[:, 0], ties[:, 1] = 0, qmax
    big = 6e4 if dtype == torch.float16 else 1e38
    x = np.stack([ties, rng.uniform(-big, big, (P, C)), rng.uniform(-1e-39, 1e-39, (P, C)),
                  rng.normal(size=(P, C))]).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def _plain_pack(x, bits, axis, plane_dtype):
    codes, scale, zero = kvref.quantize_pages_ref(x.float(), bits=bits, axis=axis)
    return codes, scale.to(plane_dtype), zero.to(plane_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", ["channel", "token"])
def test_pack_kernel_shapes_byte_equal_to_plain(cuda, dtype, bits, axis):
    """Every P x C x NP of the planned launches (the warp kernel's instances
    at C 32-256 by bulk copy and by direct loads, past one wave of pages,
    with spare warps past the last page; the generic kernel at C 48 and up
    to one wave), f32 and f16 planes in turn; the first pages of each call
    hold .5 ties and extreme ranges."""
    n = 0
    for P in (4, 8, 16, 32):
        for C in (32, 48, 64, 128, 256):
            for NP in (1, 3, 131, 256, 1057, 4097):
                rng = np.random.default_rng(n)
                x = torch.from_numpy(rng.normal(size=(NP, P, C)).astype(np.float32) * 3)
                x = x.to(cuda, dtype)
                x[:4] = _edge_pages(bits, axis, P, C, dtype, cuda)[:NP]
                plane = (torch.float32, torch.float16)[n % 2]
                got = kvmod.quantize_pages(x, bits=bits, axis=axis, plane_dtype=plane)
                want = _plain_pack(x, bits, axis, plane)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), (P, C, NP, plane)
                n += 1


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("axis", ["channel", "token"])
def test_unpack_kernel_shapes_byte_equal_to_plain(cuda, out_dtype, axis):
    """The vector kernel (C a multiple of 16, 48 among them) and the scalar
    one (C 24, 40; P 6) over page counts that leave the grid ragged."""
    for C in (16, 32, 48, 64, 128, 256, 24, 40):
        for P in (4, 6, 16):
            for NP in (1, 3, 131, 1030):
                codes, scale, zero = kvref.quantize_pages_ref(
                    _pack_pages(C + NP, NP + 1, P, C, cuda)[1:], bits=8, axis=axis)
                got = kvmod.dequantize_pages(codes, scale, zero, out_dtype=out_dtype)
                want = kvref.dequantize_pages_ref(codes, scale, zero, out_dtype=out_dtype)
                assert got.dtype == out_dtype and torch.equal(got, want), (C, P, NP)


@pytest.mark.gpu
def test_kv_quant_wrappers_refuse_unaligned_views(cuda):
    """A view whose data does not start on 16 bytes: the warp kernel's bulk
    copies and vector loads (past one wave of pages) and the unpack's vector
    loads would fault; the generic pack (a few pages) reads it element by
    element."""
    NP, P, C = 3, 16, 128
    for n in (NP, kvmod.ONE_WAVE_CTAS * kvmod._sm_count(0) + 1):
        x = _pack_pages(n, n * P * C + 1, 1, 1, cuda).view(-1)[1:].view(n, P, C)
        assert x.is_contiguous() and x.data_ptr() % 16
        for axis in ("channel", "token"):
            if kvmod.pack_plan(n, P, C, 4, axis, kvmod._sm_count(0)).route == "generic":
                got = kvmod.quantize_pages(x, bits=8, axis=axis)
                for g, w in zip(got, kvref.quantize_pages_ref(x, bits=8, axis=axis)):
                    assert torch.equal(g, w)
                continue
            with pytest.raises(ValueError, match="16-byte"):
                kvmod.quantize_pages(x, bits=8, axis=axis)
    codes, scale, zero = kvref.quantize_pages_ref(_pack_pages(2, NP, P, C, cuda), bits=8,
                                                  axis="channel")
    shifted = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
    shifted = shifted.view(NP, P, C).copy_(codes)
    with pytest.raises(ValueError, match="16-byte"):
        kvmod.dequantize_pages(shifted, scale, zero)


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["channel", "token"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_unpack_kernel_byte_equal_to_plain(cuda, axis, out_dtype):
    codes, scale, zero = kvref.quantize_pages_ref(_pack_pages(5, 19, 8, 64, cuda),
                                                  bits=8, axis=axis)
    before = kvmod.dequantize_pages.launches
    got = kvmod.dequantize_pages(codes, scale, zero, out_dtype=out_dtype)
    want = kvref.dequantize_pages_ref(codes, scale, zero, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert kvmod.dequantize_pages.launches == before + 1
    assert got.dtype == out_dtype and torch.equal(got, want)


def _quant_inputs(seed, B, KV, G, D, P, NB, NP, T, bits, dtype, dev,
                  tail_start=None, lengths=None):
    """q, KIVI pages packed by the plain pack (planes f16, as the engine
    stores them), fp tails, per-row tables, tail_start and lengths."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, KV, G, D)).astype(np.float32))
    leaves = {}
    for name, axis in (("k", "channel"), ("v", "token")):
        fp = torch.from_numpy(rng.normal(size=(KV * NB, P, D)).astype(np.float32))
        c, s, z = kvref.quantize_pages_ref(fp, bits=bits, axis=axis)
        shape = lambda t: t.reshape((KV, NB) + t.shape[1:]).to(dev)  # noqa: E731
        leaves[name] = (shape(c), shape(s.half()), shape(z.half()))
    tails = [torch.from_numpy(rng.normal(size=(B, T, KV, D)).astype(np.float32))
             .to(dev, dtype) for _ in range(2)]
    tables = np.stack([rng.choice(NB, size=NP, replace=False) for _ in range(B)])
    if tail_start is None:
        tail_start = rng.integers(0, NP * P + 1, size=(B,))
    if lengths is None:
        lengths = np.asarray(tail_start) + rng.integers(0, T + 1, size=(B,))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return (q.to(dev, dtype), *leaves["k"], *leaves["v"], *tails, i32(tables),
            i32(lengths), i32(tail_start))


@pytest.mark.gpu
@pytest.mark.parametrize("case", QCASES)
@pytest.mark.parametrize("T", [1, 4, 17])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_kernel_matches_plain_version(cuda, case, T, bits, dtype):
    args = _quant_inputs(T + bits, *case, T, bits, dtype, cuda)
    scale = case[3] ** -0.5
    before = qmod.paged_attention_quant.launches
    out = qmod.paged_attention_quant(*args, scale=scale, deq_dtype=dtype)
    want = ref.paged_attention_quant_ref(*args, scale=scale, deq_dtype=dtype)
    torch.cuda.synchronize()
    assert qmod.paged_attention_quant.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.gpu
def test_quant_kernel_edge_rows_and_poisoned_slots(cuda):
    """Rows: tail only (tail_start 0), pages only (lengths == tail_start),
    nothing valid (zeros), a split mid-page. Then every slot the rows must
    not read is poisoned — codes 255, value planes Inf, dead pages' key
    planes Inf, tail slots +-Inf — and nothing changes."""
    B, KV, G, D, P, NB, NP, T = 4, 2, 2, 64, 8, 20, 4, 5
    ts, ln = [0, 16, 0, 13], [4, 16, 0, 17]
    args = list(_quant_inputs(11, B, KV, G, D, P, NB, NP, T, 8, torch.float32, cuda,
                              tail_start=ts, lengths=ln))
    tables = torch.arange(B * NP, dtype=torch.int32, device=cuda).reshape(B, NP)
    args[9] = tables  # disjoint rows: a dead page is dead for every row
    clean = qmod.paged_attention_quant(*args, scale=0.2)
    want = ref.paged_attention_quant_ref(*args, scale=0.2)
    bad = [a.clone() for a in args]
    kc, ks, kz, vc, vs, vz, kt, vt = bad[1:9]
    for b in range(B):
        for page in range(NP):
            blk = int(tables[b, page])
            dead = slice(max(0, ts[b] - page * P), P)
            kc[:, blk, dead] = 255
            vc[:, blk, dead] = 255
            vs[:, blk, dead] = float("inf")
            if page * P >= ts[b]:
                ks[:, blk], kz[:, blk] = float("inf"), float("-inf")
        kt[b, ln[b] - ts[b]:] = float("inf")
        vt[b, ln[b] - ts[b]:] = float("-inf")
    poisoned = qmod.paged_attention_quant(*bad, scale=0.2)
    torch.cuda.synchronize()
    torch.testing.assert_close(clean, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(poisoned, clean, atol=1e-6, rtol=0)
    assert torch.equal(clean[2], torch.zeros_like(clean[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_extend_fold_matches_chunked_oracle(cuda, dtype):
    B, C, KV, G, D, P, NB, NP = 3, 8, 2, 4, 64, 16, 32, 4
    starts = np.asarray([0, P - 1, 2 * P + 3])
    args = _quant_inputs(4, B, KV, G, D, P, NB, NP, P + C, 8, dtype, cuda,
                         tail_start=starts // P * P, lengths=starts)
    qc = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, C, KV * G, D)).astype(np.float32)).to(cuda, dtype)
    k = dict(zip(("codes", "scale", "zero"), args[1:4]))
    v = dict(zip(("codes", "scale", "zero"), args[4:7]))
    before = qmod.paged_attention_quant.launches
    out = ops.paged_attend_extend_quant(qc, k, v, *args[7:10], args[10], args[11],
                                        scale=0.125, deq_dtype=dtype)
    want = ref.paged_attention_chunked_quant_ref(
        qc.reshape(B, C, KV, G, D), *args[1:12], scale=0.125, deq_dtype=dtype)
    torch.cuda.synchronize()
    assert qmod.paged_attention_quant.launches == before + 1  # one launch, B*C rows
    torch.testing.assert_close(out.float(), want.reshape(B, C, KV * G, D).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", QCASES)
@pytest.mark.parametrize("T", [1, 4, 17])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_quant_mma_matches_plain_version(cuda, case, T, bits, dtype, splits):
    """bf16 / f16 q with pages dequantized into q's dtype: the mma kernel at
    the planned and forced split counts vs the plain version."""
    args = _quant_inputs(T + bits + 20, *case, T, bits, dtype, cuda)
    scale = case[3] ** -0.5
    assert qmod.kernel_route(dtype, dtype, case[3]) == "mma"
    before = qmod.paged_attention_quant.launches
    out = qmod.paged_attention_quant(*args, scale=scale, deq_dtype=dtype, splits=splits)
    want = ref.paged_attention_quant_ref(*args, scale=scale, deq_dtype=dtype)
    torch.cuda.synchronize()
    assert qmod.paged_attention_quant.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL[torch.bfloat16], rtol=0)


QEXTEND_CASES = [
    # B, C, KV, G, D, P, NB, NP, chunk starts, tail_start (None: starts // P
    # * P, as the engine keeps it), T (None: P + C): ragged starts with GQA,
    # several 16-row tiles, tails of several 32-slot tiles, P = 4 and 32
    (3, 8, 2, 4, 64, 16, 32, 4, [0, 15, 40], None, None),
    (2, 5, 2, 5, 128, 8, 16, 4, [29, 3], None, None),
    (2, 24, 1, 8, 256, 16, 8, 3, [40, 0], None, None),
    (2, 70, 2, 1, 32, 32, 8, 3, [10, 50], None, None),
    (4, 64, 2, 1, 128, 4, 64, 16, [0, 13, 47, 60], None, None),
    (2, 6, 2, 2, 64, 8, 16, 4, [20, 9], [8, 0], 20),  # whole pages in the tail
]


def _quant_extend_inputs(seed, case, dtype, dev):
    """(q (B*C, KV, G, D), the kernel's argument tuple with per-row lengths
    starts[b] + c + 1, chunk starts)."""
    B, C, KV, G, D, P, NB, NP, starts, ts, T = case
    starts = np.asarray(starts)
    ts = starts // P * P if ts is None else np.asarray(ts)
    T = P + C if T is None else T
    row_len = (starts[:, None] + np.arange(C)[None, :] + 1).reshape(-1)
    args = list(_quant_inputs(seed, B, KV, G, D, P, NB, NP, T, 8, dtype, dev,
                              tail_start=ts, lengths=row_len))
    args[0] = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(B * C, KV, G, D)).astype(np.float32)).to(dev, dtype)
    return args, torch.tensor(starts, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", QEXTEND_CASES)
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_quant_native_extend_matches_chunked_oracle(cuda, case, dtype, splits):
    B, C, KV, G, D = case[:5]
    args, starts = _quant_extend_inputs(30, case, dtype, cuda)
    before = qmod.paged_attention_quant.launches
    out = qmod.paged_attention_quant(*args, scale=D ** -0.5, deq_dtype=dtype,
                                     rows_per_seq=C, splits=splits)
    want = ref.paged_attention_chunked_quant_ref(
        args[0].reshape(B, C, KV, G, D), *args[1:10], starts, args[11],
        scale=D ** -0.5, deq_dtype=dtype)
    torch.cuda.synchronize()
    assert qmod.paged_attention_quant.launches == before + 1  # one launch, B * C rows
    torch.testing.assert_close(out.float(), want.reshape(out.shape).float(),
                               atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_quant_mma_poisoned_dead_slots_and_zero_rows(cuda, dtype, splits):
    """The mma route under test_quant_kernel_edge_rows_and_poisoned_slots's
    poison (codes 255, value planes Inf, dead pages' key planes Inf, tail
    slots +-Inf past every row's end; tail_start 13 mid-page with P = 8),
    decode and extend (C = 3): poisoned == clean to the bit, both within
    tolerance of the plain version, the row with nothing valid exactly 0."""
    B, KV, G, D, P, NB, NP = 4, 2, 2, 64, 8, 20, 4
    tables = torch.arange(B * NP, dtype=torch.int32, device=cuda).reshape(B, NP)
    for C, ts, lens, T in ((1, [0, 16, 0, 13], [4, 16, 0, 17], 5),
                           (3, [0, 16, 8, 8], [2, 16, 9, 13], 8)):
        row_len = (np.asarray(lens)[:, None] + np.arange(C)[None, :]
                   + (C > 1)).reshape(-1)
        args = list(_quant_inputs(40 + C, B, KV, G, D, P, NB, NP, T, 8, dtype, cuda,
                                  tail_start=ts, lengths=row_len))
        args[0] = torch.from_numpy(np.random.default_rng(41).normal(
            size=(B * C, KV, G, D)).astype(np.float32)).to(cuda, dtype)
        args[9] = tables  # disjoint rows: a dead page is dead for every row
        bad = [a.clone() for a in args]
        kc, ks, kz, vc, vs, vz, kt, vt = bad[1:9]
        for b in range(B):
            for page in range(NP):
                blk = int(tables[b, page])
                dead = slice(max(0, ts[b] - page * P), P)
                kc[:, blk, dead] = vc[:, blk, dead] = 255
                vs[:, blk, dead] = float("inf")
                if page * P >= ts[b]:
                    ks[:, blk], kz[:, blk] = float("inf"), float("-inf")
            end = max(0, int(row_len[b * C:(b + 1) * C].max()) - ts[b])
            kt[b, end:], vt[b, end:] = float("inf"), float("-inf")
        kw = dict(scale=0.2, deq_dtype=dtype, rows_per_seq=C, splits=splits)
        clean = qmod.paged_attention_quant(*args, **kw)
        poisoned = qmod.paged_attention_quant(*bad, **kw)
        plain = ref.paged_attention_quant_ref(*args, scale=0.2, deq_dtype=dtype,
                                              rows_per_seq=C)
        torch.cuda.synchronize()
        assert torch.equal(poisoned, clean)
        torch.testing.assert_close(clean.float(), plain.float(), atol=ATOL[torch.bfloat16],
                                   rtol=0)
        if C == 1:
            assert torch.equal(clean[2], torch.zeros_like(clean[2]))


@pytest.mark.gpu
def test_quant_extend_routes_by_dtype(cuda):
    """bf16 KIVI extend is one launch of the mma kernel's native chunked
    path; fp32 extend is one launch of the CUDA-core kernel, still the
    batch-axis fold: its result equals, to the bit, the fold written out
    (every row its own sequence, the tails and tables repeated C times)."""
    B, C, KV, G, D, P, NB, NP = 2, 6, 2, 2, 64, 16, 8, 3
    for dtype in (torch.bfloat16, torch.float32):
        args, starts = _quant_extend_inputs(50, (B, C, KV, G, D, P, NB, NP, [5, 20],
                                                 None, None), dtype, cuda)
        k = dict(zip(("codes", "scale", "zero"), args[1:4]))
        v = dict(zip(("codes", "scale", "zero"), args[4:7]))
        qm = args[0].reshape(B, C, KV * G, D)
        assert qmod.kernel_route(dtype, dtype, D) == (
            "mma" if dtype == torch.bfloat16 else "cuda_core")
        before = qmod.paged_attention_quant.launches
        out = ops.paged_attend_extend_quant(qm, k, v, args[7], args[8], args[9], starts,
                                            args[11], scale=0.125, deq_dtype=dtype)
        assert qmod.paged_attention_quant.launches == before + 1
        if dtype == torch.float32:
            rep = [torch.repeat_interleave(t, C, dim=0).contiguous()
                   for t in (args[7], args[8], args[9], args[11])]
            fold = qmod.paged_attention_quant(*args[:7], *rep[:3], args[10], rep[3],
                                              scale=0.125)
            torch.cuda.synchronize()
            assert torch.equal(out, fold.reshape(out.shape))


@pytest.mark.gpu
def test_quant_wrapper_refuses_splits_on_the_cuda_core_route(cuda):
    args = _quant_inputs(3, 1, 1, 2, 32, 8, 4, 2, 2, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="takes no splits"):
        qmod.paged_attention_quant(*args, scale=1.0, splits=2)
    half = [args[0].bfloat16(), *args[1:7], args[7].bfloat16(), args[8].bfloat16(),
            *args[9:]]
    with pytest.raises(ValueError, match="takes no splits"):  # deq f32 != q's bf16
        qmod.paged_attention_quant(*half, scale=1.0, splits=3)
    with pytest.raises(ValueError, match="splits=0"):
        qmod.paged_attention_quant(*half, scale=1.0, deq_dtype=torch.bfloat16, splits=0)


@pytest.mark.gpu
def test_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = list(_quant_inputs(3, 1, 1, 2, 32, 8, 4, 2, 2, 8, torch.float32, cuda))
    with pytest.raises(TypeError, match="float16"):
        qmod.paged_attention_quant(*args[:2], args[2].float(), *args[3:], scale=1.0)
    with pytest.raises(TypeError, match="int32"):
        qmod.paged_attention_quant(*args[:9], args[9].long(), *args[10:], scale=1.0)
    with pytest.raises(ValueError, match="page size"):  # P = 3
        qmod.paged_attention_quant(args[0], *(a[:, :, :3].contiguous()
                                              for a in args[1:7]), *args[7:], scale=1.0)
    x = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="bits"):
        kvmod.quantize_pages(x, bits=3, axis="channel")
    # the pack reads bf16 pages as they are (the codes of their f32 upcast)
    # and refuses any dtype it has no instance for
    xb = _pack_pages(6, 5, 8, 32, cuda).bfloat16()
    for g, w in zip(kvmod.quantize_pages(xb, bits=8, axis="channel"),
                    kvmod.quantize_pages(xb.float(), bits=8, axis="channel")):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        kvmod.quantize_pages(x.double(), bits=8, axis="channel")


# ---------------------------------------------------------------------------
# multi-tenant LoRA: the batched grouped matmul (bgmv)
# ---------------------------------------------------------------------------

from repro_torch.kernels.lora import bgmv as bgmod  # noqa: E402
from repro_torch.kernels.lora.ref import bgmv_add_ref, bgmv_ref  # noqa: E402

BGMV_CASES = (
    # B, C, Din, R, Dout, T — tests/test_lora.py's case, then ranks 4..64 at
    # C = 1 and C = 64, then olmo-1b's three site shapes at decode and prefill
    [(5, 3, 16, 4, 24, 4)]
    + [(6, C, 256, R, 320, 5) for R in (4, 8, 16, 64) for C in (1, 64)]
    + [(B, C, Din, 8, Dout, 5) for B, C in ((8, 1), (4, 64))
       for Din, Dout in ((2048, 2048), (2048, 16384), (8192, 2048))])
# f32: 1e-5 beyond the plain version's own rounding error, measured against
# f64 on the card (its batched matmul sums the Din products sequentially: at
# C=64 and Din >= 2048 its own error reaches 1e-5 at O(1) outputs); the
# kernel itself within 1e-5 of f64. bf16: both sum in f32 and round once;
# where the sums straddle a rounding boundary they differ by one bf16 step
# (2^-7 relative).
BGMV_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _bgmv_inputs(seed, B, C, Din, R, Dout, T, dtype, dev):
    """O(1) outputs (A and B scaled as make_adapter scales them), slot 0 the
    null adapter, ids with slot 0 and a repeat."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, C, Din)).astype(np.float32)).to(dev, dtype)
    a = (rng.normal(size=(T, Din, R)) / np.sqrt(Din)).astype(np.float32)
    b = (rng.normal(size=(T, R, Dout)) / np.sqrt(R)).astype(np.float32)
    a[0] = 0
    b[0] = 0
    idx = (np.arange(B) * 2 + 1) % T
    idx[0] = 0
    idx[-1] = idx[1]
    return (x, torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.tensor(idx, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BGMV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bgmv_kernel_matches_plain_version(cuda, case, dtype):
    x, a, b, idx = _bgmv_inputs(7, *case, dtype, cuda)
    before = bgmod.bgmv_add.launches
    got = bgmod.bgmv(x, a, b, idx)
    want = bgmv_ref(x, a, b, idx)
    torch.cuda.synchronize()
    assert bgmod.bgmv_add.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        i = idx.long()
        exact = torch.einsum("bcr,bro->bco", torch.einsum(
            "bcd,bdr->bcr", x.double(), a[i].double()), b[i].double())
        slack = (want.double() - exact).abs().float()
        assert (got.double() - exact).abs().max().item() <= BGMV_ATOL[dtype]
    else:
        slack = 2 ** -7 * want.float().abs()
    assert (diff - slack).max().item() <= BGMV_ATOL[dtype], diff.max().item()
    null = idx == 0
    assert torch.equal(got[null].float(), torch.zeros_like(got[null].float()))


@pytest.mark.gpu
def test_bgmv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, a, b, idx = _bgmv_inputs(8, 3, 2, 64, 4, 96, 3, torch.float32, cuda)
    with pytest.raises(TypeError, match="int32"):
        bgmod.bgmv(x, a, b, idx.long())
    with pytest.raises(TypeError, match="float32"):
        bgmod.bgmv(x, a.half(), b, idx)
    with pytest.raises(ValueError, match="rank"):
        wide = torch.zeros(3, 64, 65, device=cuda)
        bgmod.bgmv(x, wide, torch.zeros(3, 65, 96, device=cuda), idx)
    with pytest.raises(ValueError, match="contiguous"):
        bgmod.bgmv(torch.cat([x, x], dim=2)[..., ::2], a, b, idx)
    with pytest.raises(ValueError, match="match"):
        bgmod.bgmv(x, a, b[:, :2].contiguous(), idx)
    # an id outside the table never reads it: its row comes back NaN
    bad = torch.tensor([1, 3, 0], dtype=torch.int32, device=cuda)
    out = bgmod.bgmv(x, a, b, bad)
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and not torch.isnan(out[[0, 2]]).any()


FUSED_CASES = [
    # B, C, Din, R, douts: olmo-1b's q/k/v (MHA), qwen2.5-32b's and
    # gemma-2b's (GQA / MQA widths) at decode and in chunks, a ragged Din
    # and Dout (scalar loads), an odd rank, rank 64
    (8, 1, 2048, 8, (2048, 2048, 2048)), (4, 17, 2048, 8, (2048, 2048, 2048)),
    (8, 1, 5120, 8, (5120, 1024, 1024)), (2, 64, 5120, 8, (5120, 1024, 1024)),
    (8, 3, 2048, 8, (2048, 256, 256)), (3, 5, 1030, 5, (1002, 6, 257)),
    (4, 9, 512, 64, (640, 128)), (5, 3, 16, 4, (24,)),
]


def _fused_inputs(seed, B, C, Din, R, douts, dtype, dev, bases=True, T=5):
    x, a, b, idx = _bgmv_inputs(seed, B, C, Din, R, douts[0], T, dtype, dev)
    rng = np.random.default_rng(seed + 1)
    sites = [(a, b)]
    for dout in douts[1:]:
        a2 = (rng.normal(size=(T, Din, R)) / np.sqrt(Din)).astype(np.float32)
        b2 = (rng.normal(size=(T, R, dout)) / np.sqrt(R)).astype(np.float32)
        a2[0] = 0
        b2[0] = 0
        sites.append((torch.from_numpy(a2).to(dev), torch.from_numpy(b2).to(dev)))
    out = []
    for sa, sb in sites:
        base = torch.from_numpy(rng.normal(size=(B, C, sb.shape[2])).astype(np.float32))
        out.append((sa, sb, base.to(dev, dtype) if bases else None))
    return x, idx, out


def _within_plain(got, want, x, idx, a, b):
    """``got`` vs the plain version as test_bgmv_kernel_matches_plain_version
    holds a delta: f32 within 1e-5 beyond the plain version's distance from
    f64, 16-bit types within one step (2^-7 relative) plus 2e-2."""
    diff = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        i = idx.long()
        exact = torch.einsum("bcr,bro->bco", torch.einsum(
            "bcd,bdr->bcr", x.double(), a[i].double()), b[i].double())
        slack = (bgmv_ref(x, a, b, idx).double() - exact).abs().float()
    else:
        slack = 2 ** -7 * want.float().abs()
    return (diff - slack).max().item() <= BGMV_ATOL.get(x.dtype, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("bases", [True, False], ids=["base", "nobase"])
def test_bgmv_fused_kernel_matches_plain_version(cuda, case, dtype, bases):
    x, idx, sites = _fused_inputs(11, *case, dtype, cuda, bases=bases)
    want = bgmv_add_ref(x, idx, [(a, b, None if base is None else base.clone())
                                 for a, b, base in sites])
    before = bgmod.bgmv_add.launches
    got = bgmod.bgmv_add(x, idx, sites)
    torch.cuda.synchronize()
    assert bgmod.bgmv_add.launches == before + 1  # one launch for all sites
    null = idx == 0
    for g, w, (a, b, base) in zip(got, want, sites):
        assert g.dtype == dtype and g.shape == w.shape
        assert _within_plain(g, w, x, idx, a, b)
        if bases:
            assert g is base  # written in place
        else:
            assert not g[null].any()  # slot 0: an exact zero


@pytest.mark.gpu
@pytest.mark.parametrize("case", FUSED_CASES[:4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_bgmv_fused_epilogue_bit_equal_to_pytorch_add(cuda, case, dtype):
    """The epilogue is PyTorch's own ``base + delta``: bit-equal where the
    deltas are the same launch's without bases (the same plan, so the same
    sums), null-slot rows bit-equal to ``base + 0``."""
    x, idx, sites = _fused_inputs(12, *case, dtype, cuda)
    bases = [base.clone() for _, _, base in sites]
    deltas = bgmod.bgmv_add(x, idx, [(a, b, None) for a, b, _ in sites])
    got = bgmod.bgmv_add(x, idx, sites)
    torch.cuda.synchronize()
    null = idx == 0
    for g, base, d in zip(got, bases, deltas):
        assert torch.equal(g, base + d)
        assert torch.equal(g[null], base[null] + 0)


@pytest.mark.gpu
def test_bgmv_fused_bad_id_rows_nan(cuda):
    x, idx, sites = _fused_inputs(13, 3, 2, 64, 4, (96, 32), torch.float32, cuda, T=3)
    bad = torch.tensor([1, 3, 0], dtype=torch.int32, device=cuda)
    got = bgmod.bgmv_add(x, bad, sites)
    torch.cuda.synchronize()
    for g in got:
        assert torch.isnan(g[1]).all() and not torch.isnan(g[[0, 2]]).any()


@pytest.mark.gpu
def test_bgmv_fused_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, idx, sites = _fused_inputs(14, 3, 2, 64, 4, (96, 32), torch.bfloat16, cuda)
    (a, b, base), (a2, b2, base2) = sites
    with pytest.raises(TypeError, match="base is"):
        bgmod.bgmv_add(x, idx, [(a, b, base.float())])
    with pytest.raises(TypeError, match="float32"):
        bgmod.bgmv_add(x, idx, [(a.half(), b, base)])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(3, 2, 192, dtype=x.dtype, device=cuda)
        bgmod.bgmv_add(x, idx, [(a, b, wide[..., ::2])])
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(3 * 2 * 96 + 1, dtype=x.dtype, device=cuda)
        bgmod.bgmv_add(x, idx, [(a, b, flat[1:].view(3, 2, 96))])
    with pytest.raises(ValueError, match="sites"):
        bgmod.bgmv_add(x, idx, [(a, b, None)] * 4)
    with pytest.raises(ValueError, match="rank"):
        wide_a = torch.zeros(5, 64, 65, device=cuda)
        bgmod.bgmv_add(x, idx, [(wide_a, torch.zeros(5, 65, 96, device=cuda), None)])
    with pytest.raises(ValueError, match="rank"):  # one rank per launch
        bgmod.bgmv_add(x, idx, [(a, b, None), (a2[..., :2].contiguous(),
                                               b2[:, :2].contiguous(), None)])
    with pytest.raises(ValueError, match="storage"):
        bgmod.bgmv_add(x, idx, [(a, b, base), (a, b, base)])


@pytest.mark.gpu
def test_olmo_smoke_lora_decode_launches_four_kernels_a_layer(cuda):
    from repro_torch.core.block_manager import BlockManager
    from repro_torch.core.lora import LoRAConfig, PagedAdapterStore, make_adapter

    cfg = configs.smoke_config("olmo-1b")
    m = build_model(cfg, device="cuda")
    params = m.init(0)
    P, NP, B = 8, 4, 3
    pages = m.init_pages(B * NP + 1, P)
    lc = LoRAConfig(rank=8, alpha=16.0, max_loaded_adapters=2)
    store = PagedAdapterStore(cfg, lc, BlockManager(64, 8), 1 << 20, device="cuda")
    store.registry.register("a0", make_adapter(cfg, lc, seed=1))
    store.ensure(["a0"])
    lora = {"ids": torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda),
            "layers": store.tables}
    tables = torch.arange(1, B * NP + 1, device=cuda).reshape(B, NP)
    tok = torch.tensor([[3], [4], [5]], device=cuda)
    lengths = torch.tensor([0, 9, 20], dtype=torch.int32, device=cuda)
    before = bgmod.bgmv_add.launches
    logits, _, _ = m.decode_paged(params, tok, pages, tables, lengths, lora=lora)
    torch.cuda.synchronize()
    assert bgmod.bgmv_add.launches - before == 4 * cfg.num_layers
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# causal flash prefill and the gathered extend's row split
# ---------------------------------------------------------------------------

from unittest import mock  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fmod  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_prefill_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

FLASH_CASES = [
    # B, H, KV, S, D, window — tests/test_kernels_flash.py's cases, then
    # starcoder2-3b's heads: the window never binds (S 512, 2048), binds
    # (S 8192), and an S that is no multiple of the 64-row tile
    (2, 4, 2, 128, 64, 0), (1, 8, 1, 256, 32, 0), (2, 6, 6, 64, 64, 0),
    (1, 4, 2, 256, 64, 64), (1, 2, 2, 128, 128, 0),
    (1, 24, 2, 512, 128, 4096), (1, 24, 2, 2048, 128, 4096),
    (1, 24, 2, 8192, 128, 4096), (2, 24, 2, 300, 128, 4096),
    # the wgmma kernel's edges (128-row and 128-key tiles): ragged S from
    # one row to past a tile, groups of 1, 8 and 12, D 64 and 128, windows
    # that bind and that do not
    (1, 2, 2, 1, 64, 0), (1, 2, 2, 63, 128, 0), (1, 8, 1, 127, 64, 0),
    (1, 12, 1, 129, 128, 0), (2, 2, 2, 500, 64, 100), (1, 12, 1, 2053, 128, 4096),
    (1, 16, 2, 2053, 64, 1000),
    # jamba-v0.1-52b's attention layer: H 32 over KV 8 (G 4), D 128, no
    # RoPE and no window: two fresh rows of a 256-token chunk (the serve's
    # full chunk at prefill_chunk 256, and the model step's), one ragged
    # row of a prompt that goes whole, a chunk of 512
    (2, 32, 8, 256, 128, 0), (1, 32, 8, 200, 128, 0), (2, 32, 8, 512, 128, 0),
]
# f32 (the CUDA-core kernel): summation order only; bf16 / f16 (the wgmma
# kernel: bf16 P split into head and remainder, f16 P rounded once):
# tests/test_kernels_flash.py's bf16 tolerance
FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}


def _flash_inputs(seed, B, H, KV, S, D, dtype, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", sorted(FLASH_ATOL, key=str))
def test_flash_prefill_kernel_matches_plain_version(cuda, case, dtype):
    B, H, KV, S, D, window = case
    q, k, v = _flash_inputs(3, B, H, KV, S, D, dtype, cuda)
    before = fmod.flash_prefill.launches
    got = fmod.flash_prefill(q, k, v, scale=D ** -0.5, window=window)
    want = flash_prefill_ref(q, k, v, scale=D ** -0.5, window=window)
    torch.cuda.synchronize()
    assert fmod.flash_prefill.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= FLASH_ATOL[dtype]


@pytest.mark.gpu
def test_flash_prefill_causality_and_strided_inputs(cuda):
    B, H, S, D = 1, 2, 64, 32
    q, k, v = _flash_inputs(4, B, H, H, S, D, torch.float32, cuda)
    out1 = fmod.flash_prefill(q, k, v, scale=0.2)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] += 100.0
    v2[:, :, 40:] -= 50.0
    out2 = fmod.flash_prefill(q, k2, v2, scale=0.2)
    torch.cuda.synchronize()
    assert (out1[:, :, :40] - out2[:, :, :40]).abs().max().item() <= 1e-5
    # (B, S, heads, D) activations and a (B, W, KV, D) window read in place
    x = torch.randn(2, 200, 24, 128, device=cuda, dtype=torch.bfloat16)
    win = torch.randn(2, 512, 2, 128, device=cuda, dtype=torch.bfloat16)
    kk, vv = win[:, :200].transpose(1, 2), (win[:, 100:300] * 2).transpose(1, 2)
    got = fmod.flash_prefill(x.transpose(1, 2), kk, vv, scale=0.1, window=50)
    want = flash_prefill_ref(x.transpose(1, 2).contiguous(), kk.contiguous(),
                             vv.contiguous(), scale=0.1, window=50)
    assert got.transpose(1, 2).is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= FLASH_ATOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_flash_prefill_wgmma_reads_model_layouts_in_place(cuda, dtype, D):
    """(B, S, H, D) activations and (B, W, KV, D) windows, through the
    wgmma kernel's tensor maps: strides, offset bases, S below W."""
    assert fmod.kernel_route(dtype, D) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(2, 261, 24, D, device=cuda, dtype=dtype, generator=g)
    win = torch.randn(2, 700, 2, D, device=cuda, dtype=dtype, generator=g)
    kk, vv = win[:, 8:269].transpose(1, 2), win[:, 400:661].transpose(1, 2)
    got = fmod.flash_prefill(x.transpose(1, 2), kk, vv, scale=D ** -0.5, window=70)
    want = flash_prefill_ref(x.transpose(1, 2).contiguous(), kk.contiguous(),
                             vv.contiguous(), scale=D ** -0.5, window=70)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= FLASH_ATOL[dtype]


@pytest.mark.gpu
def test_flash_prefill_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(5, 1, 4, 2, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtypes"):
        fmod.flash_prefill(q, k.half(), v, scale=0.1)
    with pytest.raises(TypeError, match="dtypes"):
        fmod.flash_prefill(q.double(), k.double(), v.double(), scale=0.1)
    with pytest.raises(ValueError, match="H % KV"):
        fmod.flash_prefill(q[:, :3], k, v, scale=0.1)
    with pytest.raises(ValueError, match="match"):
        fmod.flash_prefill(q, k[:, :, :32], v[:, :, :32], scale=0.1)
    with pytest.raises(ValueError, match="head_dim"):
        fmod.flash_prefill(q[..., :48], k[..., :48], v[..., :48], scale=0.1)
    with pytest.raises(ValueError, match="contiguous along D"):
        fmod.flash_prefill(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3),
                           scale=0.1)
    with pytest.raises(ValueError, match="16-byte"):
        wide = torch.zeros(1, 4, 64, 65, device=cuda)
        fmod.flash_prefill(wide[..., 1:], k, v, scale=0.1)
    with pytest.raises(ValueError, match="window"):
        fmod.flash_prefill(q, k, v, scale=0.1, window=-1)
    with pytest.raises(ValueError, match="several devices"):
        fmod.flash_prefill(q, k.cpu(), v, scale=0.1)


@pytest.mark.gpu
def test_gathered_extend_row_split_on_card(cuda):
    """starcoder2-3b at smoke width (f32) on the card: fresh rows run the
    kernel once per layer, continuation rows the plain attention; logits
    equal those with the plain version in place of the kernel."""
    model = build_model(configs.smoke_config("starcoder2-3b"), device="cuda")
    params = model.init(0)
    cfg = model.cfg
    B, C, W = 4, 24, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=g, device="cuda")
    win = model.init_cache(B, W)
    for layer in win:
        for x in layer.values():
            x.normal_(generator=g)
    cache_len = torch.tensor([0, 9, 0, 30], dtype=torch.int32, device="cuda")
    kernel = fmod.flash_prefill  # its count, also while the plain version stands in

    def run():
        cache = [{n: x.clone() for n, x in layer.items()} for layer in win]
        before = (kernel.launches, dict(model.route_rows))
        logits = model.extend(params, tokens, cache, cache_len)[0]
        torch.cuda.synchronize()
        return logits, kernel.launches - before[0], {
            k: model.route_rows[k] - before[1][k] for k in before[1]}

    logits, launches, rows = run()
    assert launches == cfg.num_layers
    assert rows == {"flash_prefill": 2, "flash_attention": 2}
    with mock.patch.object(fmod, "flash_prefill", flash_prefill_ref):
        plain, _, _ = run()
    assert torch.isfinite(logits).all()
    assert (logits - plain).abs().max().item() <= 1e-4
    # a batch of continuation rows never launches it
    cache_len = torch.tensor([3, 9, 1, 30], dtype=torch.int32, device="cuda")
    _, launches, rows = run()
    assert launches == 0 and rows["flash_prefill"] == 0


# ---------------------------------------------------------------------------
# llama4: the MoE feed-forward and chunked attention's fresh rows on the card
# ---------------------------------------------------------------------------
import dataclasses  # noqa: E402

from repro_torch.models import moe  # noqa: E402

# f32: both compute through the same f32 matmuls in other groupings (no
# TF32), so summation order only; bf16: each expert row rounds to bf16 after
# its w1 and its w2 matmul on either side, so a row may sit one bf16 step
# (2^-8 relative at |y| ~ 1) apart, and the sum adds the shared expert's
MOE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("T,top_k", [(8, 1), (512, 1), (300, 2), (9000, 1)])
def test_moe_apply_matches_dense_ref_on_card(cuda, dtype, T, top_k):
    """The grouped ``moe_apply`` (one matmul per expert over its kept tokens)
    against the literal dense dispatch at a reduced width (d 512, 8 experts
    of d_ff 256, a shared expert), the no-drop regime and, at T = 9000, the
    drop regime at capacity factor 2.0."""
    cfg = dataclasses.replace(configs.get_config("llama4-scout-17b-a16e"), d_model=512,
                              num_experts=8, moe_d_ff=256, top_k=top_k)
    gen = torch.Generator(device="cuda").manual_seed(T)
    p = moe.make_moe_params(gen, cfg, dtype, cuda)
    x = torch.randn((1, T, cfg.d_model), generator=gen, device="cuda").to(dtype)
    y, aux = moe.moe_apply(p, cfg, x, capacity_factor=2.0)
    want, want_aux = moe.moe_dense_ref(p, cfg, x, capacity_factor=2.0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape and torch.isfinite(y).all()
    torch.testing.assert_close(y.float(), want.float(), atol=MOE_ATOL[dtype], rtol=0)
    torch.testing.assert_close(aux, want_aux, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_chunked_fresh_rows_take_flash_prefill_only_inside_first_chunk(cuda):
    """llama4 at smoke width (chunk 16, f32) on the card: a fresh batch of
    C = 16 runs the kernel in both layers; at C = 24 only in the global
    layer, the chunked one taking the plain attention with the chunk mask.
    Logits equal those with the plain version in place of the kernel."""
    model = build_model(configs.smoke_config("llama4-scout-17b-a16e"), device="cuda")
    params = model.init(0)
    cfg = model.cfg
    kernel = fmod.flash_prefill
    for C, launches_want in ((16, 2), (24, 1)):
        g = torch.Generator(device="cuda").manual_seed(C)
        tokens = torch.randint(0, cfg.vocab_size, (2, C), generator=g, device="cuda")
        cache_len = torch.zeros(2, dtype=torch.int32, device="cuda")

        def run():
            cache = model.init_cache(2, 48)
            before = kernel.launches
            logits = model.extend(params, tokens, cache, cache_len)[0]
            torch.cuda.synchronize()
            return logits, kernel.launches - before

        logits, launches = run()
        assert launches == launches_want, (C, launches)
        with mock.patch.object(fmod, "flash_prefill", flash_prefill_ref):
            plain, _ = run()
        assert torch.isfinite(logits).all()
        assert (logits - plain).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# KV migration: imported blocks reach the destination's device mirror
# ---------------------------------------------------------------------------
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,  # noqa: E402
                              SamplingParams)


def _mirror_block(runner, block):
    """One block of the paged runner's device mirror, in ``block_payload``'s
    order: each leaf's fp page, or its (codes, scale, zero)."""
    out = []
    for layer, name, idx in runner.store.attn_kv_leaves():
        dev = runner._pages[layer][name]
        if idx in runner.store.qplanes:
            out.append(tuple(dev[k][:, block].cpu() for k in ("codes", "scale", "zero")))
        else:
            out.append(dev[:, block].cpu())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [None, 8])
def test_migrated_blocks_reach_device_mirror(cuda, bits):
    """olmo-1b at smoke width on the card: a sequence prefilled on one engine
    is exported and imported into another; after the destination's next
    mirror sync, each of its blocks in the device mirror is byte-equal to
    the payload (fp pages; KIVI codes and planes), and it decodes on."""
    model = build_model(configs.smoke_config("olmo-1b"), device="cuda")
    params = model.init(0)

    def engine():
        return LLMEngine(model, params, EngineConfig(
            block_size=8, num_blocks=64, max_model_len=128, device="cuda",
            kv_quant=QuantConfig(bits=bits) if bits else None))
    src, dst = engine(), engine()
    dst.add_request(Request(request_id="warm", prompt=list(range(2, 12)),
                            sampling=SamplingParams(max_new_tokens=2)))
    dst.run()  # the mirror exists before the import
    seq = src.add_request(Request(request_id="m", prompt=list(range(3, 40)),
                                  sampling=SamplingParams(max_new_tokens=6)))
    while not seq.generated:
        src.step()
    payload = src.export_seq("m")
    moved = dst.import_seq(payload)
    dst.paged_runner.sync()
    for b, page in zip(moved.block_table, payload["blocks"]):
        for got, want in zip(_mirror_block(dst.paged_runner, b), page):
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want[:3] if isinstance(want, tuple) else (want,)):
                assert g.dtype == w.dtype and torch.equal(g, w)
    dst.run()
    assert len(moved.generated) == 6


# ---------------------------------------------------------------------------
# quantized stores on the gathered backend, and MLA (deepseek-v3), on the card
# ---------------------------------------------------------------------------
from repro_torch.core.executor.gathered import dequantize_window  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _smoke_serve(arch, params, device, bits=None, steps=None):
    """The smoke config of ``arch`` in f32 on ``device`` with the given CPU
    weights, 4 greedy requests; ``steps``: stop after that many steps.
    Returns the engine."""
    model = build_model(configs.smoke_config(arch), device=device)
    eng = LLMEngine(model, _tree_to(params, device), EngineConfig(
        block_size=8, num_blocks=128, max_model_len=128, device=device,
        kv_quant=QuantConfig(bits=bits) if bits else None))
    rng = np.random.default_rng(4)
    for i in range(4):
        eng.add_request(Request(
            request_id=f"r{i}", prompt=[int(t) for t in rng.integers(
                2, model.cfg.vocab_size, int(rng.integers(12, 40)))],
            sampling=SamplingParams(max_new_tokens=12)))
    if steps is None:
        eng.run()
    else:
        for _ in range(steps):
            eng.step()
    return eng


@pytest.mark.gpu
def test_gathered_kivi_window_kernel_bit_equal_to_plain(cuda):
    """starcoder2-3b smoke with KIVI 8-bit pages, mid-serve (packed blocks
    and blocks still filling): the window dequantized on the card by the
    unpack kernel (one launch per leaf name) is bit-equal to the plain
    version's and to the store's host dequantization."""
    params = build_model(configs.smoke_config("starcoder2-3b"), device="cpu").init(0)
    eng = _smoke_serve("starcoder2-3b", params, "cuda", bits=8, steps=6)
    store = eng.store
    seqs = list(eng.seqs.values())
    tables = np.zeros((len(seqs), 16), np.int64)
    for b, s in enumerate(seqs):
        tables[b, :len(s.block_table)] = s.block_table
    packed = store.block_quantized[np.unique(tables)]
    assert packed.any() and not packed.all()
    parts = store.gather_quantized(tables)
    before = kvmod.dequantize_pages.launches
    dev = dequantize_window(parts, "cuda", store.dtype)
    torch.cuda.synchronize()
    assert kvmod.dequantize_pages.launches == before + 2
    plain = dequantize_window(parts, "cpu", store.dtype)
    host = store.gather(tables)
    for d, p, h in zip(dev, plain, host):
        for n in ("k", "v"):
            assert d[n].is_cuda and torch.equal(d[n].cpu(), p[n])
            assert torch.equal(p[n], h[n])


@pytest.mark.gpu
def test_mla_decode_matches_extend_on_card(cuda):
    """One deepseek-v3 MLA layer at smoke width in f32 on the card: the
    absorbed decode and the expanded extend at C = 1 (atol 1e-4: f32 sums
    in other orders, no TF32)."""
    cfg = configs.smoke_config("deepseek-v3-671b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = mla_mod.make_mla_params(gen, cfg, torch.float32, "cuda")
    spec = cfg.layer_specs()[0]
    W = 64
    cache = {"c_kv": torch.randn(4, W, cfg.kv_lora_rank, device="cuda", generator=gen),
             "k_pe": torch.randn(4, W, cfg.qk_rope_head_dim, device="cuda", generator=gen)}
    x = torch.randn(4, 1, cfg.d_model, device="cuda", generator=gen)
    cl = torch.tensor([0, 9, 40, 63], device="cuda")
    a = {k: v.clone() for k, v in cache.items()}
    b = {k: v.clone() for k, v in cache.items()}
    od, a = mla_mod.mla_decode(p, cfg, spec, x, a, cl)
    oe, b = mla_mod.mla_extend(p, cfg, spec, x, b, cl)
    torch.testing.assert_close(od, oe, atol=1e-4, rtol=0)
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,bits", [("deepseek-v3-671b", None), ("starcoder2-3b", 8),
                                       ("jamba-v0.1-52b", None), ("jamba-v0.1-52b", 8),
                                       ("xlstm-1.3b", None)])
def test_smoke_streams_on_card_equal_cpu(cuda, arch, bits):
    """The same f32 smoke weights served on the CPU and on the card give the
    same greedy streams: deepseek's latents, starcoder2-3b's and jamba's
    KIVI pages packed by the pack kernel and dequantized by the unpack
    kernel, jamba's and xlstm's state slots."""
    params = build_model(configs.smoke_config(arch), device="cpu").init(0)
    cpu = _smoke_serve(arch, params, "cpu", bits=bits)
    launches = (kvmod.quantize_pages.launches, kvmod.dequantize_pages.launches)
    gpu = _smoke_serve(arch, params, "cuda", bits=bits)
    got = {rid: s.generated for rid, s in gpu.seqs.items()}
    assert got == {rid: s.generated for rid, s in cpu.seqs.items()}
    if bits:  # twice a dispatch (a state stack dispatches once per chunk length)
        assert kvmod.dequantize_pages.launches - launches[1] == 2 * gpu.runner.steps
        assert kvmod.quantize_pages.launches > launches[0]


# ---------------------------------------------------------------------------
# state mixers (Mamba, mLSTM): plain PyTorch on the card, as in the reference
# ---------------------------------------------------------------------------

from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402


@pytest.mark.gpu
def test_state_mixers_chunked_equal_full_on_card(cuda):
    """Mamba (chunks 37 + 91 + 1: the scan from a carried state, then the
    single-step branch) and mLSTM (128 chunkwise + 1 + 39 by the
    recurrence) at smoke width in f32 on the card: the chunks equal the
    whole sequence (atol 1e-4: f32 sums in other orders, no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = configs.smoke_config("jamba-v0.1-52b")
    p = mamba_mod.make_mamba_params(gen, cfg, torch.float32, "cuda")
    x = 0.5 * torch.randn(2, 129, cfg.d_model, device="cuda", generator=gen)
    full, (fc, fs) = mamba_mod.mamba_forward(p, cfg, x)
    st = mamba_mod.init_mamba_cache(cfg, 2, torch.float32, "cuda")
    conv, ssm, outs = st["conv"], st["ssm"], []
    for lo, hi in ((0, 37), (37, 128), (128, 129)):
        y, (conv, ssm) = mamba_mod.mamba_forward(p, cfg, x[:, lo:hi], conv_state=conv,
                                                 ssm_state=ssm)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=1e-4, rtol=0)
    torch.testing.assert_close(ssm, fs, atol=1e-4, rtol=0)
    torch.testing.assert_close(conv, fc, atol=1e-4, rtol=0)
    cfg = configs.smoke_config("xlstm-1.3b")
    p = xlstm_mod.make_mlstm_params(gen, cfg, torch.float32, "cuda")
    x = 0.5 * torch.randn(2, 168, cfg.d_model, device="cuda", generator=gen)
    full, _ = xlstm_mod.mlstm_forward(p, cfg, x)
    st, outs = None, []
    for lo, hi in ((0, 128), (128, 129), (129, 168)):
        y, st = xlstm_mod.mlstm_forward(p, cfg, x[:, lo:hi], state=st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_recycled_state_slot_on_card_equals_fresh_engine(cuda):
    """jamba at smoke width in f32 on the card, 4 state slots: a request
    served after another has finished (its slot recycled) equals the same
    request in a fresh engine."""
    cfg = configs.smoke_config("jamba-v0.1-52b")
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(5)
    reqs = [Request(request_id=f"r{i}", prompt=[int(t) for t in rng.integers(
        2, cfg.vocab_size, n)], sampling=SamplingParams(max_new_tokens=8))
        for i, n in enumerate((30, 45))]

    def engine():
        return LLMEngine(model, params, EngineConfig(
            block_size=8, num_blocks=128, num_state_slots=4, max_model_len=128,
            device="cuda"))
    fresh, reused = engine(), engine()
    fresh.add_request(dataclasses.replace(reqs[1]))
    fresh.run()
    reused.add_request(dataclasses.replace(reqs[0]))
    reused.run()
    reused.add_request(dataclasses.replace(reqs[1]))
    reused.run()
    assert reused.seqs["r1"].generated == fresh.seqs["r1"].generated


# ---------------------------------------------------------------------------
# modality families: whisper-base's audio frames, internvl2-2b's image rows
# ---------------------------------------------------------------------------

def _extras_serve(arch, params, device):
    """The smoke config of ``arch`` in f32 on ``device`` with the given CPU
    weights: 4 greedy requests with random extras over 6-token chunks (an
    image straddles a chunk boundary). Returns the engine."""
    from repro_torch.core import SchedulerConfig
    model = build_model(configs.smoke_config(arch), device=device)
    cfg = model.cfg
    eng = LLMEngine(model, _tree_to(params, device), EngineConfig(
        block_size=8, num_blocks=128, max_model_len=128, device=device,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=64,
                                  prefill_chunk=6)))
    rng = np.random.default_rng(4)
    key, rows = (("audio_frames", cfg.n_audio_ctx) if cfg.family == "audio"
                 else ("vision_embeds", cfg.num_image_tokens))
    for i in range(4):
        eng.add_request(Request(
            request_id=f"r{i}", prompt=[int(t) for t in rng.integers(
                2, cfg.vocab_size, int(rng.integers(12, 40)))],
            extras={key: rng.normal(size=(rows, cfg.d_model)).astype(np.float32)},
            sampling=SamplingParams(max_new_tokens=12)))
    eng.run()
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_modality_smoke_streams_on_card_equal_cpu(cuda, arch):
    """The same f32 smoke weights and extras served on the CPU and on the
    card give the same greedy streams: whisper's encoder and cross K/V in
    state slots (flash_prefill on the decoder's fresh rows, D = 64),
    internvl's image chunks gathered and the rest paged (paged_attention
    at G = 2)."""
    params = build_model(configs.smoke_config(arch), device="cpu").init(0)
    cpu = _extras_serve(arch, params, "cpu")
    flash = fmod.flash_prefill.launches
    gpu = _extras_serve(arch, params, "cuda")
    got = {rid: s.generated for rid, s in gpu.seqs.items()}
    assert got == {rid: s.generated for rid, s in cpu.seqs.items()}
    assert fmod.flash_prefill.launches > flash
    if arch == "internvl2-2b":
        assert gpu.paged_steps > 0 and gpu.runner.steps > 0
