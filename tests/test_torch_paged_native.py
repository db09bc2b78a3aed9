"""The port's split-K paged attention and native chunked extend vs the JAX
reference, on the CPU.

The CUDA kernel (``csrc/paged_attention.cu``) splits each row's key axis
over CTAs and merges their fp32 partials (m, l, acc); on bf16 / f16 it
serves chunked extend natively instead of folding the chunk into the batch
axis. What of that is plain Python or plain PyTorch is held here against
the JAX package on the same numpy inputs (seeded): the split plan
(``plan_splits``), the split-K twin of the kernel's algebra
(``paged_attention_split_ref``), the chunked extend entry point and the
route helper (``kernel_route``). Tolerance: f32 ``atol 1e-5`` (summation
order only). The kernel itself runs only on the card: ``gpu`` tests in
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels.paged_attention.paged_attention import paged_attention as jax_kernel
from repro.kernels.paged_attention import ref as jref
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.paged_attention import paged_attention as tkernel
from repro_torch.kernels.paged_attention import ref as tref

ATOL = 1e-5


def _pages(rng, KV, NB, P, D):
    return [rng.normal(size=(KV, NB, P, D)).astype(np.float32) for _ in range(2)]


def _tables(rng, B, NB, NP):
    return np.stack([rng.choice(NB, size=NP, replace=False)
                     for _ in range(B)]).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------------------
# the split plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ctas", [1, 8, 64, 128, 256, 1000, 5000])
@pytest.mark.parametrize("keys", [1, 64, 65, 1024, 4096])
@pytest.mark.parametrize("sm_count,per_sm", [(132, 1), (132, 2), (8, 3)])
def test_plan_splits_bounds(ctas, keys, sm_count, per_sm):
    """At least one split; never more splits than key tiles; every split
    starts inside the table (no split is planned wholly past it)."""
    tiles = -(-keys // tkernel.KEY_TILE)
    s = tkernel.plan_splits(ctas, keys, sm_count, per_sm)
    assert 1 <= s <= tiles
    per = -(-tiles // s)
    assert (s - 1) * per < tiles


def test_plan_splits_at_the_timed_shapes():
    """An H100 has 132 SMs; the mma kernel holds 2 CTAs per SM at D <= 128
    and 1 at D = 256. MQA decode at B=8 (8 CTAs) spreads over the SMs, one
    key tile each; olmo-1b decode (128 CTAs) takes 2-4 splits; a grid
    that already fills the card is not split; nothing to plan gives 1."""
    assert tkernel.plan_splits(8, 1024, 132, 1) == 16
    assert 2 <= tkernel.plan_splits(128, 1024, 132, 2) <= 4
    assert tkernel.plan_splits(256, 1024, 132, 2) == 1
    assert tkernel.plan_splits(0, 1024, 132, 2) == 1
    assert tkernel.plan_splits(64, 0, 132, 2) == 1


# --------------------------------------------------------------------------
# the split-K twin: partials and merge
# --------------------------------------------------------------------------

SPLIT_CASES = [
    # B, KV, G, D, P, NB, NP, lengths: ragged, a length of 0, a full table
    (3, 2, 4, 32, 8, 16, 4, [13, 0, 32]),
    (2, 1, 8, 64, 16, 8, 4, [64, 5]),
    (2, 2, 5, 128, 8, 8, 3, [1, 24]),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, 7, "NP"])
@pytest.mark.parametrize("key_tile", [64, 8])
def test_split_ref_decode_matches_jax_kernel(case, splits, key_tile):
    """Decode: the split-K partials and merge == the port's plain version
    == the JAX Pallas kernel in interpret mode. With key_tile 8 most splits
    lie wholly past some row's length (and, at 7 or NP, past the table)."""
    B, KV, G, D, P, NB, NP, lengths = case
    splits = NP if splits == "NP" else splits
    rng = np.random.default_rng(sum(case[:7]) + splits)
    q = rng.normal(size=(B, KV, G, D)).astype(np.float32)
    k, v = _pages(rng, KV, NB, P, D)
    tables = _tables(rng, B, NB, NP)
    lengths = np.asarray(lengths, np.int32)
    got = tref.paged_attention_split_ref(*_t(q, k, v, tables, lengths), scale=D ** -0.5,
                                         splits=splits, key_tile=key_tile)
    plain = tref.paged_attention_ref(*_t(q, k, v, tables, lengths), scale=D ** -0.5)
    want = jax_kernel(*_j(q, k, v, tables, lengths), scale=D ** -0.5, interpret=True)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert np.all(got.numpy()[lengths == 0] == 0)


@pytest.mark.parametrize("splits", [1, 2, 7, 4])
def test_split_ref_extend_matches_jax_chunked(splits):
    """Chunked extend: the split-K twin (row (b, c) sees lengths[b] + c + 1
    positions) == the JAX chunked oracle, rows running past the table
    included (lengths + C > NP * P)."""
    B, C, KV, G, D, P, NB, NP = 3, 6, 2, 2, 32, 8, 12, 4
    rng = np.random.default_rng(40 + splits)
    q = rng.normal(size=(B, C, KV, G, D)).astype(np.float32)
    k, v = _pages(rng, KV, NB, P, D)
    tables = _tables(rng, B, NB, NP)
    lengths = np.asarray([0, 9, 29], np.int32)  # 29 + 6 > 32
    got = tref.paged_attention_split_ref(*_t(q, k, v, tables, lengths), scale=0.2,
                                         splits=splits, rows_per_seq=C, key_tile=8)
    want = jref.paged_attention_chunked_ref(*_j(q, k, v, tables, lengths), scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_split_ref_ignores_poisoned_dead_slots():
    """Slots past every row's last position may hold +-inf: the twin, like
    the kernel, never lets them reach a sum."""
    B, C, KV, G, D, P, NB, NP = 1, 3, 2, 2, 32, 8, 4, 4
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, C, KV, G, D)).astype(np.float32)
    k, v = _pages(rng, KV, NB, P, D)
    tables = np.asarray([[0, 1, 2, 3]], np.int32)
    lengths = np.asarray([10], np.int32)  # rows see up to 13 positions
    clean = tref.paged_attention_split_ref(*_t(q, k, v, tables, lengths), scale=0.2,
                                           splits=3, rows_per_seq=C, key_tile=8)
    k[:, 1, 5:], v[:, 1, 5:] = np.inf, -np.inf
    k[:, 2:], v[:, 2:] = 1e6, -1e6
    bad = tref.paged_attention_split_ref(*_t(q, k, v, tables, lengths), scale=0.2,
                                         splits=3, rows_per_seq=C, key_tile=8)
    np.testing.assert_allclose(bad.numpy(), clean.numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# chunked extend through the model-layout entry point
# --------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_paged_attend_extend_matches_jax(G, D, impl):
    """paged_attend_extend on CPU tensors (the wrapper's chunked path) ==
    the JAX op's direct chunked oracle and its fold through the Pallas
    kernel in interpret mode. Chunk starts are ragged, one mid-page, and the
    padded rows of the last sequence run past the table (their row_len
    exceeds NP * P: they see the whole table)."""
    B, C, KV, P, NB, NP = 3, 5, 2, 8, 10, 3
    H = KV * G
    rng = np.random.default_rng(G * 1000 + D)
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    k, v = _pages(rng, KV, NB, P, D)
    tables = _tables(rng, B, NB, NP).astype(np.int64)  # the engine's dtype
    lengths = np.asarray([0, 11, 22], np.int32)  # 22 + 5 > 24
    got = tpa.paged_attend_extend(*_t(q, k, v, tables, lengths), scale=D ** -0.5)
    want = jpa.paged_attend_extend(*_j(q, k, v, tables, lengths), scale=D ** -0.5,
                                   impl=impl)
    assert got.shape == (B, C, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_cpu_paths():
    """On CPU tensors the wrapper takes the plain versions: decode, chunked
    extend (rows_per_seq), and with ``splits`` the split-K twin."""
    B, C, KV, G, D, P, NB, NP = 2, 4, 2, 3, 32, 8, 8, 3
    rng = np.random.default_rng(9)
    q5 = rng.normal(size=(B, C, KV, G, D)).astype(np.float32)
    k, v = _pages(rng, KV, NB, P, D)
    tables = _tables(rng, B, NB, NP)
    lengths = np.asarray([3, 17], np.int32)
    q5, k, v, tables, lengths = _t(q5, k, v, tables, lengths)
    want = tref.paged_attention_chunked_ref(q5, k, v, tables, lengths, scale=0.3)
    for splits in (None, 1, 3):
        got = tkernel.paged_attention(q5, k, v, tables, lengths, scale=0.3,
                                      rows_per_seq=C, splits=splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    q4 = q5[:, 0].contiguous()
    want = tref.paged_attention_ref(q4, k, v, tables, lengths, scale=0.3)
    for splits in (None, 2):
        got = tkernel.paged_attention(q4, k, v, tables, lengths, scale=0.3, splits=splits)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


# --------------------------------------------------------------------------
# the route and the wrapper's checks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_kernel_route(D):
    """16-bit pages take the mma kernel at every accepted head_dim; fp32
    keeps the CUDA-core kernel (decode rows only: extend folds)."""
    assert tkernel.kernel_route(torch.bfloat16, D) == "mma"
    assert tkernel.kernel_route(torch.float16, D) == "mma"
    assert tkernel.kernel_route(torch.float32, D) == "cuda_core"


def test_check_refuses_bad_rows_per_seq():
    """The new shape checks of the chunked path, before any pointer leaves
    Python: a chunked call needs (B, C, KV, G, D) with C == rows_per_seq,
    and a decode call (B, KV, G, D)."""
    k = torch.zeros(2, 4, 8, 32, dtype=torch.bfloat16)
    tables = torch.zeros(3, 2, dtype=torch.int32)
    lengths = torch.zeros(3, dtype=torch.int32)
    q4 = torch.zeros(3, 2, 2, 32, dtype=torch.bfloat16)
    q5 = torch.zeros(3, 5, 2, 2, 32, dtype=torch.bfloat16)
    tkernel._check(q4, k, k, tables, lengths, None)
    tkernel._check(q5, k, k, tables, lengths, 5)
    with pytest.raises(ValueError, match=r"\(B, C, KV, G, D\)"):
        tkernel._check(q4, k, k, tables, lengths, 5)
    with pytest.raises(ValueError, match="rows_per_seq=4"):
        tkernel._check(q5, k, k, tables, lengths, 4)
    with pytest.raises(ValueError, match=r"\(B, KV, G, D\)"):
        tkernel._check(q5, k, k, tables, lengths, None)
