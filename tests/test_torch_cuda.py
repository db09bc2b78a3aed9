"""The port's CUDA paged-attention kernel vs its plain PyTorch version, on
the card. Every test here is marked ``gpu`` and skips without CUDA.

This file imports neither JAX nor ``repro``, so it runs on a machine with
only PyTorch and the CUDA toolkit. ``tests/conftest.py`` imports JAX, so
there it runs without the conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances: f32 ``atol 1e-5`` (summation order only); bf16 ``atol 2e-2``
(both compute in fp32 and round the output once).
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
