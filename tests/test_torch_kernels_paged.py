"""PyTorch port of paged attention vs the JAX reference.

Same inputs (numpy, seeded) through ``repro.kernels.paged_attention`` (its
jnp oracles: what the JAX package runs on the CPU) and
``repro_torch.kernels.paged_attention`` (its plain PyTorch versions: what
the port runs on CPU tensors). Tolerances: f32 ``atol 1e-5`` (summation
order only); bf16 outputs ``atol 2e-2`` (both compute in fp32 and round the
output once, so they differ by at most one bf16 rounding of values of order
1). The CUDA kernel itself runs only on the card: the ``gpu``-marked tests
in ``test_torch_cuda.py`` and ``chip_smoke.py`` hold it against these plain
versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels.paged_attention import ref as jref
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.paged_attention import paged_attention as tkernel
from repro_torch.kernels.paged_attention import ref as tref

CASES = [
    # B, KV, G, D, P, NB, NP — the shape cases of tests/test_kernels_paged.py
    (1, 1, 8, 64, 16, 8, 4),     # MQA (gemma-style)
    (2, 2, 4, 64, 16, 16, 4),    # GQA
    (3, 4, 1, 32, 8, 16, 8),     # MHA
    (2, 2, 5, 128, 32, 8, 2),    # odd group, big pages
]


def _inputs(seed, B, KV, G, D, P, NB, NP, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, D)).astype(np.float32)
    k = rng.normal(size=(KV, NB, P, D)).astype(np.float32)
    v = rng.normal(size=(KV, NB, P, D)).astype(np.float32)
    tables = np.stack([rng.choice(NB, size=NP, replace=False)
                       for _ in range(B)]).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, NP * P + 1, size=(B,))
    return q, k, v, tables, np.asarray(lengths, np.int32)


def _t(*arrays, dtype=None):
    return [torch.from_numpy(np.ascontiguousarray(a)) if dtype is None
            else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def _j(*arrays, dtype=None):
    return [jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)
            for a in arrays]


@pytest.mark.parametrize("B,KV,G,D,P,NB,NP", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(B, KV, G, D, P, NB, NP, dtype):
    q, k, v, tables, lengths = _inputs(1, B, KV, G, D, P, NB, NP)
    scale = D ** -0.5
    if dtype == "bfloat16":
        # round the inputs once; both frameworks then see identical values
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    # f32 on the rounded inputs: the algorithm, atol 1e-5
    want = jref.paged_attention_ref(*_j(q, k, v, tables, lengths), scale=scale)
    got = tref.paged_attention_ref(*_t(q, k, v, tables, lengths), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if dtype == "bfloat16":
        # bf16 in, bf16 out: one output rounding apart at most
        want = jref.paged_attention_ref(*_j(q, k, v, dtype=jnp.bfloat16),
                                        *_j(tables, lengths), scale=scale)
        got = tref.paged_attention_ref(*_t(q, k, v, dtype=torch.bfloat16),
                                       *_t(tables, lengths), scale=scale)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("C", [2, 5, 8])
def test_chunked_ref_matches_jax(C):
    B, KV, G, D, P, NB, NP = 3, 2, 4, 32, 8, 32, 4
    rng = np.random.default_rng(C)
    q = rng.normal(size=(B, C, KV, G, D)).astype(np.float32)
    _, k, v, tables, _ = _inputs(C, B, KV, G, D, P, NB, NP)
    lengths = np.asarray([0, P - 1, 2 * P], np.int32)
    want = jref.paged_attention_chunked_ref(*_j(q, k, v, tables, lengths),
                                            scale=0.2)
    got = tref.paged_attention_chunked_ref(*_t(q, k, v, tables, lengths),
                                           scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_model_layout_ops_match_jax():
    """paged_attend / paged_attend_extend (model layout, engine int64
    tables, ragged lengths) == the JAX ops on the CPU path."""
    B, KV, G, D, P, NB, NP, C = 3, 2, 4, 32, 8, 16, 4, 5
    H = KV * G
    rng = np.random.default_rng(7)
    q1 = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    qc = rng.normal(size=(B, C, H, D)).astype(np.float32)
    _, k, v, tables, _ = _inputs(7, B, KV, G, D, P, NB, NP)
    tables = tables.astype(np.int64)  # engine dtype
    lengths = np.asarray([13, 27, 1], np.int32)  # ragged
    want = jpa.paged_attend(*_j(q1, k, v, tables, lengths), scale=0.2, impl="ref")
    got = tpa.paged_attend(*_t(q1, k, v, tables, lengths), scale=0.2)
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ext = lengths - np.asarray([0, 4, 1], np.int32)  # chunk starts
    want = jpa.paged_attend_extend(*_j(qc, k, v, tables, ext), scale=0.2,
                                   impl="ref")
    got = tpa.paged_attend_extend(*_t(qc, k, v, tables, ext), scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("C", [2, 5, 8])
def test_extend_fold_matches_chunked_oracle(C):
    """The CUDA path's batch-axis fold, run on CPU tensors with the plain
    decode version per folded row, equals the direct chunked oracle —
    chunk starts mid-page and on page boundaries included."""
    B, KV, G, D, P, NB, NP = 3, 2, 4, 32, 8, 32, 4
    H = KV * G
    rng = np.random.default_rng(100 + C)
    q = torch.from_numpy(rng.normal(size=(B, C, H, D)).astype(np.float32))
    _, k, v, tables, _ = _inputs(100 + C, B, KV, G, D, P, NB, NP)
    k, v, tables = _t(k, v, tables)
    lengths = torch.tensor([0, P - 1, 2 * P], dtype=torch.int32)
    out = tpa.paged_attend_extend_folded(q, k, v, tables, lengths, scale=0.2)
    ref = tref.paged_attention_chunked_ref(q.reshape(B, C, KV, G, D), k, v,
                                           tables, lengths, scale=0.2)
    np.testing.assert_allclose(out.numpy(), ref.reshape(B, C, H, D).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("path", ["decode", "fold"])
def test_garbage_beyond_length_ignored(path):
    """Page slots at or past the valid length must not affect the output
    (the paging invariant): poison them with +-1e6 and compare."""
    B, KV, G, D, P, NB, NP = 1, 2, 2, 32, 8, 8, 4
    q, k, v, tables, _ = _inputs(3, B, KV, G, D, P, NB, NP)
    q, k, v = _t(q, k, v)
    tables = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    lengths = torch.tensor([13], dtype=torch.int32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 2:] = 1e6  # pages 2, 3 lie entirely beyond position 13
    v2[:, 2:] = -1e6
    k2[:, 1, 5:] = 1e6  # and the tail of page 1: positions 13..15
    v2[:, 1, 5:] = -1e6
    if path == "decode":
        out1 = tkernel.paged_attention(q, k, v, tables, lengths, scale=0.2)
        out2 = tkernel.paged_attention(q, k2, v2, tables, lengths, scale=0.2)
    else:
        qf = q.reshape(B, 1, KV * G, D)
        short = lengths - 1  # one-token chunk at position 12: sees 0..12
        out1 = tpa.paged_attend_extend_folded(qf, k, v, tables, short, scale=0.2)
        out2 = tpa.paged_attend_extend_folded(qf, k2, v2, tables, short,
                                              scale=0.2)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_zero_length_row_returns_zeros():
    q, k, v, tables, _ = _inputs(4, 2, 2, 2, 32, 8, 8, 2)
    out = tkernel.paged_attention(*_t(q, k, v, tables),
                                  torch.tensor([0, 5], dtype=torch.int32),
                                  scale=0.2)
    assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out))


def test_no_silent_cpu_fallback(monkeypatch, tmp_path):
    """A tensor that is not on the CPU never takes the plain version: other
    devices and mixed devices raise, a CUDA device without CUDA raises, and
    a kernel build without nvcc raises instead of computing anything."""
    q, k, v, tables, lengths = _t(*_inputs(5, 1, 1, 2, 32, 8, 4, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        tkernel.paged_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                tables.to("meta"), lengths.to("meta"), scale=1.0)
    with pytest.raises(ValueError, match="several devices"):
        tkernel.paged_attention(q.to("meta"), k, v, tables, lengths, scale=1.0)
    with pytest.raises(ValueError, match="no path for device"):
        tpa.paged_attend_extend(q.reshape(1, 1, 2, 32).to("meta"), k, v,
                                tables, lengths, scale=1.0)
    if not torch.cuda.is_available():
        from repro_torch import configs
        from repro_torch.models import build_model
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(configs.smoke_config("olmo-1b"), device="cuda")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tkernel.build(build_dir=tmp_path / "build")
