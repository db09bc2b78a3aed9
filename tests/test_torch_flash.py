"""The port's causal flash prefill and plain window attention vs the JAX
package's, on the CPU.

``flash_prefill_ref`` (the plain version the CUDA kernel is held against on
the card, and the CPU path of ``ops.flash_prefill``) against JAX's
``flash_prefill_ref`` and against the Pallas kernel in interpret mode, over
the shape cases of ``tests/test_kernels_flash.py`` with its tolerances
(f32 ``atol 1e-5``, bf16 ``3e-2``), plus the causality check. Then the
port's ``models.attention.flash_attention`` against the reference's
blockwise ``lax`` version for global and window kinds, per-row positions,
and the chunked kind's mask,
``kv_valid`` and GQA/MQA (``atol 1e-5``: f32 sums in another order).
Inputs are drawn with numpy from fixed seeds and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_prefill_attention
from repro.kernels.flash_attention.ref import flash_prefill_ref as jax_flash_prefill_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import flash_prefill, flash_prefill_ref
from repro_torch.models import attention as tattn

CASES = [
    # B, H, KV, S, D, window, qb, kb — tests/test_kernels_flash.py
    (2, 4, 2, 128, 64, 0, 32, 32),
    (1, 8, 1, 256, 32, 0, 64, 64),   # MQA
    (2, 6, 6, 64, 64, 0, 32, 32),    # MHA
    (1, 4, 2, 256, 64, 64, 32, 32),  # sliding window (starcoder2-style)
    (1, 2, 2, 128, 128, 0, 128, 64), # uneven q/kv blocks
]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,KV,S,D,w,qb,kb", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_prefill_ref_matches_jax(B, H, KV, S, D, w, qb, kb, dtype):
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _draw(S + D, (B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    scale = D ** -0.5
    got = flash_prefill_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                            scale=scale, window=w)
    assert got.dtype == tdt and got.shape == (B, H, S, D)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want_ref = jax_flash_prefill_ref(jq, jk, jv, scale=scale, window=w)
    want_kernel = flash_prefill_attention(jq, jk, jv, scale=scale, window=w,
                                          impl="interpret", q_block=qb, kv_block=kb)
    np.testing.assert_allclose(_np(got.float()), _np(want_ref), atol=atol)
    np.testing.assert_allclose(_np(got.float()), _np(want_kernel), atol=atol)


def test_flash_prefill_op_takes_strided_model_layout():
    """``ops.flash_prefill`` on CPU tensors is the plain version, read
    through the strides of (B, S, heads, D) activations, at an S that is no
    multiple of any block."""
    B, S, H, KV, D = 2, 37, 4, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _draw(3, (B, S, H, D), (B, S, KV, D),
                                                  (B, S, KV, D)))
    got = flash_prefill(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        scale=0.3, window=5)
    want = jax_flash_prefill_ref(*(jnp.asarray(t.transpose(1, 2).numpy())
                                   for t in (q, k, v)), scale=0.3, window=5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_causality():
    """Future tokens must not leak: perturbing position j>i leaves row i fixed."""
    B, H, S, D = 1, 2, 64, 32
    q, k, v = (torch.from_numpy(a) for a in _draw(4, *[(B, H, S, D)] * 3))
    out1 = flash_prefill(q, k, v, scale=0.2)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] += 100.0
    v2[:, :, 40:] -= 50.0
    out2 = flash_prefill(q, k2, v2, scale=0.2)
    np.testing.assert_allclose(out1[:, :, :40].numpy(), out2[:, :, :40].numpy(),
                               atol=1e-5)
    assert not np.allclose(out1[:, :, 40:].numpy(), out2[:, :, 40:].numpy())


# B, Sq, Sk, H, KV, D, kind, window, per-row positions, kv_valid
ATTN_CASES = [
    (2, 16, 16, 4, 2, 32, "global", 0, False, False),   # prefill, GQA
    (2, 8, 48, 4, 1, 32, "global", 0, True, True),      # continuation, MQA
    (3, 8, 48, 4, 4, 64, "window", 16, True, True),     # window binds, MHA
    (2, 24, 40, 6, 2, 32, "window", 7, True, True),     # per-row, small window
    (1, 33, 33, 2, 2, 128, "window", 5, False, False),  # no block multiple
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,kind,window,per_row,valid", ATTN_CASES)
def test_flash_attention_matches_jax(B, Sq, Sk, H, KV, D, kind, window, per_row,
                                     valid):
    q, k, v = _draw(Sq * Sk + D, (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))
    rng = np.random.default_rng(B + Sk)
    if per_row:  # each row's chunk starts after its cached prefix
        start = rng.integers(0, Sk - Sq + 1, size=B)
        q_pos = start[:, None] + np.arange(Sq)[None, :]
        k_pos = np.broadcast_to(np.arange(Sk), (B, Sk))
    else:
        q_pos = np.arange(Sq)
        k_pos = np.arange(Sk)
    kv_valid = None
    if valid:
        kv_valid = np.arange(Sk)[None, :] < (np.asarray(q_pos)[:, -1:] + 1)
    scale = D ** -0.5
    got = tattn.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_pos=torch.from_numpy(np.asarray(q_pos)),
        k_pos=torch.from_numpy(np.ascontiguousarray(k_pos)), kind=kind, window=window,
        scale=scale, kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
    want = jattn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), kind=kind, window=window, scale=scale,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
        q_block=8, kv_block=16)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_flash_attention_row_without_keys_is_zero():
    q, k, v = (torch.from_numpy(a) for a in _draw(5, (1, 4, 2, 32), (1, 8, 2, 32),
                                                  (1, 8, 2, 32)))
    kv_valid = torch.zeros(1, 8, dtype=torch.bool)
    out = tattn.flash_attention(q, k, v, q_pos=torch.arange(4), k_pos=torch.arange(8),
                                scale=0.2, kv_valid=kv_valid)
    assert torch.equal(out, torch.zeros_like(out))


def test_pair_mask_refuses_chunked():
    """The chunked kind (llama4), refused until the port served it, masks as
    JAX's ``pair_mask`` does, per-row positions too; an unknown kind is
    still refused."""
    q_pos = np.array([[0, 5, 15, 16, 17, 31], [30, 31, 32, 33, 47, 48]])
    k_pos = np.arange(50)
    for chunk in (0, 8, 16):
        got = tattn.pair_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                              "chunked", chunk=chunk)
        want = jattn.pair_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), "chunked",
                               chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown attention kind"):
        tattn.pair_mask(torch.arange(4), torch.arange(4), "strided")


def test_kernel_route_by_dtype_and_head_dim():
    """The wrapper's choice between the source's two CUDA kernels: 16-bit
    inputs at head_dim 64 / 128 take the wgmma kernel, the rest (f32, where
    TF32 would break the 1e-5 gate; head_dim 32 and 256) the CUDA cores.
    Pure: decided from dtype and head_dim alone, so it is checked here; on
    the card, a CPU tensor still takes the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention as fmod

    for dtype in (torch.bfloat16, torch.float16):
        assert [fmod.kernel_route(dtype, D) for D in (32, 64, 128, 256)] == \
            ["cuda_core", "wgmma", "wgmma", "cuda_core"]
    assert {fmod.kernel_route(torch.float32, D) for D in (32, 64, 128, 256)} == {"cuda_core"}
    assert fmod.ROUTES == {"cuda_core": 0, "wgmma": 1}
    q = torch.zeros(1, 2, 4, 64, dtype=torch.bfloat16)
    before = fmod.flash_prefill.launches
    assert torch.equal(fmod.flash_prefill(q, q, q, scale=1.0),
                       flash_prefill_ref(q, q, q, scale=1.0))
    assert fmod.flash_prefill.launches == before
