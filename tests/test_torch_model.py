"""PyTorch port's model vs the JAX model, same weights.

The JAX smoke model is initialized with ``PRNGKey(0)``, its value tree is
converted by ``repro_torch.models.convert``, and both run ``decode_paged``
and ragged ``extend_paged`` (with ``chunk_lens`` and a ``scratch_block``)
over the same numpy-seeded page pools, on the CPU in f32. Compared: the
logits, the K/V each layer hands back for the host store, and the page
pools after the in-place writes. Tolerance ``atol 1e-4``: f32 with matmul
and reduction orders differing between XLA and PyTorch over 2 layers.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import split_params
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import convert_params

ARCHS = ["olmo-1b", "gemma-2b", "qwen2.5-32b"]
ATOL = 1e-4
NB, P, NP = 32, 8, 4
SCRATCH = 0  # never a member of the tables below


def _models(arch):
    jcfg = jconfigs.smoke_config(arch)
    jm = jbuild(jcfg)
    values = jax.device_get(split_params(jm.init(jax.random.PRNGKey(0)))[0])
    tm = tbuild(tconfigs.smoke_config(arch), device="cpu")
    return jcfg, jm, values, tm, convert_params(tm.cfg, values)


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_kv_heads, NB, P, cfg.head_dim)
    return [{n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
            for _ in range(cfg.num_layers)]


def _jax_pages(pools):
    # one smoke stage, one repeat, pattern slots l0..l{n-1}
    return ({"r0": {f"l{i}": {n: jax.numpy.asarray(a) for n, a in p.items()}
                    for i, p in enumerate(pools)}},)


def _torch_pages(pools):
    return [{n: torch.from_numpy(a.copy()) for n, a in p.items()} for p in pools]


def _jax_layers(tree):
    return [tree[0]["r0"][f"l{i}"] for i in range(len(tree[0]["r0"]))]


def _tables(rng, B):
    """Disjoint rows (no two sequences own a block), none the scratch."""
    return rng.permutation(np.arange(1, NB))[: B * NP].reshape(B, NP).astype(np.int64)


def test_convert_unstacks_layers():
    jcfg, _, values, tm, params = _models("qwen2.5-32b")
    assert len(params["layers"]) == jcfg.num_layers
    stage = values["stages"][0]
    for i, layer in enumerate(params["layers"]):
        src = stage[f"l{i}"]
        np.testing.assert_array_equal(layer["mixer"]["wq"]["w"].numpy(),
                                      np.asarray(src["mixer"]["wq"]["w"])[0])
        np.testing.assert_array_equal(layer["mixer"]["wk"]["b"].numpy(),
                                      np.asarray(src["mixer"]["wk"]["b"])[0])
        np.testing.assert_array_equal(layer["ff"]["w2"]["w"].numpy(),
                                      np.asarray(src["ff"]["w2"]["w"])[0])
    assert "lm_head" in params  # qwen: untied head
    np.testing.assert_array_equal(params["embed"].numpy(), values["embed"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_paged_matches_jax(arch):
    jcfg, jm, values, tm, params = _models(arch)
    rng = np.random.default_rng(11)
    B = 3
    pools = _pools(jcfg, 12)
    tables = _tables(rng, B)
    lengths = np.asarray([0, 9, NP * P - 1], np.int32)  # first, mid, last slot
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jpages, jw = jm.decode_paged(values, jax.numpy.asarray(tokens),
                                     _jax_pages(pools), jax.numpy.asarray(tables),
                                     jax.numpy.asarray(lengths))
    tpages = _torch_pages(pools)
    tl, _, tw = tm.decode_paged(params, torch.from_numpy(tokens), tpages,
                                torch.from_numpy(tables), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for jp, tp, jwl, twl in zip(_jax_layers(jpages), tpages, _jax_layers(jw), tw):
        for n in ("k", "v"):
            np.testing.assert_allclose(twl[n].numpy(), np.asarray(jwl[n]), atol=ATOL)
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_extend_paged_matches_jax(arch):
    jcfg, jm, values, tm, params = _models(arch)
    rng = np.random.default_rng(21)
    B, C = 4, 8
    pools = _pools(jcfg, 22)
    tables = _tables(rng, B)
    lengths = np.asarray([0, 5, 16, 20], np.int32)
    chunk_lens = np.asarray([8, 3, 1, 6], np.int32)  # ragged, crossing pages
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32)
    jl, jpages, jw = jm.extend_paged(
        values, jax.numpy.asarray(tokens), _jax_pages(pools),
        jax.numpy.asarray(tables), jax.numpy.asarray(lengths),
        jax.numpy.asarray(chunk_lens), jax.numpy.asarray(SCRATCH, jax.numpy.int32))
    tpages = _torch_pages(pools)
    tl, _, tw = tm.extend_paged(params, torch.from_numpy(tokens), tpages,
                                torch.from_numpy(tables),
                                torch.from_numpy(lengths),
                                torch.from_numpy(chunk_lens), SCRATCH)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for jp, tp, jwl, twl in zip(_jax_layers(jpages), tpages, _jax_layers(jw), tw):
        for n in ("k", "v"):
            np.testing.assert_allclose(twl[n].numpy(), np.asarray(jwl[n]), atol=ATOL)
            # the scratch block takes colliding padded writes in any order
            np.testing.assert_allclose(tp[n][:, 1:].numpy(),
                                       np.asarray(jp[n])[:, 1:], atol=ATOL)
