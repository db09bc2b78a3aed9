"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX package's (``repro.models.mla`` and
``repro.models.model._mla_extend``) on the CPU.

The same parameters (JAX's ``make_mla_params`` at the deepseek-v3-671b smoke
width, f32, converted to tensors) and the same numpy-seeded inputs go
through both: the parameter tree's shapes; ``_project_q`` with and without
a query rank (``q_lora_rank`` 0 gives ``wq``); ``_latent_kv``; the
expanded ``mla_forward``; the absorbed ``mla_decode`` (ragged cache
lengths); and ``mla_extend``, the serving path, against ``_mla_extend``
with ragged cache lengths including 0 and rows whose chunk runs past the
window (their slots past W are dropped on both sides). Outputs and the
written cache slots agree within ``ATOL`` (f32, sums in another order).
In the port alone, ``mla_decode`` equals ``mla_extend`` at C = 1: the
absorbed and the expanded forms of the same attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro.models import split_params
from repro_torch import configs as tconfigs
from repro_torch.models import mla as tmla

ATOL = 1e-5  # f32, summation order only
# the reference's functions jitted once per shape (op-by-op dispatch of the
# unjitted ones compiles every op); cfg and spec are static
JMLA = {f: jax.jit(getattr(mod, f), static_argnums=(1, 2))
        for mod, f in ((jmla, "mla_forward"), (jmla, "mla_decode"),
                       (jmodel, "_mla_extend"))}
NAME = "deepseek-v3-671b"
W = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread: on a shared machine
    a contended thread pool makes each small op take milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**changes):
    return (dataclasses.replace(jsmoke_config(NAME), **changes),
            dataclasses.replace(tconfigs.smoke_config(NAME), **changes))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.fixture(scope="module", params=[64, 0], ids=["q_lora", "no_q_lora"])
def layer(request):
    """(jcfg, tcfg, JAX params, port params, spec) of one MLA layer."""
    jcfg, tcfg = _cfgs(q_lora_rank=request.param)
    values, _ = split_params(jmla.make_mla_params(jax.random.PRNGKey(3), jcfg,
                                                  jnp.float32))
    tp = _map(values, lambda a: torch.from_numpy(np.array(a)))
    return jcfg, tcfg, values, tp, tcfg.layer_specs()[0]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _shapes(tree):
    return _map(tree, lambda a: tuple(a.shape))


@pytest.mark.parametrize("q_lora", [64, 0])
def test_param_tree_matches_jax(q_lora):
    jcfg, tcfg = _cfgs(q_lora_rank=q_lora)
    values, _ = split_params(jmla.make_mla_params(jax.random.PRNGKey(0), jcfg,
                                                  jnp.float32))
    gen = torch.Generator().manual_seed(0)
    tp = tmla.make_mla_params(gen, tcfg, torch.float32, "cpu")
    assert _shapes(tp) == _shapes(values)
    assert ("wq_b" in tp) == bool(q_lora) and ("wq" in tp) == (not q_lora)
    H, qk = tcfg.num_heads, tcfg.qk_nope_head_dim + tcfg.qk_rope_head_dim
    if q_lora:
        assert tuple(tp["wq_b"]["w"].shape) == (q_lora, H, qk)
    assert tuple(tp["wkv_b"]["w"].shape) == (
        tcfg.kv_lora_rank, H, tcfg.qk_nope_head_dim + tcfg.v_head_dim)
    assert tuple(tp["wo"]["w"].shape) == (H, tcfg.v_head_dim, tcfg.d_model)


def test_project_q_and_latents_match_jax(layer):
    jcfg, tcfg, jp, tp, _ = layer
    x = _x(tcfg, 2, 5, 1)
    for j, t in zip(jmla._project_q(jp, jcfg, jnp.asarray(x)),
                    tmla._project_q(tp, tcfg, torch.from_numpy(x))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    for j, t in zip(jmla._latent_kv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos)),
                    tmla._latent_kv(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    for j, t in zip(jmla._split_wkv_b(jp, jcfg), tmla._split_wkv_b(tp, tcfg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_mla_forward_matches_jax(layer):
    jcfg, tcfg, jp, tp, spec = layer
    x = _x(tcfg, 2, 9, 2)
    jo, (jc, jpe) = JMLA["mla_forward"](jp, jcfg, spec, jnp.asarray(x), jnp.arange(9))
    to, (tc, tpe) = tmla.mla_forward(tp, tcfg, spec, torch.from_numpy(x), torch.arange(9))
    for t, j in ((to, jo), (tc, jc), (tpe, jpe)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def _cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {"c_kv": rng.normal(size=(B, W, cfg.kv_lora_rank)).astype(np.float32),
            "k_pe": rng.normal(size=(B, W, cfg.qk_rope_head_dim)).astype(np.float32)}


def test_mla_decode_matches_jax(layer):
    jcfg, tcfg, jp, tp, spec = layer
    cache_len = np.array([0, 5, 23], np.int32)
    x = _x(tcfg, 3, 1, 3)
    cache = _cache(tcfg, 3, 4)
    jo, jc = JMLA["mla_decode"](jp, jcfg, spec, jnp.asarray(x),
                             _map(cache, jnp.asarray), jnp.asarray(cache_len))
    to, tc = tmla.mla_decode(tp, tcfg, spec, torch.from_numpy(x),
                             _map(cache, lambda a: torch.from_numpy(a.copy())),
                             torch.from_numpy(cache_len))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    for n in ("c_kv", "k_pe"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), atol=ATOL)


# cache_len per row: 0 (fresh), a continuation, and rows whose C-token
# chunk runs past the W-slot window (W - 3 and W - 1)
EXTEND_CASES = {"C=6": (6, [0, 4, W - 3, W - 1]), "C=1": (1, [0, 9, W - 1]),
                "fresh": (8, [0, 0])}


@pytest.mark.parametrize("case", sorted(EXTEND_CASES))
def test_mla_extend_matches_jax(layer, case):
    jcfg, tcfg, jp, tp, spec = layer
    C, lens = EXTEND_CASES[case]
    cache_len = np.asarray(lens, np.int32)
    B = len(lens)
    x = _x(tcfg, B, C, 5)
    cache = _cache(tcfg, B, 6)
    jo, jc = JMLA["_mla_extend"](jp, jcfg, spec, jnp.asarray(x),
                                _map(cache, jnp.asarray), jnp.asarray(cache_len))
    tc = _map(cache, lambda a: torch.from_numpy(a.copy()))
    to, tc = tmla.mla_extend(tp, tcfg, spec, torch.from_numpy(x), tc,
                             torch.from_numpy(cache_len))
    for b in range(B):
        real = min(C, W - lens[b])  # query positions inside the window
        np.testing.assert_allclose(to[b, :real].numpy(), np.asarray(jo)[b, :real],
                                   atol=ATOL)
    for n in ("c_kv", "k_pe"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), atol=ATOL)


def test_mla_decode_equals_extend_at_c1(layer):
    """The absorbed form and the expanded form of one decode step, in the
    port alone: outputs within ATOL, and the same latents written."""
    _, tcfg, _, tp, spec = layer
    cache_len = torch.tensor([0, 7, 16, 23])
    x = torch.from_numpy(_x(tcfg, 4, 1, 7))
    cache = _cache(tcfg, 4, 8)
    a = _map(cache, lambda t: torch.from_numpy(t.copy()))
    b = _map(cache, lambda t: torch.from_numpy(t.copy()))
    od, a = tmla.mla_decode(tp, tcfg, spec, x, a, cache_len)
    oe, b = tmla.mla_extend(tp, tcfg, spec, x, b, cache_len)
    np.testing.assert_allclose(od.numpy(), oe.numpy(), atol=ATOL)
    for n in ("c_kv", "k_pe"):
        assert torch.equal(a[n], b[n])


def test_init_mla_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    want = jmla.init_mla_cache(jcfg, 3, W, jnp.float32)
    got = tmla.init_mla_cache(tcfg, 3, W, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
