"""The port's Mamba mixer (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``) on the CPU.

The same parameters (JAX's ``make_mamba_params`` at the jamba-v0.1-52b
smoke width, f32, converted to tensors) and the same numpy-seeded inputs
go through both: a whole sequence from an empty history, and the same
sequence fed in chunks (8 tokens from nothing, then 1 token, which JAX
takes through its single-step branch, then the rest from the carried
state), and decode steps of one token each. Outputs and the carried conv window and SSM state agree within
``ATOL`` (f32, sums in another order); in the port alone the chunks equal
the whole sequence, as in ``tests/test_recurrent.py``. ``convert_params``
puts the Mamba layer's tree where the model reads it, ``A_log`` and ``D``
in f32 beside bf16 weights.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ATOL = 1e-5  # f32, summation order only
NAME = "jamba-v0.1-52b"
B, S = 2, 24
CHUNKS = ((0, 8), (8, 9), (9, 24))  # from nothing, one step, the scan from state


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.fixture(scope="module")
def setup():
    cfg = jsmoke_config(NAME)
    jp, _ = split_params(jmamba.make_mamba_params(jax.random.PRNGKey(3), cfg,
                                                  jnp.float32))
    x = (0.5 * np.random.default_rng(0).normal(size=(B, S, cfg.d_model))
         ).astype(np.float32)
    return cfg, jp, _t(jp), x


def _jax_chunks(jp, cfg, x):
    st = jmamba.init_mamba_cache(cfg, B, jnp.float32)
    conv, ssm = st["conv"], st["ssm"]
    outs = []
    for lo, hi in CHUNKS:
        y, (conv, ssm) = jmamba.mamba_forward(jp, cfg, jnp.asarray(x[:, lo:hi]),
                                              conv_state=conv, ssm_state=ssm,
                                              return_state=True)
        outs.append(np.asarray(y))
    return np.concatenate(outs, 1), np.asarray(conv), np.asarray(ssm)


def _port_chunks(tp, cfg, x):
    st = tmamba.init_mamba_cache(cfg, B, torch.float32, "cpu")
    conv, ssm = st["conv"], st["ssm"]
    outs = []
    for lo, hi in CHUNKS:
        y, (conv, ssm) = tmamba.mamba_forward(tp, cfg, torch.from_numpy(x[:, lo:hi]),
                                              conv_state=conv, ssm_state=ssm)
        outs.append(y)
    return torch.cat(outs, 1).numpy(), conv.numpy(), ssm.numpy()


def test_params_shapes_and_dtypes(setup):
    cfg, jp, tp, _ = setup
    mine = tmamba.make_mamba_params(torch.Generator().manual_seed(0), cfg,
                                    torch.bfloat16, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(1 for v in mine.values()
                            for _ in (v.values() if isinstance(v, dict) else [v]))
    for path, leaf in flat:
        t = mine
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert t.dtype == (torch.float32 if path[0].key in ("A_log", "D")
                           else torch.bfloat16)
    torch.testing.assert_close(mine["A_log"], tp["A_log"])  # the S4D-real init
    assert torch.equal(mine["D"], torch.ones_like(mine["D"]))


def test_forward_matches_jax(setup):
    cfg, jp, tp, x = setup
    jy, (jconv, jssm) = jmamba.mamba_forward(jp, cfg, jnp.asarray(x), return_state=True)
    ty, (tconv, tssm) = tmamba.mamba_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), atol=ATOL)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), atol=ATOL)
    assert tssm.dtype == torch.float32


def test_chunked_continuation_matches_jax(setup):
    """Chunks of 8, 1 (JAX's single-step branch) and 15 from the carried
    state: outputs and the final conv window and SSM state equal JAX's, and
    the chunks equal the whole sequence."""
    cfg, jp, tp, x = setup
    want = _jax_chunks(jp, cfg, x)
    got = _port_chunks(tp, cfg, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    full, _ = tmamba.mamba_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got[0], full.numpy(), atol=1e-4)


def test_decode_steps_match_jax_single_step_branch(setup):
    """Eight prompt tokens, then one token at a time on the carried state:
    JAX takes its single-step branch for each, the port its one scan; each
    step's output and the conv window and SSM state after it agree."""
    cfg, jp, tp, x = setup
    jy, (jconv, jssm) = jmamba.mamba_forward(jp, cfg, jnp.asarray(x[:, :8]),
                                             return_state=True)
    ty, (tconv, tssm) = tmamba.mamba_forward(tp, cfg, torch.from_numpy(x[:, :8]))
    for t in range(8, 12):
        jy, (jconv, jssm) = jmamba.mamba_forward(
            jp, cfg, jnp.asarray(x[:, t:t + 1]), conv_state=jconv, ssm_state=jssm,
            return_state=True)
        ty, (tconv, tssm) = tmamba.mamba_forward(
            tp, cfg, torch.from_numpy(x[:, t:t + 1]), conv_state=tconv, ssm_state=tssm)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), atol=ATOL)
        np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), atol=ATOL)


def test_convert_params_places_the_mamba_layer():
    """The whole smoke model's JAX tree through ``convert_params``, its
    weights cast to bf16 but ``A_log`` and ``D`` (f32 in JAX's init at any
    param dtype): the Mamba layer's tree lands where the model reads it,
    every leaf in its own dtype."""
    _, _, values = bcommon.small_model(NAME)
    values = _to_bf16(values)
    tcfg = dataclasses.replace(tconfigs.smoke_config(NAME), dtype="bfloat16",
                               param_dtype="bfloat16")
    params = convert_params(tcfg, values)
    layer = params["layers"][0]
    assert tcfg.layer_specs()[0].mixer == "mamba"
    assert layer["mixer"]["A_log"].dtype == layer["mixer"]["D"].dtype == torch.float32
    assert layer["mixer"]["in_proj"]["w"].dtype == torch.bfloat16
    assert set(layer["mixer"]["dt_proj"]) == {"w", "b"}
    np.testing.assert_array_equal(
        layer["mixer"]["A_log"].numpy(),
        np.asarray(values["stages"][0]["l0"]["mixer"]["A_log"])[0])
    mine = build_model(tcfg, device="cpu").init(0)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda a: 0, mine["layers"][0])) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, layer))
    # the Mamba tree leaf by leaf in the dtypes the port's own init gives
    assert all(a.dtype == b.dtype for a, b in zip(
        jax.tree.leaves(mine["layers"][0]["mixer"]), jax.tree.leaves(layer["mixer"])))


def _to_bf16(tree, key=None):
    if isinstance(tree, dict):
        return {k: _to_bf16(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_bf16(v) for v in tree)
    a = np.asarray(tree)
    return a if key in ("A_log", "D") else a.astype(jnp.bfloat16)
