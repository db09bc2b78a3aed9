"""The port's MoE feed-forward (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU.

The same parameters (drawn with numpy from a seed, f32) and the same tokens
go through both: the routing (weights and experts, aux loss), the dispatch
(``slot_src`` and ``keep``, exactly equal: the stable sort by expert keeps
token order, so the same pairs are dropped) and ``moe_apply``'s output
(atol 1e-5: f32 sums in another order). Covered: softmax top-1 and top-2,
sigmoid routing with a nonzero selection bias, the shared expert on and
off, SwiGLU and plain GeLU, the no-drop regime (T * k <= 8192) and the drop
regime (T * k > 8192 at d = 64, capacity factors 0.5 and 2.0), and the
port's grouped ``moe_apply`` equal to its literal dense twin
``moe_dense_ref``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe

ATOL = 1e-5  # f32, summation order only


def _cfgs(**changes):
    """The llama4 smoke config (4 experts, top-1, one shared expert, SwiGLU)
    of both packages with the same changes."""
    name = "llama4-scout-17b-a16e"
    return (dataclasses.replace(jsmoke_config(name), **changes),
            dataclasses.replace(tconfigs.smoke_config(name), **changes))


def _params(cfg, seed):
    """numpy f32 parameters in the reference's tree layout."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out1 = 2 * f if cfg.activation.endswith("_glu") else f
    p = {"router": {"w": rng.normal(size=(d, E)) / np.sqrt(d)},
         "w1": rng.normal(size=(E, d, out1)) / np.sqrt(d),
         "w2": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    if cfg.moe_sigmoid_router:
        p["router_bias"] = rng.normal(size=(E,)) * 0.5
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_w1"] = {"w": rng.normal(size=(d, out1 // f * fs)) / np.sqrt(d)}
        p["shared_w2"] = {"w": rng.normal(size=(fs, d)) / np.sqrt(fs)}
    return _map(p, lambda a: a.astype(np.float32))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _both(p):
    return _map(p, jnp.asarray), _map(p, torch.from_numpy)


CASES = {  # name: config changes
    "softmax_top1_shared": {},
    "softmax_top2_shared": dict(top_k=2),
    "softmax_top2_no_shared": dict(top_k=2, num_shared_experts=0),
    "sigmoid_bias_top2": dict(top_k=2, moe_sigmoid_router=True),
    "gelu_top1_shared": dict(activation="gelu"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_and_moe_apply_match_jax(name):
    jcfg, tcfg = _cfgs(**CASES[name])
    jp, tp = _both(_params(tcfg, 1))
    x = np.random.default_rng(2).normal(size=(3, 7, tcfg.d_model)).astype(np.float32)
    jw, je, jaux = jmoe.route(jp, jcfg, jnp.asarray(x.reshape(-1, tcfg.d_model)))
    tw, te, taux = tmoe.route(tp, tcfg, torch.from_numpy(x.reshape(-1, tcfg.d_model)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL)
    jy, jaux2 = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), capacity_factor=2.0)
    ty, taux2 = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), capacity_factor=2.0)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(taux2), float(jaux2), atol=ATOL)
    dy, _ = tmoe.moe_dense_ref(tp, tcfg, torch.from_numpy(x), capacity_factor=2.0)
    np.testing.assert_allclose(ty.numpy(), dy.numpy(), atol=ATOL)


def test_top_k_ties_take_the_lower_index():
    """``jax.lax.top_k`` order on ties: equal router scores pick the lower
    expert first, and the dispatch keeps token order inside an expert."""
    jcfg, tcfg = _cfgs(top_k=2)
    p = _params(tcfg, 3)
    p["router"]["w"][:] = 0.0  # every score equal
    jp, tp = _both(p)
    x = np.random.default_rng(4).normal(size=(5, tcfg.d_model)).astype(np.float32)
    _, je, _ = jmoe.route(jp, jcfg, jnp.asarray(x))
    _, te, _ = tmoe.route(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (te.numpy() == [0, 1]).all()


@pytest.mark.parametrize("E,k,cap", [(4, 1, 6), (4, 2, 3), (8, 2, 40), (3, 3, 1)])
def test_dispatch_indices_match_jax(E, k, cap):
    T = 37
    experts = np.stack([np.random.default_rng(E * k + cap).choice(E, size=k, replace=False)
                        for _ in range(T)]).astype(np.int32)
    js, jk = jmoe._dispatch_indices(jnp.asarray(experts), E, cap)
    ts, tk = tmoe.dispatch_indices(torch.from_numpy(experts), E, cap)
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("T,k,cf,cap", [(8192, 1, 2.0, 8192), (8193, 1, 2.0, 4097),
                                        (4097, 2, 0.5, 1025), (1, 1, 1.25, 1)])
def test_capacity_matches_jax(T, k, cf, cap):
    assert tmoe.capacity(T, k, 4, cf) == jmoe._capacity(T, k, 4, cf) == cap
    assert tmoe.NO_DROP_THRESHOLD == jmoe.NO_DROP_THRESHOLD == 8192


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_drop_regime_matches_jax(cf):
    """T * k = 8400 > 8192 token-slots at d = 64: capacity ceil(T*k/E*cf)
    per expert, so at cf 0.5 every expert drops tokens and at cf 2.0 the
    most loaded may; the same tokens are dropped on both sides."""
    jcfg, tcfg = _cfgs(d_model=64, moe_d_ff=32, top_k=2)
    jp, tp = _both(_params(tcfg, 5))
    x = np.random.default_rng(6).normal(size=(2, 2100, 64)).astype(np.float32)
    T, k, E = 4200, 2, tcfg.num_experts
    cap = tmoe.capacity(T, k, E, cf)
    assert T * k > tmoe.NO_DROP_THRESHOLD and cap == jmoe._capacity(T, k, E, cf)
    _, je, _ = jmoe.route(jp, jcfg, jnp.asarray(x.reshape(T, 64)))
    _, te, _ = tmoe.route(tp, tcfg, torch.from_numpy(x.reshape(T, 64)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    js, jk = jmoe._dispatch_indices(je, E, cap)
    ts, tk = tmoe.dispatch_indices(te, E, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    dropped = int((~tk).sum())
    assert dropped > (1000 if cf == 0.5 else -1)
    jy, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    ty, _ = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    dy, _ = tmoe.moe_dense_ref(tp, tcfg, torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), dy.numpy(), atol=ATOL)


def test_params_mirror_the_reference_tree():
    """``make_moe_params`` builds the reference's leaves with its shapes and
    dtypes (router in f32 whatever the model dtype), so the converter maps
    them with no special case."""
    import jax

    jcfg, tcfg = _cfgs(top_k=2, moe_sigmoid_router=True)
    jtree = jmoe.make_moe_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    ttree = tmoe.make_moe_params(gen, tcfg, torch.bfloat16, "cpu")

    def spec(tree):
        out = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                out.update({f"{key}.{kk}": vv for kk, vv in spec(v).items()})
            else:
                v = getattr(v, "value", v)
                out[key] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        return out
    assert spec(ttree) == spec(jtree)
    assert ttree["router"]["w"].dtype == ttree["router_bias"].dtype == torch.float32
