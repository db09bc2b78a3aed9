"""The port's expert parallelism on the CPU against the JAX package.

One world of 4 ranks on (data 2, model 2) (``launch/mesh.py::spawn_ranks``,
gloo, one intra-op thread each; the rank-side work is in
``tests/_torch_sharded_train_ranks.py``, which imports no JAX) runs while
this process computes the references:

* llama4-scout's smoke config (two MoE layers, 4 experts top-1 + a shared
  one; each model rank holds 2 experts and half the shared expert's units)
  with sharded_moe + onehot_ce, 2 steps: every step's metrics and the final
  params equal JAX's single-device ``make_train_step`` with its
  ``moe_apply`` applied to each batch shard on its own, which is what the
  reference's ``_routed_manual_ep`` computes (at B=4, S=16 no token is
  dropped, as ``tests/test_distributed.py`` asserts of its forward).
* ``moe_apply`` over 2 x 4200 tokens (global T * k 8400 > 8192, each
  shard's 4200 below it) at capacity factor 1.0: with sharded_moe it is
  JAX's ``moe_apply`` of each shard on its own (nothing dropped), without
  it JAX's ``moe_apply`` of the whole batch (pairs dropped past the global
  capacity), and the two differ.

Pure FSDP over every family is held against JAX's gradients in
``tests/test_torch_train_families.py``.

Tolerances (f32): ``STEP_RTOL`` and the params' as in
``tests/test_torch_sharded_train.py``; ``MOE_ATOL`` 1e-5 on
``moe_apply``'s outputs (unit scale: the inputs are N(0, 1)) and ``rtol``
1e-5 on its aux loss.
"""
import concurrent.futures
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_sharded_train_ranks as ranks  # noqa: E402
from test_torch_sharded_train import (STEP_RTOL, _hold_metrics, _jax_steps,  # noqa: E402
                                      first_grads, hold_params)
from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MOE_ATOL = 1e-5
ARCH, STEPS, OPTIONS, _ = ranks.EP


def _moe_inputs():
    """llama4-scout's smoke MoE (its first layer's seed-0 weights) and
    N(0, 1) inputs of 2 rows x 4200 tokens."""
    cfg = tconfigs.smoke_config(ARCH)
    ff = build_model(cfg, device="cpu").init(0)["layers"][0]["ff"]
    params = {k: {n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy()
              for k, v in ff.items()}
    x = np.random.default_rng(7).standard_normal(
        (ranks.MOE_ROWS, ranks.MOE_SEQ, cfg.d_model)).astype(np.float32)
    return x, params


def _jax_moe(x, params):
    """JAX's ``moe_apply`` (no rules) per shard and over the whole batch,
    each with its count of dropped (token, slot) pairs."""
    cfg = jconfigs.smoke_config(ARCH)
    p = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def apply(p, x):
        y, aux = jmoe.moe_apply(p, cfg, x, capacity_factor=ranks.MOE_CF)
        return y, aux, jmoe.route(p, cfg, x.reshape(-1, x.shape[-1]))[1]

    out = {}
    for mode, parts in (("sharded", np.split(x, ranks.MOE_ROWS)), ("global", [x])):
        ys, auxes, dropped = [], [], 0
        for xs in parts:
            y, aux, experts = apply(p, jnp.asarray(xs))
            ys.append(np.asarray(y))
            auxes.append(float(aux))
            T = xs.shape[0] * xs.shape[1]
            cap = jmoe._capacity(T, cfg.top_k, cfg.num_experts, ranks.MOE_CF)
            counts = np.bincount(np.asarray(experts).reshape(-1), minlength=cfg.num_experts)
            dropped += int(np.maximum(counts - cap, 0).sum())
        out[mode] = (np.concatenate(ys), float(np.mean(auxes)), dropped)
    return out


@pytest.fixture(scope="module")
def runs():
    x, moe_params = _moe_inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        world = ex.submit(spawn_ranks, ranks.ep_cases, 4,
                          dict(moe_x=x, moe_params=moe_params), timeout=600)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            want = _jax_steps(ARCH, OPTIONS, STEPS)
            moe = _jax_moe(x, moe_params)
            grad0 = first_grads(ARCH, OPTIONS)
        finally:
            torch.set_num_threads(n)
        got = world.result()
    return dict(want=want, moe=moe, grad0=grad0, got4=got)


def test_ep_steps_match_jax(runs):
    """Every rank reports the per-shard JAX step's loss, ce, moe_aux and
    grad norm at every step."""
    for rank in runs["got4"]:
        _hold_metrics(rank[ARCH]["metrics"], runs["want"][0], STEP_RTOL)


def test_ep_final_params_match_jax(runs):
    """Each rank's experts, shared-expert units and other slices, gathered
    into one tree, equal the per-shard JAX step's final params."""
    hold_params(runs["got4"][0][ARCH]["params"], runs["want"][1], STEPS, runs["grad0"])


@pytest.mark.parametrize("mode", ["sharded", "global"])
def test_moe_apply_drop_regime(runs, mode):
    """moe_apply over 2 x 4200 tokens: with sharded_moe each shard's own
    dispatch (JAX's moe_apply per shard: nothing dropped), without it the
    global batch's (JAX's moe_apply of the whole batch: pairs dropped); the
    two differ."""
    y_want, aux_want, dropped = runs["moe"][mode]
    for r, rank in enumerate(runs["got4"]):
        y, aux = rank["moe"][mode]
        d = r // 2  # rank d * 2 + m holds row d
        np.testing.assert_allclose(y, y_want[d:d + 1], rtol=0, atol=MOE_ATOL)
        np.testing.assert_allclose(aux, aux_want, rtol=1e-5)
    if mode == "sharded":
        assert dropped == 0
    else:
        assert dropped > 0
        assert np.abs(y_want - runs["moe"]["sharded"][0]).max() > 1e-3
