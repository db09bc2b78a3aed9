"""Tensor-parallel training of MLA (DeepSeek-V3, with its MoE and MTP
block) and Mamba (jamba) on the CPU against the JAX package's
single-device step.

One world of 2 ranks on (data 1, model 2) (``launch/mesh.py::spawn_ranks``,
gloo, one intra-op thread each; the rank-side work is
``tests/_torch_sharded_train_ranks.py::family_cases``, which imports no
JAX) trains each smoke config ``TP_STEPS`` steps from the port's seed-0
weights on ``SyntheticLM(seed=0)`` batches (B=4, S=16), while this process
runs JAX's ``make_train_step`` from the same weights on the same batches,
compiled at XLA's backend optimization level 0 together with JAX's
gradient of the first batch:

* every rank's ``loss``, ``ce``, ``moe_aux``, ``mtp`` and ``grad_norm`` of
  every step equal JAX's;
* the first batch's gradient, gathered into one tree (the column orders
  undone), equals JAX's leaf by leaf, and so do the final params;
* each rank holds its slices only: its parameter bytes are the sum of its
  slices' under the train rules (``rank_slice_bytes``).

deepseek-v3 cuts its MLA heads, its MLP's hidden units, its experts and
the shared expert's units, and its vocabulary (512) over the model group;
the MTP block's embedding and head are vocab-parallel and its (MoE MLA)
layer runs shard-locally. jamba cuts its Mamba channels (``in_proj`` in
its [x ; z] order), its experts and its attention heads.

Tolerances (f32), as ``tests/test_torch_sharded_train.py`` holds the
dense families: ``STEP_RTOL`` 1e-4 on each step's metrics. The first
step's gradient: each entry within ``STEP_RTOL`` of its leaf's largest,
those at most ``NOISE_GRAD`` 1e-5 of the tree's largest within
``NOISE_GRAD`` of it (an f32 gradient entry is known to about 1e-7 of the
largest). The final params, against the port's one-process run of the
same steps (``port_family``: what splitting the sums over the ranks
changes): each entry within ``STEP_RTOL`` of its leaf's largest, those
whose first-step gradient is at most ``NOISE_GRAD`` of the largest within
the sum of the steps' learning rates (``hold_final``). Against JAX's
final params the same, with one more set of entries held within the
learning rates: those whose first-step gradients, the port's one process
against JAX's, differ by more than ``STEP_RTOL`` of the entry itself.
AdamW moves each entry by about lr times its gradient's sign, so such an
entry's step is known no better than its gradient: on a leaf that starts
at zero (xlstm's ``conv_b`` and norm biases, whose largest entry after two
steps is ~2e-3) the one-process port already parts from JAX by up to 6e-4
of the leaf's largest there; every other entry is held at ``STEP_RTOL``.
"""
import concurrent.futures
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_sharded_train_ranks as ranks  # noqa: E402
from test_torch_sharded_train import NOISE_GRAD, STEP_RTOL, _hold_metrics  # noqa: E402
from test_torch_train_families import _to_jax_values  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.models.model import param_axes, param_shapes  # noqa: E402
from repro_torch.sharding.rules import mode_rules  # noqa: E402
from repro_torch.train.loop import grads_of, init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ARCHS = ranks.MLA_ARCHS


def jax_family(arch, steps=ranks.TP_STEPS):
    """JAX's single-device run from the port's seed-0 weights on the
    ranks' batches: (per-step metrics, the final params and the first
    batch's gradient, both in the port's layout). One compile, at XLA's
    backend optimization level 0, of JAX's ``make_train_step`` that also
    hands out the gradient its ``jax.value_and_grad`` computes (before the
    clip)."""
    cfg = tconfigs.smoke_config(arch)
    values = _to_jax_values(cfg, build_model(cfg, device="cpu").init(0))
    jm = jbuild(jconfigs.smoke_config(arch))
    step = jloop.make_train_step(jm, **ranks.STEP)
    value_and_grad = jax.value_and_grad

    def grads_and_step(state, batch):
        seen = []

        def spy(fn, **kw):
            inner = value_and_grad(fn, **kw)

            def call(*args):
                out = inner(*args)
                seen.append(out[1])
                return out
            return call
        with mock.patch.object(jax, "value_and_grad", spy):
            new_state, metrics = step(state, batch)
        return seen[0], new_state, metrics

    state = jloop.TrainState(values, joptim.adamw_init(values), jnp.zeros((), jnp.int32))
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in ranks.synthetic_batches(cfg, steps)]
    fn = jax.jit(grads_and_step).lower(state, batches[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    metrics, grad0 = [], None
    for b in batches:
        grads, state, m = fn(state, b)
        grad0 = grads if grad0 is None else grad0
        metrics.append({k: float(v) for k, v in m.items()})
    return (metrics, convert_params(cfg, jax.device_get(state.params)),
            {p: np.asarray(g) for p, g in tree_paths(convert_params(
                cfg, jax.device_get(grad0)))})


def port_family(arch, steps=ranks.TP_STEPS):
    """The port's one-process run of the ranks' steps: (final params, the
    first batch's gradient), numpy by path."""
    cfg = tconfigs.smoke_config(arch)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in ranks.synthetic_batches(cfg, steps)]
    grads, _ = grads_of(model, state.params, batches[0])
    step = make_train_step(model, **ranks.STEP)
    for b in batches:
        state, _ = step(state, b)
    return state.params, {p: g.numpy() for p, g in tree_paths(grads)}


def rank_slice_bytes(arch, shape):
    """What a rank of ``shape`` must hold of the smoke config's parameters:
    each leaf's elements over the product of the mesh axes its train
    pspec cuts, times its element size (f32)."""
    cfg = tconfigs.smoke_config(arch)
    rules = mode_rules(shape, "train", ranks.B)

    def walk(axes, shapes):
        if isinstance(axes, dict):
            return sum(walk(axes[k], shapes[k]) for k in axes)
        if isinstance(axes, list):
            return sum(walk(a, s) for a, s in zip(axes, shapes, strict=True))
        cut = 1
        for part in rules.pspec(axes, shapes):
            for a in () if part is None else ((part,) if isinstance(part, str) else part):
                cut *= shape[a]
        return int(np.prod(shapes)) // cut * 4
    return walk(param_axes(cfg), param_shapes(cfg))


def references(archs):
    """{arch: (JAX's run, the port's one-process run)}."""
    return {arch: (jax_family(arch), port_family(arch)) for arch in archs}


def hold_grads(got, want):
    """The gathered first-step gradient against JAX's, leaf by leaf (see
    the module docstring)."""
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        err = np.abs(g - w)
        noise = np.abs(w) <= NOISE_GRAD * top
        assert err[~noise].max(initial=0.0) <= STEP_RTOL * np.abs(w).max(), (
            path, err[~noise].max() / np.abs(w).max())
        assert err[noise].max(initial=0.0) <= NOISE_GRAD * top, (path, err[noise].max())


def hold_final(got, want, noise):
    """The gathered final params against ``want``: each entry within
    ``STEP_RTOL`` of its leaf's largest, the ``noise`` entries within the
    steps' summed learning rates."""
    got = dict(tree_paths(got))
    want = {p: np.asarray(w) for p, w in tree_paths(want)}
    assert sorted(got) == sorted(want) == sorted(noise)
    lr_sum = ranks.STEP["base_lr"] * ranks.TP_STEPS
    for path, w in want.items():
        err = np.abs(got[path] - w)
        assert got[path].shape == w.shape, path
        assert err[~noise[path]].max(initial=0.0) <= STEP_RTOL * np.abs(w).max(), (
            path, err[~noise[path]].max() / np.abs(w).max())
        assert err[noise[path]].max(initial=0.0) <= lr_sum, (path, err[noise[path]].max())


def hold_family(got_ranks, refs, arch, shape):
    """Every rank's metrics and the gathered first-step gradient against
    JAX's, the gathered final params against the port's one process and
    JAX's (see the module docstring); each rank's parameter bytes against
    its slices'."""
    (metrics, params, grad0), (one_params, one_grad0) = refs
    for rank in got_ranks:
        _hold_metrics(rank[arch]["metrics"], metrics, STEP_RTOL)
        assert rank[arch]["param_bytes"] == rank_slice_bytes(arch, shape), rank[arch]
    hold_grads(dict(tree_paths(got_ranks[0][arch]["grad0"])), grad0)
    got = got_ranks[0][arch]["params"]
    top = max(np.abs(g).max() for g in one_grad0.values())
    small = {p: np.abs(g) <= NOISE_GRAD * top for p, g in one_grad0.items()}
    hold_final(got, one_params, small)
    hold_final(got, params, {p: small[p] | (np.abs(one_grad0[p] - g) > STEP_RTOL * np.abs(g))
                             for p, g in grad0.items()})


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        world = ex.submit(spawn_ranks, ranks.family_cases, 2, ARCHS, timeout=600)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            want = references(ARCHS)
        finally:
            torch.set_num_threads(n)
        got = world.result()
    return dict(got=got, want=want)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_matches_jax(runs, arch):
    """(data 1, model 2): every step's metrics (deepseek-v3's ``mtp`` and
    ``moe_aux`` among them), the first step's gradient and the final params
    equal JAX's single-device step; each rank holds its slices only."""
    hold_family(runs["got"], runs["want"][arch], arch, ranks.TP_MESH)


def test_tp_family_ranks_import_no_jax(runs):
    """The ranks' processes hold neither JAX nor the JAX package."""
    for rank in runs["got"]:
        assert rank["modules"] == []
