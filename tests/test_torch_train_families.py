"""The port's training forward, loss and gradients vs the JAX package's,
for every config of the registry, on the CPU.

Each smoke config (2 layers, f32) with the port's init from seed 0,
stacked into JAX's layout (``_to_jax_values``, the inverse of
``convert_params``, whose round trip is checked too), on one
batch of B=2 and S=16 drawn as ``tests/test_archs.py::_batch`` draws it
(image rows and audio frames included) with random labels over the text:
``Model.forward``'s logits and its aux (``moe_aux``; DeepSeek-V3's
``mtp_logits``) equal JAX's ``forward``; ``loss_fn``'s loss and metrics
equal JAX's; and the gradients, JAX's passed through ``convert_params``
like the params, equal leaf by leaf. One JAX ``value_and_grad`` per
config gives all three; it is computed once and shared by the three tests.
One intra-op thread; this file takes ~60 s, nearly all of it the compile
of JAX's gradient (at XLA's backend optimization level 0).

The sharded train step's pure FSDP (data 2, model 1) is held against the
same JAX gradients: a world of 2 ranks (``launch/mesh.py::spawn_ranks``,
gloo; the rank-side work, ``tests/_torch_sharded_train_ranks.py::fsdp_grads``,
imports no JAX) runs ``grads_of`` on each rank's row of the same batch from
the same weights, every leaf cut over data gathered where it is used (the
encoder, the MTP block, the embedding and head included), while this
process compiles JAX's gradients; both ranks' metrics, the step's clip
norm and the gradient slices gathered into one tree are held at the
tolerances below (the norm at ``GRAD_RTOL``).

Tolerances (f32 throughout, XLA vs PyTorch summation order):
  * ``ATOL`` 1e-4 on logits and ``mtp_logits`` (measured <= 2.1e-5);
  * ``LOSS_RTOL`` 1e-5 on the loss and each metric (measured <= 1.6e-7);
  * ``GRAD_RTOL`` 2e-4 on each gradient leaf, against the larger of the
    leaf's largest JAX entry and 1e-3 of the tree's largest (measured <=
    3e-5, Jamba's Mamba scan; a key bias's entries on its slowest RoPE
    pairs, where a shift shared by a row barely changes the logits, are
    near 0 on both sides).
"""
import concurrent.futures
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.train.loop import loss_fn as jloss_fn  # noqa: E402

import _torch_sharded_train_ranks as ranks  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.train.loop import grads_of, loss_fn  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def fsdp_world():
    """The FSDP ranks' results (a future), started with the module so they
    run while JAX compiles."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        yield ex.submit(spawn_ranks, ranks.fsdp_grads, 2, jconfigs.ARCHS, timeout=600)


def _batch(cfg, rng, B=2, S=16):
    """``tests/test_archs.py::_batch`` with labels over the text."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (0.1 * rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = (0.1 * rng.normal(
            size=(B, cfg.n_audio_ctx, cfg.d_model))).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return batch


def _stack(layers):
    """A stage's per-layer trees (one repeat each) -> one tree of (R, ...)
    numpy leaves, the JAX package's stacked layout."""
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack([t.numpy() for t in layers])


def _to_jax_values(cfg, params):
    """The inverse of ``convert_params``: the port's weights as the value
    tree of the JAX package's model (each stage's repeats stacked)."""
    as_np = lambda t: {k: as_np(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.numpy()  # noqa: E731
    out = {k: as_np(params[k]) for k in ("embed", "final_norm", "lm_head", "pos_embed",
                                         "mtp") if k in params}
    stages, i = [], 0
    for pattern, reps in cfg.stages:
        n = len(pattern)
        layers = params["layers"][i:i + n * reps]
        stages.append({f"l{j}": _stack(layers[j::n]) for j in range(n)})
        i += n * reps
    out["stages"] = tuple(stages)
    if "encoder" in params:
        out["encoder"] = {"stages": ({"l0": _stack(params["encoder"]["layers"])},),
                          "final_norm": as_np(params["encoder"]["final_norm"])}
    return out


_CACHE = {}


def _run(arch):
    """JAX's and the port's (logits, aux, metrics, gradients) on one batch,
    from the same weights; computed once per config."""
    if arch not in _CACHE:
        jm = jbuild_model(jconfigs.smoke_config(arch))
        tm = build_model(tconfigs.smoke_config(arch), device="cpu")
        params = tm.init(0, max_seq=64)
        values = _to_jax_values(tm.cfg, params)
        batch = _batch(tm.cfg, np.random.default_rng(0))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_with_outputs(p):
            # JAX's loss_fn on a model whose forward also hands its outputs
            # out: one forward in the compiled gradient
            outs = []

            def forward(*args):
                outs.append(jm.forward(*args))
                return outs[0]

            loss, metrics = jloss_fn(types.SimpleNamespace(cfg=jm.cfg, forward=forward),
                                     p, jb)
            return loss, (metrics, outs[0])

        # compiled at XLA's backend optimization level 0: one run, whose
        # compile the optimizer's passes would lengthen by half
        (_, (jmetrics, (jlogits, jaux))), jgrads = jax.jit(
            jax.value_and_grad(loss_with_outputs, has_aux=True)).lower(values).compile(
                compiler_options={"xla_backend_optimization_level": 0})(values)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            logits, aux = tm.forward(params, tb)
            _, metrics = loss_fn(tm, params, tb)
        grads, _ = grads_of(tm, params, tb)
        _CACHE[arch] = dict(
            jax=(np.asarray(jlogits), jax.device_get(jaux), jax.device_get(jmetrics),
                 convert_params(tm.cfg, jax.device_get(jgrads))),
            port=(logits, aux, metrics, grads), cfg=tm.cfg)
    return _CACHE[arch]


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_forward_matches_jax(arch):
    r = _run(arch)
    (jlogits, jaux, _, _), (logits, aux, _, _) = r["jax"], r["port"]
    cfg = r["cfg"]
    S = 16 + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
    assert logits.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=ATOL)
    assert sorted(aux) == sorted(jaux)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=LOSS_RTOL)
    if cfg.num_experts:
        assert float(aux["moe_aux"]) > 0
    if cfg.mtp_depth:
        assert aux["mtp_logits"].shape == (2, 15, cfg.vocab_size)
        np.testing.assert_allclose(aux["mtp_logits"].numpy(),
                                   np.asarray(jaux["mtp_logits"]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_loss_matches_jax(arch):
    r = _run(arch)
    jmetrics, metrics = r["jax"][2], r["port"][2]
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        assert np.isfinite(float(metrics[k])), k
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def _hold_grads(leaves, jleaves):
    """Each gradient leaf against JAX's, at ``GRAD_RTOL`` of the larger of
    the leaf's largest JAX entry and 1e-3 of the tree's largest."""
    assert sorted(leaves) == sorted(jleaves)
    top = max(np.abs(g.numpy()).max() for g in jleaves.values())
    assert top > 0
    for path, g in leaves.items():
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        jg = jleaves[path].numpy()
        assert g.shape == jg.shape and g.dtype == np.float32, path
        floor = max(np.abs(jg).max(), 1e-3 * top)
        err = np.abs(g - jg).max() / floor
        assert err <= GRAD_RTOL, (path, err)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_grads_match_jax(arch):
    r = _run(arch)
    jgrads, grads = r["jax"][3], r["port"][3]
    # by path: jax.tree rebuilds its dicts in sorted key order
    _hold_grads(dict(tree_paths(grads)), dict(tree_paths(jgrads)))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_fsdp_grads_match_jax(fsdp_world, arch):
    """Pure FSDP on (data 2, model 1): on both ranks the loss and metrics
    equal JAX's, the train step's clip norm equals the norm of JAX's
    gradient, and the gradient slices, gathered into one tree, equal
    JAX's leaf by leaf."""
    r = _run(arch)
    want = _batch(r["cfg"], np.random.default_rng(0))
    assert all(np.array_equal(v, want[k]) for k, v in ranks.smoke_batch(r["cfg"]).items())
    jmetrics, jgrads = r["jax"][2], dict(tree_paths(r["jax"][3]))
    norm = np.sqrt(sum(np.sum(np.square(g.numpy().astype(np.float64)))
                       for g in jgrads.values()))
    for rank in fsdp_world.result():
        got = rank[arch]
        assert sorted(got["metrics"]) == sorted(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(got["metrics"][k], float(jmetrics[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=GRAD_RTOL)
        _hold_grads(dict(tree_paths(got["grads"])), jgrads)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_weights_round_trip_through_jax_layout(arch):
    """``convert_params`` undoes ``_to_jax_values`` leaf for leaf, the MTP
    block included, and ``_to_jax_values`` gives the JAX model's tree: its
    structure, shapes and dtypes."""
    tm = build_model(tconfigs.smoke_config(arch), device="cpu")
    params = tm.init(0, max_seq=64)
    back = convert_params(tm.cfg, _to_jax_values(tm.cfg, params))
    got, want = dict(tree_paths(back)), dict(tree_paths(params))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[p], want[p]) for p in want)
    jm = jbuild_model(jconfigs.smoke_config(arch))
    want = split_params(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), max_seq=64)))[0]
    values = _to_jax_values(tm.cfg, params)
    assert jax.tree.structure(values) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(values)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(want)]
