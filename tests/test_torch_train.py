"""The port's training pieces vs the JAX package's, on the CPU: the
schedule, clipping, AdamW, the cross-entropy, the synthetic data, and
olmo-1b's smoke config trained five steps from JAX's init.

Tolerances: ``OPT_ATOL`` 1e-6 for the schedule, the clip and AdamW on
seeded f32 trees of unit scale (both compute every step in f32; they
differ in the last ulp at most, measured <= 1.2e-7); ``CE_RTOL`` 1e-6
for the f32 cross-entropy; olmo-1b's five steps ``TRAIN_RTOL`` 1e-4 on
``ce``, ``grad_norm`` and ``lr`` per step and on the final params, each
leaf against its largest entry (f32 XLA vs PyTorch summation order
through two layers, then five AdamW steps of lr <= 1e-3). The port alone
trains 25 steps with a falling loss, as ``tests/test_train.py`` checks
JAX's. One intra-op thread; ~15 s.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.common import split_params  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,  # noqa: E402
                               cosine_schedule)
from repro_torch.train.loop import (TrainState, cross_entropy, init_train_state,  # noqa: E402
                                    make_train_step)
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

OPT_ATOL = 1e-6
CE_RTOL = 1e-6
TRAIN_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    """A seeded numpy tree shaped like the port's params: a dict with a
    list of layer dicts, a 0-d leaf among them (keys in sorted order, the
    order of the dicts ``jax.tree`` rebuilds)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    return {"embed": f(11, 6), "layers": [{"b": f(6), "w": f(6, 6)}, {"w": f(6, 3)}],
            "scale": f()}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _assert_trees_close(got, want, atol):
    for (p, g), (q, w) in zip(tree_paths(got), tree_paths(_as_torch(jax.device_get(want)))):
        assert p == q
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol, err_msg=p)


def test_cosine_schedule_matches_jax():
    kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in list(range(0, 121, 3)) + [torch.tensor(55, dtype=torch.int32)]:
        got = cosine_schedule(step, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = joptim.cosine_schedule(jnp.asarray(int(step)), **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=OPT_ATOL)
    assert float(cosine_schedule(0, **kw)) == 0.0


@pytest.mark.parametrize("scale", [10.0, 0.01])  # clipped, and left as it is
def test_clip_by_global_norm_matches_jax(scale):
    tree = _tree(1, scale)
    got, gnorm = clip_by_global_norm(_as_torch(tree), 1.0)
    want, jnorm = joptim.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    _assert_trees_close(got, want, OPT_ATOL)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(got)))
    assert float(norm) <= 1.0 + 1e-6


def test_adamw_update_matches_jax():
    """Three AdamW steps on one seeded tree of params and three seeded
    gradient trees, at the schedule's lr: params, moments and count."""
    params, jparams = _as_torch(_tree(2)), _tree(2)
    opt, jopt = adamw_init(params), joptim.adamw_init(jparams)
    for i in range(3):
        grads = _tree(10 + i)
        lr = cosine_schedule(i + 1, base_lr=1e-2, warmup_steps=2, total_steps=10)
        params, opt = adamw_update(params, _as_torch(grads), opt, lr=lr)
        jparams, jopt = joptim.adamw_update(
            jparams, grads, jopt,
            lr=joptim.cosine_schedule(i + 1, base_lr=1e-2, warmup_steps=2, total_steps=10))
    _assert_trees_close(params, jparams, OPT_ATOL)
    _assert_trees_close(opt["mu"], jopt["mu"], OPT_ATOL)
    _assert_trees_close(opt["nu"], jopt["nu"], OPT_ATOL)
    assert int(opt["count"]) == int(jopt["count"]) == 3


def test_adamw_keeps_bf16_params_with_f32_moments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw_init(p)
    new, opt2 = adamw_update(p, {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, opt,
                             lr=1e-2)
    assert new["w"].dtype == torch.bfloat16 and opt2["mu"]["w"].dtype == torch.float32
    assert torch.all(new["w"] < 1) and torch.equal(p["w"], torch.ones(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (3 * rng.normal(size=(2, 7, 19))).astype(np.float32)
    labels = rng.integers(0, 19, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    want = jloop.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=CE_RTOL)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_batches_byte_equal(seed):
    kw = dict(vocab_size=1000, seq_len=48, seed=seed, shared_prefix_len=8 * (seed % 2))
    got = list(tdata.make_batches(tdata.SyntheticLM(**kw), 3, 4))
    want = list(jdata.make_batches(jdata.SyntheticLM(**kw), 3, 4))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()
    tok, jtok = tdata.ByteTokenizer(), jdata.ByteTokenizer()
    assert tok.encode("héllo") == jtok.encode("héllo") and tok.vocab_size == jtok.vocab_size
    assert tok.decode(tok.encode("héllo")) == "héllo"


def test_olmo_train_steps_match_jax():
    """Five train steps of the olmo-1b smoke config from JAX's init on
    ``SyntheticLM`` batches (B=4, S=32): ``ce``, ``grad_norm`` and ``lr``
    of every step, and the final params, equal JAX's."""
    arch = "olmo-1b"
    jm = jbuild_model(jconfigs.smoke_config(arch))
    values = split_params(jm.init(jax.random.PRNGKey(0), max_seq=32))[0]
    kw = dict(base_lr=1e-3, warmup_steps=2, total_steps=10)
    jstate = jloop.TrainState(values, joptim.adamw_init(values), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jloop.make_train_step(jm, **kw))
    tm = build_model(tconfigs.smoke_config(arch), device="cpu")
    params = convert_params(tm.cfg, jax.device_get(values))
    state = TrainState(params, adamw_init(params), 0)
    step = make_train_step(tm, **kw)
    batches = list(tdata.make_batches(tdata.SyntheticLM(tm.cfg.vocab_size, 32, seed=0), 4, 5))
    for b in batches:
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("ce", "grad_norm", "lr", "loss"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=TRAIN_RTOL, err_msg=k)
    assert state.step == int(jstate.step) == 5
    want = convert_params(tm.cfg, jax.device_get(jstate.params))
    for (p, g), (_, w) in zip(tree_paths(state.params), tree_paths(want)):
        w = w.numpy()
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TRAIN_RTOL, (p, err)


def test_loss_decreases_dense():
    """The port's twin of ``tests/test_train.py::test_loss_decreases_dense``."""
    cfg = tconfigs.smoke_config("olmo-1b")
    m = build_model(cfg, device="cpu")
    state = init_train_state(m, 0)
    step = make_train_step(m, base_lr=1e-3, warmup_steps=5, total_steps=60)
    ds = tdata.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
    losses = []
    for _ in range(25):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in ds.batch(8).items()})
        losses.append(float(metrics["ce"]))
    assert losses[-1] < losses[0] * 0.8
    assert state.step == 25


def test_moe_aux_and_mtp_in_loss():
    """The port's twin of ``tests/test_train.py::test_moe_aux_and_mtp_in_loss``:
    a DeepSeek-V3 step reports a finite MoE aux loss and MTP loss and
    moves the MTP block's weights."""
    cfg = tconfigs.smoke_config("deepseek-v3-671b")
    m = build_model(cfg, device="cpu")
    state = init_train_state(m, 0)
    step = make_train_step(m, base_lr=1e-4, warmup_steps=2, total_steps=10)
    b = tdata.SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=0).batch(4)
    state2, metrics = step(TrainState(state.params, state.opt, 1),
                           {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(metrics["moe_aux"])) and np.isfinite(float(metrics["mtp"]))
    assert not torch.equal(state2.params["mtp"]["proj"]["w"], state.params["mtp"]["proj"]["w"])
