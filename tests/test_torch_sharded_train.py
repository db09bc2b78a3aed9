"""The port's sharded train step vs the JAX package's single-device step, on
the CPU: the dense families (FSDP and tensor parallelism).

The reference trains under ``mode_rules(mesh, "train", batch)`` and XLA
places its collectives; the port runs one process per rank
(``launch/mesh.py::spawn_ranks``, gloo, one intra-op thread each; the
rank-side work is in ``tests/_torch_sharded_train_ranks.py``, which imports
no JAX) with the collectives written out (``train/sharding.py``). One world
of 4 ranks runs the meshes (data 2, model 2) and (pod 2, data 1, model 2)
while this process computes the references:

* olmo-1b and qwen2.5-32b (GQA, qkv biases) 3 steps on (2, 2): every
  step's ``loss``, ``ce`` and ``grad_norm`` equal JAX's single-device
  ``make_train_step`` from the same weights (the port's seed-0 init in
  JAX's layout) on the same ``SyntheticLM(seed=0)`` batches, and so do the
  final params, gathered into one tree; olmo-1b's first step again over
  the pod mesh. Each leaf cut over data is gathered where it is used and
  its gradient reduce-scattered once (ZeRO-3).
* gemma-2b (MQA: each model rank keeps the one KV head whole, projected
  from x and entering the rank's heads through ``copy_to_model``) 1 step
  with onehot_ce, held as the two above.
* A checkpoint saved through the (2, 2) mesh is the one-process save of
  the same params, and restores onto the mesh.
* ``python -m repro_torch.launch.train --dp 2 --tp 2`` prints the
  one-process run's ce (B=4, S=32).

Expert parallelism is in ``tests/test_torch_sharded_train_ep.py`` (the two
files split the JAX compiles between test workers); pure FSDP over every
family, its gradients against JAX's, in
``tests/test_torch_train_families.py``. JAX's steps are compiled at XLA's
backend optimization level 0 (``jax_compiled``): a third less compile.

Tolerances (f32 throughout): ``STEP_RTOL`` 1e-4 on each step's metrics
against JAX's and on each final param leaf against its largest entry, as
``tests/test_torch_train.py`` holds one device (XLA vs PyTorch summation
order, then AdamW). The few entries whose first-step gradient is at most
``NOISE_GRAD`` 1e-5 of the largest entry are held within the sum of the
steps' learning rates instead: an f32 gradient entry is known to about
1e-7 of the largest (``tests/test_torch_train_families.py`` holds JAX's to
2e-7), so such an entry only to a few percent, and AdamW's normalized step
turns that into a difference of up to lr a step. They are a key bias's
entries on its slowest RoPE pairs, where a shift shared by a row barely
changes the logits (qwen2.5-32b's smoke gradients there read 5e-9 to 5e-6
of the largest; the entries above 1e-5 are within 0.15 of ``STEP_RTOL``'s
bound). Which entries those are is read off the port's one-process
gradient of the first batch, which that file holds against JAX's.
"""
import concurrent.futures
import contextlib
import os
import re
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_sharded_train_ranks as ranks  # noqa: E402
from test_torch_train_families import _to_jax_values  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jdebug_mesh  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding import Rules as JRules  # noqa: E402
from repro.sharding import use_rules as juse_rules  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.train import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.sharding.rules import Rules as PortRules  # noqa: E402
from repro_torch.sharding.rules import use_rules as use_port_rules  # noqa: E402
from repro_torch.train.loop import grads_of  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

STEP_RTOL = 1e-4
NOISE_GRAD = 1e-5
JAX_HELD = [(arch, steps, options) for arch, steps, options, whole in ranks.DENSE if whole]
CLI = ["--debug", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32"]


def _per_shard_moe(shards):
    """JAX's ``moe_apply`` of each batch shard on its own, the aux loss their
    mean: the reference's ``_routed_manual_ep`` without a mesh."""
    apply = jmoe.moe_apply

    def per_shard(p, cfg, x, *, capacity_factor=1.25):
        outs = [apply(p, cfg, xs, capacity_factor=capacity_factor)
                for xs in jnp.split(x, shards, axis=0)]
        return jnp.concatenate([y for y, _ in outs], 0), sum(a for _, a in outs) / shards
    return per_shard


def _jax_steps(arch, options, steps):
    """JAX's single-device steps from the port's seed-0 weights: per-step
    metrics and the final params in the port's layout. Under sharded_moe
    each MoE layer is ``_per_shard_moe`` over the mesh's 2 batch shards."""
    cfg = tconfigs.smoke_config(arch)
    values = _to_jax_values(cfg, build_model(cfg, device="cpu").init(0))
    jm = jbuild(jconfigs.smoke_config(arch))
    state = jloop.TrainState(values, joptim.adamw_init(values), jnp.zeros((), jnp.int32))
    ds = jdata.SyntheticLM(cfg.vocab_size, ranks.S, seed=0)
    mesh = jdebug_mesh()
    rules = JRules(mesh, options={k: v for k, v in options.items() if k == "onehot_ce"})
    patch = mock.patch.object(jmoe, "moe_apply", _per_shard_moe(2)) \
        if options.get("sharded_moe") else contextlib.nullcontext()
    metrics = []
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in jdata.make_batches(ds, ranks.B, steps)]
    with mesh, juse_rules(rules), patch:
        step = jax_compiled(jloop.make_train_step(jm, **ranks.STEP), state, batches[0])
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, convert_params(cfg, jax.device_get(state.params))


def jax_compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's backend optimization
    level 0: a reference run for a few smoke steps, whose compile the
    optimizer's passes would lengthen by half."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _ce_lines(text):
    return re.findall(r"step +\d+ ce=[0-9.]+", text)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded_ckpt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"), os.environ.get("PYTHONPATH", "")]))
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *CLI, "--dp", "2",
                            "--tp", "2", "--dist-backend", "gloo"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        world = ex.submit(spawn_ranks, ranks.dense_cases, 4, tmp, timeout=600)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            want = {arch: _jax_steps(arch, options, steps) for arch, steps, options in JAX_HELD}
            grad0 = {arch: first_grads(arch, options) for arch, _, options in JAX_HELD}
            cfg = tconfigs.smoke_config("olmo-1b")
            save_checkpoint(os.path.join(tmp, "single.npz"),
                            build_model(cfg, device="cpu").init(0), step=3)
            lines = []
            port_train(cfg, steps=2, batch=4, seq=32, device="cpu", log=lines.append)
        finally:
            torch.set_num_threads(n)
        got = world.result()
    out, _ = cli.communicate(timeout=600)
    return dict(want=want, grad0=grad0, got=got, tmp=tmp,
                cli=(cli.returncode, out), cli_want="\n".join(lines))


def _hold_metrics(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "ce", "grad_norm", "moe_aux", "mtp"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("arch", [a for a, _, _ in JAX_HELD])
def test_steps_match_jax(runs, arch):
    """Every rank reports JAX's loss, ce and grad norm at every step."""
    metrics, _ = runs["want"][arch]
    for rank in runs["got"]:
        _hold_metrics(rank[arch]["metrics"], metrics, STEP_RTOL)


def first_grads(arch, options=None):
    """The port's one-process gradient of the first ``SyntheticLM`` batch
    from the seed-0 weights (numpy, by path)."""
    cfg = tconfigs.smoke_config(arch)
    model = build_model(cfg, device="cpu")
    batch = ranks.synthetic_batches(cfg, 1)[0]
    with use_port_rules(PortRules({}, options=options) if options else None):
        grads, _ = grads_of(model, model.init(0),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    return {p: g.numpy() for p, g in tree_paths(grads)}


def hold_params(got, want, steps, grad0):
    """The trained slices, gathered into one tree, against the reference's
    final params: each entry within ``STEP_RTOL`` of its leaf's largest,
    those whose first-step gradient ``grad0`` is at rounding level within
    the steps' learning rates (see the module docstring)."""
    got = dict(tree_paths(got))
    want = {p: w.numpy() for p, w in tree_paths(want)}
    assert sorted(got) == sorted(want) == sorted(grad0)
    top = max(np.abs(g).max() for g in grad0.values())
    lr_sum = ranks.STEP["base_lr"] * steps
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        err = np.abs(g - w)
        noise = np.abs(grad0[path]) <= NOISE_GRAD * top
        assert err[~noise].max(initial=0.0) <= STEP_RTOL * np.abs(w).max(), (
            path, err[~noise].max() / np.abs(w).max())
        assert err[noise].max(initial=0.0) <= lr_sum, (path, err[noise].max())


@pytest.mark.parametrize("arch", [a for a, _, _ in JAX_HELD])
def test_final_params_match_jax(runs, arch):
    """The trained slices, gathered into one tree (head and GLU orders
    undone), equal JAX's final params leaf by leaf."""
    steps = dict((a, s) for a, s, _ in JAX_HELD)[arch]
    hold_params(runs["got"][0][arch]["params"], runs["want"][arch][1], steps,
                runs["grad0"][arch])


def test_pod_mesh_step_matches_jax(runs):
    """(pod 2, data 1, model 2): the batch over pods, weights replicated
    over them; one olmo-1b step equals JAX's first."""
    want = runs["want"]["olmo-1b"][0][:1]
    for rank in runs["got"]:
        _hold_metrics(rank["pod olmo-1b"]["metrics"], want, STEP_RTOL)


def test_collectives_are_zero3(runs):
    """On (data 2, model 2) each leaf cut over data is all-gathered where
    it is used and its gradient reduce-scattered once: a layer's leaves
    twice (forward and the backward's recompute), the others once. The
    model group only all-reduces."""
    for rank in runs["got"]:
        r = rank["olmo-1b"]
        total, in_layers = r["data_leaves"]
        gathers, scatters, _ = r["counts"]["data"]
        assert (gathers, scatters) == (total + in_layers, total), r["counts"]
        assert r["counts"]["model"][2] > 0 and r["counts"]["model"][:2] == (0, 0)


def test_checkpoint_round_trip(runs):
    """The save through the mesh writes the one-process save of the same
    params, byte for byte; the restore gives every rank its slices."""
    with np.load(os.path.join(runs["tmp"], "sharded.npz")) as a, \
            np.load(os.path.join(runs["tmp"], "single.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert np.array_equal(a[k], b[k]), k
    for rank in runs["got"]:
        assert rank["checkpoint"] == {"restored_equal": True, "step": 3}


def test_train_cli_mesh_matches_one_process(runs):
    """``launch/train.py --dp 2 --tp 2 --dist-backend gloo`` prints the ce
    of the one-process run, and every rank agrees."""
    rc, out = runs["cli"]
    assert rc == 0, out[-3000:]
    assert _ce_lines(out) == _ce_lines(runs["cli_want"]) != []
    assert "4 ranks over gloo: every rank's ce equal" in out


def test_rank_helpers_import_no_jax(runs):
    """Every rank's process, which runs the rank-side module alone, holds
    neither JAX nor the JAX package."""
    for rank in runs["got"]:
        assert rank["modules"] == []
