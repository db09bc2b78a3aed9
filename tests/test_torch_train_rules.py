"""The port's training rules vs the JAX package's, without processes.

* ``mode_rules(mesh, "train", batch)``'s partition spec of every parameter
  leaf of all ten smoke configs equals JAX's ``mode_rules(...).pspec`` over
  the reference's ``param_axes_tree``, at the meshes (data 2, model 2) and
  (pod 2, data 2, model 2) (JAX's ``pspec`` reads only ``mesh.shape``, so
  both get a stand-in carrying the shape); the stacked "layers" axis maps
  to no mesh axis, and the weight converter unstacks the specs as it
  unstacks the weights. ``mode_rules``' mappings equal JAX's per mode.
* ``cross_entropy`` with and without the "onehot_ce" option equals JAX's
  (under its rules on a one-device mesh), with a loss mask, within 1e-6,
  the option bound by ``use_rules`` or given (``onehot=``, as a rank's
  plan gives it).
* ``use_rules`` nests and restores, and ``Rules.opt`` reads the options.
* No fallback: a stack tensor parallelism does not cover refuses a model
  axis above 1 and names its family; an indivisible expert count refuses
  it; the production mesh asks for the world it needs; ``launch/train.py
  --multi-pod`` alone stops.
"""
import dataclasses
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro import configs as jconfigs  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jdebug_mesh  # noqa: E402
from repro.launch.specs import mode_rules as jmode_rules  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.common import is_param  # noqa: E402
from repro.sharding import Rules as JRules  # noqa: E402
from repro.sharding import use_rules as juse_rules  # noqa: E402
from repro.train.loop import cross_entropy as jcross_entropy  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.models.model import param_axes, param_shapes  # noqa: E402
from repro_torch.sharding import Rules, current_rules, mode_rules, use_rules  # noqa: E402
from repro_torch.train.loop import cross_entropy  # noqa: E402
from repro_torch.train.sharding import TrainSharding  # noqa: E402

MESHES = {"data2-model2": {"data": 2, "model": 2},
          "pod2-data2-model2": {"pod": 2, "data": 2, "model": 2}}
# every partition-spec entry a train rule can give a parameter
ENTRIES = [None, "pod", "data", "model", ("pod", "data"), ("data", "model")]


class FakeMesh:
    """JAX's ``Rules.pspec`` only consults ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _encode(p, rules):
    """A JAX Param's train pspec as integer codes in the value's layout: a
    stacked stage leaf (R, ...) gives one row per repeat (its "layers"
    entry, which maps to no mesh axis, dropped)."""
    spec = tuple(rules.pspec(p.axes, p.value.shape))
    codes = np.asarray([ENTRIES.index(e) for e in spec], np.int64)
    if p.axes and p.axes[0] == "layers":
        assert spec[0] is None
        return np.tile(codes[1:], (p.value.shape[0], 1))
    return codes


def _decode(tree):
    if isinstance(tree, dict):
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v) for v in tree]
    return tuple(ENTRIES[i] for i in tree.tolist())


def _specs(rules, axes, shapes):
    if isinstance(axes, dict):
        return {k: _specs(rules, v, shapes[k]) for k, v in axes.items()}
    if isinstance(axes, list):
        return [_specs(rules, a, s) for a, s in zip(axes, shapes, strict=True)]
    return rules.pspec(axes, shapes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_pspecs_match_jax(arch, mesh):
    shape = MESHES[mesh]
    jrules = jmode_rules(FakeMesh(shape), "train", 16)
    jparams = jax.eval_shape(lambda: jbuild(jconfigs.smoke_config(arch)).init(
        jax.random.PRNGKey(0), max_seq=64))
    codes = jax.tree.map(lambda p: _encode(p, jrules), jparams, is_leaf=is_param)
    cfg = tconfigs.smoke_config(arch)
    want = _decode(convert_params(cfg, codes))
    got = _specs(mode_rules(shape, "train", 16), param_axes(cfg), param_shapes(cfg, 64))
    assert got == want


@pytest.mark.parametrize("kind,batch", [("train", 16), ("prefill", 4), ("decode", 8),
                                        ("decode", 1)])
def test_mode_rules_match_jax(kind, batch):
    shape = MESHES["pod2-data2-model2"]
    assert mode_rules(shape, kind, batch).mapping == \
        jmode_rules(FakeMesh(shape), kind, batch).mapping


@pytest.mark.parametrize("onehot", [False, True])
def test_cross_entropy_matches_jax(onehot):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    options = {"onehot_ce": True} if onehot else {}
    jmesh = jdebug_mesh()
    with jmesh, juse_rules(JRules(jmesh, options=options)):
        want = float(jax.jit(jcross_entropy)(jnp.asarray(logits), jnp.asarray(labels),
                                             jnp.asarray(mask)))
    t = [torch.from_numpy(a) for a in (logits, labels, mask)]
    with use_rules(Rules({}, options=options)):
        got = float(cross_entropy(*t))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a rank's plan hands the option over itself, whatever rules are bound
    with use_rules(Rules({}, options={"onehot_ce": not onehot})):
        given = float(cross_entropy(*t, onehot=onehot))
    assert given == got


def test_use_rules_nests_and_restores():
    outer, inner = Rules({"data": 2}, options={"onehot_ce": True}), Rules({"model": 2})
    assert current_rules() is None
    with use_rules(outer) as r:
        assert r is outer and current_rules().opt("onehot_ce")
        assert not current_rules().opt("sharded_moe")
        with use_rules(inner):
            assert current_rules() is inner and not current_rules().opt("onehot_ce")
        assert current_rules() is outer
        with pytest.raises(RuntimeError):
            with use_rules(None):
                assert current_rules() is None
                raise RuntimeError
        assert current_rules() is outer
    assert current_rules() is None


def _stand_in_mesh(shape):
    """What ``TrainSharding`` reads of a mesh before any collective."""
    group = types.SimpleNamespace(size=shape.get("pod", 1) * shape.get("data", 1), index=0)
    model = types.SimpleNamespace(size=shape.get("model", 1), index=0)
    return types.SimpleNamespace(shape=shape, batch=group, model=model,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("arch,family", [
    ("deepseek-v3-671b", "mla"), ("jamba-v0.1-52b", "mamba"), ("xlstm-1.3b", "mlstm"),
    ("whisper-base", "audio"), ("internvl2-2b", "vlm")])
def test_tp_training_refuses_uncovered_families(arch, family):
    cfg = tconfigs.smoke_config(arch)
    with pytest.raises(NotImplementedError, match=rf"{cfg.name} \(.*{family}"):
        TrainSharding(cfg, _stand_in_mesh({"data": 1, "model": 2}), 4)
    # a model axis of 1 (pure FSDP) takes every family
    TrainSharding(cfg, _stand_in_mesh({"data": 2, "model": 1}), 4)


def test_tp_training_refuses_indivisible_experts():
    cfg = tconfigs.smoke_config("llama4-scout-17b-a16e")  # 4 experts, 4 heads
    with pytest.raises(ValueError, match="num_experts"):
        TrainSharding(dataclasses.replace(cfg, num_experts=3),
                      _stand_in_mesh({"data": 1, "model": 2}), 4)


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_world(monkeypatch, multi_pod, need):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    want = "pod=2, data=16, model=16" if multi_pod else "data=16, model=16"
    with pytest.raises(ValueError, match=rf"production mesh \({want}\) needs {need} ranks "
                                         "but the world has 4"):
        tmesh.make_production_mesh(multi_pod=multi_pod, backend="gloo", device="cpu")


def test_multi_pod_alone_stops():
    with pytest.raises(SystemExit, match="512 ranks"):
        ttrain.main(["--debug", "--device", "cpu", "--multi-pod"])
