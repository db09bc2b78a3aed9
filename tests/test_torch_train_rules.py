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
* Every family trains on a model axis of 2: the plan builds for all ten
  smoke configs, and every leaf's slice is the rank's block of the whole
  leaf, an axis of pieces side by side (a GLU up-projection, Mamba's
  ``in_proj``, the mLSTM's ``up_proj``, the sLSTM's ``wx`` and, where its
  units split, ``ffn_up``) taking its share of each piece;
  ``build_step``'s train step of each family this reaches on (1, 2) holds
  the rank's slices.
* The reference's divisibility rule: heads that do not divide the model
  axis (xlstm's 4 on 8) and an indivisible expert count are held whole on
  every rank (no leaf of theirs cut over model); the production mesh asks
  for the world it needs; ``launch/train.py --multi-pod`` alone stops.
"""
import dataclasses
import math
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
from repro_torch.core.executor.sharded import tp_layout, train_slicer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
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


def _stand_in_rank(shape, index):
    """A ``launch/mesh.Mesh`` of ``shape`` seen from model rank ``index``
    (data 0), whose groups run no collective: what the slicer and
    ``build_step`` read."""
    world = math.prod(shape.values())
    groups = {n: tmesh.AxisGroup(n, tuple(range(shape.get(n, world))), index
                                 if n == "model" else 0, None)
              for n in ("data", "model", "batch", "world")}
    return tmesh.Mesh(shape=shape, rank=index, backend="local", device=torch.device("cpu"),
                      groups=groups)


# (owner of the leaf, logical axis) -> pieces side by side on that axis
PIECES = {("in_proj", "ssm_inner"): 2, ("up_proj", "lstm_inner"): 2, ("wx", "lstm_inner"): 4,
          ("ffn_up", "ff"): 2}


def _pieces(cfg, path, axis, width, mp):
    owner = path[-2] if len(path) > 1 else None
    n = 2 if (owner in ("w1", "shared_w1") and axis == "ff"
              and cfg.activation.endswith("_glu")) else PIECES.get((owner, axis), 1)
    return n if (width // n) % mp == 0 else 1  # a piece that does not split: contiguous


def _expected_block(cfg, t, axes, spec, path, index, mp):
    """The rank's block of a whole leaf along every dimension cut over
    model: its 1/mp of each piece of the axis, the pieces in order."""
    for dim, (axis, part) in enumerate(zip(axes, spec)):
        if part != "model":
            continue
        assert axis != "heads" or tp_layout(cfg, mp).head_order is None
        n = _pieces(cfg, path, axis, t.shape[dim], mp)
        shape = t.shape[:dim] + (n, mp, t.shape[dim] // (n * mp)) + t.shape[dim + 1:]
        t = t.reshape(shape).select(dim + 1, index).flatten(dim, dim + 1)
    return t


def _leaves(tree, axes, path=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], axes[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, (t, a) in enumerate(zip(tree, axes, strict=True))
                for x in _leaves(t, a, path + (str(i),))]
    return [(path, tree, axes)]


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_tp_training_takes_every_family(arch):
    """On (data 1, model 2) the plan builds, and each rank's slice of every
    leaf equals its block of the whole leaf in the pieces' order (checked
    against a reshape, not the slicer's order)."""
    cfg = tconfigs.smoke_config(arch)
    shape = {"data": 1, "model": 2}
    whole = build_model(cfg, device="cpu").init(0)
    ordered = 0
    for index in range(2):
        mesh = _stand_in_rank(shape, index)
        shard = TrainSharding(cfg, mesh, 4)
        assert shard.layer_cfg.num_heads == cfg.num_heads // 2
        mine = train_slicer(cfg, mesh, shard.rules)(whole, shard.axes)
        for (path, t, axes), (_, got, _) in zip(_leaves(whole, shard.axes),
                                                _leaves(mine, shard.axes)):
            spec = shard.rules.pspec(axes, tuple(t.shape))
            want = _expected_block(cfg, t, axes, spec, path, index, 2)
            assert torch.equal(got, want), path
            ordered += any(p == "model" and _pieces(cfg, path, a, w, 2) > 1
                           for a, p, w in zip(axes, spec, t.shape))
    glu = cfg.activation.endswith("_glu") and cfg.d_ff
    assert (ordered > 0) == (bool(glu) or arch in ("jamba-v0.1-52b", "xlstm-1.3b")), ordered


def test_tp_training_refuses_indivisible_heads():
    """xlstm's 4 heads on a model axis of 8 (its 512 inner channels would
    divide, cutting inside a head): the plan no longer refuses them but,
    by the reference's divisibility rule, holds the xLSTM's heads and inner
    widths whole on every rank, so no leaf of its layers is cut over model
    and the layers run whole."""
    cfg = tconfigs.smoke_config("xlstm-1.3b")
    shard = TrainSharding(cfg, _stand_in_mesh({"data": 1, "model": 8}), 4)
    assert {"heads", "lstm_inner", "ff"} <= set(shard.layout.whole)
    assert shard.layer_cfg.num_heads == cfg.num_heads
    for layer in shard.specs["layers"]:
        for spec in tree_leaves_specs(layer["mixer"]):
            assert "model" not in spec


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b", "xlstm-1.3b",
                                  "whisper-base", "internvl2-2b"])
def test_build_step_trains_on_a_model_axis(arch):
    """``build_step``'s train step on (data 1, model 2): its plan cuts the
    model group, and its parameters are the rank's slices (each leaf's
    whole shape over the cut of its spec)."""
    cfg = tconfigs.smoke_config(arch)
    mesh = _stand_in_rank({"data": 1, "model": 2}, 1)
    step = build_step(cfg, tconfigs.InputShape("tr", 16, 4, "train"), mesh)
    assert step.shard.tp is mesh.model and step.shard.layer_cfg.num_heads == cfg.num_heads // 2
    params = step.params(0)
    shapes = param_shapes(cfg, step.init_max_seq)
    cut = 0
    for (path, t, axes), (_, whole, _) in zip(_leaves(params, step.shard.axes),
                                              _leaves(shapes, step.shard.axes)):
        spec = step.shard.specs
        for k in path:
            spec = spec[int(k)] if isinstance(spec, list) else spec[k]
        want = tuple(w // 2 if p == "model" else w for w, p in zip(whole, spec))
        assert tuple(t.shape) == want, path
        cut += want != tuple(whole)
    assert cut > 0


def test_tp_training_refuses_indivisible_experts():
    """3 experts on a model axis of 2: by the reference's divisibility rule
    the experts are whole on every rank (no refusal), the heads and the
    shared expert's units still cut."""
    cfg = tconfigs.smoke_config("llama4-scout-17b-a16e")  # 4 experts, 4 heads
    shard = TrainSharding(dataclasses.replace(cfg, num_experts=3),
                          _stand_in_mesh({"data": 1, "model": 2}), 4)
    assert shard.layout.whole == ("experts",)
    ff = shard.specs["layers"][0]["ff"]
    assert "model" not in ff["w1"] and "model" not in ff["w2"]
    assert "model" in ff["shared_w1"]["w"]
    assert shard.layer_cfg.num_heads == cfg.num_heads // 2


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


def tree_leaves_specs(tree):
    """The pspecs of a spec tree (tuples), in leaf order."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in tree_leaves_specs(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in tree_leaves_specs(v)]
    return [tree]
