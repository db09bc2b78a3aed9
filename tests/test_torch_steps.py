"""The port's ``build_step`` and its specs vs the JAX package, on the CPU.

``configs/shapes.py`` equals the reference's ``SHAPES``; ``token_inputs``
gives the reference's input shapes and dtypes for all ten configs at all
four shapes; ``cache_axes_tree`` names every leaf of the port's cache list
with the reference's axes for its unstacked (``stacked=False``) tree,
leaf by leaf with equal shapes, for every published config at
``long_500k``'s 524 800 slots, with and without the window ring (drawn on
the meta device, and by ``jax.eval_shape``). ``build_step`` on a one-rank
CPU mesh (``make_local_mesh``): its decode equals ``Model.decode`` (olmo-1b,
and starcoder2-3b on a ring), its prefill ``Model.extend`` (internvl with
an image over placeholder tokens), its train step ``grads_of``; MLA under
context parallelism builds and runs on a virtual mesh; what it still
refuses raises (an unknown kind, train rules' overrides, an absent CUDA).
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.dryrun import step_arguments  # noqa: E402
from repro_torch.launch.mesh import AxisGroup, Mesh, make_local_mesh, make_virtual_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import fill_ring  # noqa: E402
from repro_torch.sharding.rules import use_rules  # noqa: E402
from repro_torch.train.loop import grads_of  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = tuple(sorted(tconfigs.REGISTRY))
SHAPES = tuple(sorted(tconfigs.SHAPES))
ATOL = 1e-5  # the same port code on one process, two call paths


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.get_shape("long_500k") == tconfigs.InputShape("long_500k", 524_288, 1,
                                                                  "decode")
    with pytest.raises(KeyError):
        tconfigs.get_shape("nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_token_inputs_equal_reference(arch):
    for name in SHAPES:
        want = jspecs.token_inputs(jconfigs.get_config(arch), jconfigs.get_shape(name))
        got = tspecs.token_inputs(tconfigs.get_config(arch), tconfigs.get_shape(name))
        assert sorted(got) == sorted(want), (arch, name)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape), str(v.dtype)[6:]) == (tuple(want[k].shape),
                                                         want[k].dtype.name), (arch, name, k)
        assert tspecs.batch_axes(None, got) == jspecs.batch_axes(None, want)


def _jax_layers(jcfg, tree):
    """The reference's unstacked cache tree as a list over layers in
    ``layer_specs()`` order: {name: leaf}, the "cross" tree's k / v as
    ``cross_k`` / ``cross_v``."""
    out = []
    for si, (pattern, reps) in enumerate(jcfg.stages):
        for r in range(reps):
            for i in range(len(pattern)):
                layer = dict(tree["stages"][si][f"r{r}"][f"l{i}"])
                if "cross" in tree:
                    cross = tree["cross"][si][f"r{r}"][f"l{i}"]
                    layer.update(cross_k=cross["k"], cross_v=cross["v"])
                out.append(layer)
    return out


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_reference(arch, ring):
    max_seq = tconfigs.get_shape("long_500k").seq_len + tspecs.DECODE_PAD
    jcfg = jconfigs.get_config(arch)
    jaxes, jtemplate = jspecs.cache_axes_tree(jbuild(jcfg), 1, max_seq, stacked=False,
                                              window_ring=ring)
    want_axes, want_t = _jax_layers(jcfg, jaxes), _jax_layers(jcfg, jtemplate)
    tm = build_model(tconfigs.get_config(arch), device="meta")
    axes, template = tspecs.cache_axes_tree(tm, 1, max_seq, window_ring=ring)
    assert len(axes) == len(want_axes) == tconfigs.get_config(arch).num_layers
    for i, (a, w, t, wt) in enumerate(zip(axes, want_axes, template, want_t)):
        assert a == w, (arch, i)
        assert {n: tuple(v.shape) for n, v in t.items()} == \
            {n: tuple(v.shape) for n, v in wt.items()}, (arch, i)


def test_param_specs_are_meta():
    cfg = tconfigs.get_config("starcoder2-3b")
    from repro_torch.sharding.rules import mode_rules
    values, specs = tspecs.param_specs(build_model(cfg, device="meta"),
                                       mode_rules({"data": 1, "model": 1}, "decode", 1))
    assert values["embed"].device.type == "meta"
    assert tuple(values["embed"].shape) == (cfg.vocab_size, cfg.d_model)
    assert specs["layers"][0]["mixer"]["wq"]["w"] == (None, "model", None)


def _decode_case(arch, options):
    cfg = tconfigs.smoke_config(arch)
    S = 20
    step = build_step(cfg, tconfigs.InputShape("t", S, 2, "decode"), make_local_mesh("cpu"),
                      options=options)
    assert step.max_seq == S + tspecs.DECODE_PAD and step.cp is None
    params = step.params(0)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(2, S + 1)))
    model = step.model
    whole = model.init_cache(2, step.max_seq)
    model.extend(params, toks[:, :S], whole, torch.zeros(2, dtype=torch.long))
    cache = step.init_cache()
    assert [{n: t.shape for n, t in c.items()} for c in cache] == \
        [{n: t.shape for n, t in c.items()}
         for c in model.init_cache(2, step.max_seq, window_ring=step.window_ring)]
    if step.window_ring:
        cache = fill_ring(cache, whole, S)
    else:
        cache = [{n: t.copy_(whole[i][n]) for n, t in c.items()} for i, c in enumerate(cache)]
    lens = torch.tensor([S, S - 4])
    got, _ = step.fn(params, step.rows({"tokens": toks[:, S:]})["tokens"], cache, lens)
    with use_rules(step.rules):
        want, _ = model.decode(params, toks[:, S:], whole, lens)
    return got, want


@pytest.mark.parametrize("arch,options", [("olmo-1b", None),
                                          ("starcoder2-3b", {"window_ring": True})])
def test_build_step_decode_equals_model_decode(arch, options):
    got, want = _decode_case(arch, options)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_build_step_prefill_and_train():
    cfg = tconfigs.smoke_config("internvl2-2b")
    N, S = cfg.num_image_tokens, 24
    step = build_step(cfg, tconfigs.InputShape("p", S, 2, "prefill"), make_local_mesh("cpu"))
    assert tuple(step.inputs["tokens"].shape) == (2, S - N)
    params = step.params(0)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(2, S - N)))
    img = torch.from_numpy(rng.normal(size=(2, N, cfg.d_model)).astype(np.float32))
    zero = torch.zeros(2, dtype=torch.long)
    got, _ = step.fn(params, toks, step.init_cache(), zero, {"vision_embeds": img})
    model = step.model
    want, _ = model.extend(params, torch.cat([torch.zeros((2, N), dtype=toks.dtype), toks], 1),
                           model.init_cache(2, S), zero, batch={"vision_embeds": img})
    assert got.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)

    cfg = tconfigs.smoke_config("olmo-1b")
    step = build_step(cfg, tconfigs.InputShape("tr", 16, 2, "train"), make_local_mesh("cpu"))
    params = step.params(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 16)))
             for k in ("tokens", "labels")}
    loss, grads = step.fn(params, batch)
    want_g, m = grads_of(step.model, params, batch)
    assert float(loss) == pytest.approx(float(m["loss"]), abs=ATOL)
    for g, w in zip(tree_leaves(grads), tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


def test_build_step_refusals():
    """What ``build_step`` still refuses: an unknown kind, train rules'
    overrides, CUDA where there is none. Prefill and decode on a model axis
    above 1 build (tensor-parallel steps, tests/test_torch_tp_steps.py), and
    so does MLA under context-parallel decode, which runs on its half of the
    latents (held against JAX in tests/test_torch_cp_decode.py)."""
    cfg = tconfigs.smoke_config("olmo-1b")
    groups = {n: AxisGroup(n, (0, 1) if n in ("model", "world") else (0,), 0, None)
              for n in ("data", "model", "batch", "world")}
    tp2 = Mesh(shape={"data": 1, "model": 2}, rank=0, backend="local",
               device=torch.device("cpu"), groups=groups)
    for kind in ("prefill", "decode"):
        step = build_step(cfg, tconfigs.InputShape("x", 16, 2, kind), tp2)
        assert step.sharding is not None and step.sharding.tp is tp2.model
    with pytest.raises(ValueError, match="unknown step kind"):
        build_step(cfg, tconfigs.InputShape("x", 16, 2, "score"), tp2)
    with pytest.raises(ValueError, match="train rules of its plan"):
        build_step(cfg, tconfigs.InputShape("x", 16, 2, "train"), tp2,
                   rules_overrides={"ff": None})
    mla = tconfigs.smoke_config("deepseek-v3-671b")
    cp = build_step(mla, tconfigs.InputShape("x", 16, 1, "decode"),
                    make_virtual_mesh({"data": 2, "model": 1}, device="cpu"),
                    options={"cp_decode": True})
    params, args = step_arguments(cp)
    assert {t.shape[1] for layer in args[1] for t in layer.values()} == {(16 + 512) // 2}
    logits, _ = cp.fn(params, *args)
    assert logits.shape == (1, 1, mla.vocab_size) and bool(torch.isfinite(logits).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_step(cfg, tconfigs.get_shape("decode_32k"), make_local_mesh())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)
