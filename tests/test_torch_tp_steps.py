"""Tensor-parallel prefill and decode steps (``build_step`` on a model axis
above 1) on the CPU, against JAX's steps and the port's one process.

Two worlds of gloo ranks (``launch/mesh.py::spawn_ranks``, one intra-op
thread each; the rank-side work is ``tests/_torch_tp_ranks.py``, which
imports no JAX), started together while this process compiles JAX's steps:

* 2 ranks on (data 1, model 2): every family at smoke width in f32
  (``build_step``'s prefill of B=2 rows of S=13 tokens, the cache copied
  into the decode step's, then 3 decode steps), and two replication
  paths at widths no smoke config has (``dataclasses.replace``): heads
  whole (3 heads on 2 ranks: attention runs whole on every rank, no
  all-reduce after ``wo``) and vocab whole (511 rows: the logits whole on
  every rank);
* 4 ranks on (data 1, model 4): replicated KV heads under a contiguous
  head split, Hl < G (qwen2.5-32b's smoke 4 heads over 2 KV heads: one
  head a rank, each reading KV head h // 2), and Hl > G in both forms
  (16 heads over 8 KV heads: 4 local heads over 2 KV heads, a view; 12
  over 6: 3 local heads over KV heads 0, 0, 1, one a head); and, on
  (data 2, model 2) over the same world, deepseek-v3's experts over
  (data, model) (the rules' override of the reference's perf_runs pair 5).

qwen2.5-32b (dense GQA), deepseek-v3 (MLA + MoE, experts over the model
group) and jamba (Mamba + attention + MoE) are held against the
reference's own ``build_step(...).fn`` at a (1, 1) debug mesh on the
converted weights (prefill into an S-slot cache, its windows padded to the
decode step's S + DECODE_PAD slots), jitted at XLA's backend optimization
level 0; every other case against the port's one process
(``make_local_mesh``) on the same seed-0 weights. Logits (gathered over the
vocab where the step cuts it) within ``ATOL`` = 1e-4 at every step, and the
greedy tokens (each step's argmax) equal.

The dry-run's virtual mesh (``make_virtual_mesh``, the meta device) counts
the same collectives as the real gloo mesh: calls and bytes per kind of
the prefill, each decode step and olmo-1b's and deepseek-v3's train step,
rank by rank; and its ``argument_bytes`` equal the sum of each real rank's
slices, cache and rows.
"""
import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import _torch_tp_ranks as ranks  # noqa: E402
import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.dryrun import measure  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_virtual_mesh, spawn_ranks  # noqa: E402
from repro_torch.launch.specs import DECODE_PAD  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ATOL = 1e-4
B, S, STEPS = ranks.B, ranks.S, ranks.STEPS
ARCHS = tuple(sorted(tconfigs.REGISTRY))
JAX_HELD = ("qwen2.5-32b", "deepseek-v3-671b", "jamba-v0.1-52b")
MESH2, MESH4 = {"data": 1, "model": 2}, {"data": 1, "model": 4}


def _olmo(**changes):
    return dataclasses.replace(tconfigs.smoke_config("olmo-1b"), **changes)


# the replication paths no smoke config reaches at these axes
EXTRA2 = {"heads_whole": _olmo(name="olmo-h3", num_heads=3, num_kv_heads=3),
          "vocab_whole": _olmo(name="olmo-v511", vocab_size=511)}
# deepseek-v3's 4 smoke experts over (data 2, model 2): one expert a rank,
# each data shard's rows gathered, its rows' sum reduce-scattered back
EP_DATA = {"mesh": {"data": 2, "model": 2}, "overrides": {"experts": ("data", "model")}}
CASES4 = {"kv_rep_hl_lt_g": tconfigs.smoke_config("qwen2.5-32b"),
          "kv_rep_hl_gt_g_view": _olmo(name="olmo-h16", num_heads=16, num_kv_heads=8,
                                       head_dim=16),
          "kv_rep_hl_gt_g_select": _olmo(name="olmo-h12", num_heads=12, num_kv_heads=6,
                                         head_dim=16)}


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
    extras = None
    if cfg.family == "audio":
        extras = {"audio_frames": (0.1 * rng.normal(
            size=(B, cfg.n_audio_ctx, cfg.d_model))).astype(np.float32)}
    if cfg.family == "vlm":
        extras = {"vision_embeds": (0.1 * rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)}
    return toks, extras


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_run(arch, toks):
    """The reference's prefill and decode ``build_step(...).fn`` at a (1, 1)
    debug mesh: [prefill logits, each decode step's]."""
    jcfg, jm, values = bcommon.small_model(arch)
    mesh = jmesh.make_debug_mesh(1, 1)
    pre = jsteps.build_step(jcfg, jconfigs.InputShape("p", S, B, "prefill"), mesh)
    dec = jsteps.build_step(jcfg, jconfigs.InputShape("d", S, B, "decode"), mesh)
    args = (values, jnp.asarray(toks[:, :S]), jm.init_cache(B, S),
            jnp.zeros((B,), jnp.int32), None)
    logits, cache = _compiled(pre.fn, *args)(*args)
    out = [np.asarray(logits)]

    def pad(t):  # a window leaf (reps, B, S, ...): S + DECODE_PAD slots
        if t.ndim >= 3 and t.shape[2] == S:
            return jnp.pad(t, [(0, 0), (0, 0), (0, DECODE_PAD)] + [(0, 0)] * (t.ndim - 3))
        return t
    cache = jax.tree.map(pad, cache)
    step = None
    for t in range(STEPS):
        args = (values, jnp.asarray(toks[:, S + t:S + t + 1]), cache,
                jnp.full((B,), S + t, jnp.int32))
        step = step or _compiled(dec.fn, *args)
        logits, cache = step(*args)
        out.append(np.asarray(logits))
    return out


def _cases2():
    out = {}
    for arch in ARCHS:
        cfg = tconfigs.smoke_config(arch)
        toks, extras = _inputs(cfg, 3)
        case = {"cfg": cfg, "tokens": toks, "extras": extras}
        if arch in JAX_HELD:
            case["whole"] = convert_params(cfg, jax.device_get(bcommon.small_model(arch)[2]))
        if arch in ("olmo-1b", "deepseek-v3-671b"):
            case["train"] = True
        out[arch] = case
    for name, cfg in EXTRA2.items():
        toks, _ = _inputs(cfg, 5)
        out[name] = {"cfg": cfg, "tokens": toks}
    return out


def _cases4():
    out = {name: {"cfg": cfg, "tokens": _inputs(cfg, 7)[0]} for name, cfg in CASES4.items()}
    cfg = tconfigs.smoke_config("deepseek-v3-671b")
    out["experts_over_data"] = {"cfg": cfg, "tokens": _inputs(cfg, 9)[0], **EP_DATA}
    return out


@pytest.fixture(scope="module")
def worlds():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cases2, cases4 = _cases2(), _cases4()
    try:
        with ThreadPoolExecutor(2) as ex:
            w2 = ex.submit(spawn_ranks, ranks.tp_cases, 2, MESH2, cases2, timeout=600)
            w4 = ex.submit(spawn_ranks, ranks.tp_cases, 4, MESH4, cases4, timeout=600)
            jax_refs = {arch: _jax_run(arch, cases2[arch]["tokens"]) for arch in JAX_HELD}
            local = make_local_mesh("cpu")
            port = {name: ranks.run_case(c["cfg"], local, c["tokens"], c.get("extras"))
                    for name, c in {**cases2, **cases4}.items() if name not in JAX_HELD}
            yield {"2": w2.result(), "4": w4.result(), "jax": jax_refs, "port": port,
                   "cases": {**cases2, **cases4}}
    finally:
        torch.set_num_threads(n)


def _hold(got, want, name, rows=slice(None)):
    assert len(got) == len(want) == STEPS + 1
    for t, (g, w) in enumerate(zip(got, (w[rows] for w in want))):
        assert g.shape == w.shape, (name, t, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"{name} step {t}")
        np.testing.assert_array_equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1),
                                      err_msg=f"{name} greedy step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_family_matches_reference(worlds, arch):
    want = worlds["jax"][arch] if arch in JAX_HELD else worlds["port"][arch]["logits"]
    for r in worlds["2"]:
        _hold(r["results"][arch]["logits"], want, f"{arch} rank {r['rank']}")


@pytest.mark.parametrize("name", sorted(EXTRA2) + sorted(CASES4))
def test_replication_paths(worlds, name):
    """Heads whole, vocab whole and replicated KV heads under a contiguous
    split (Hl < G, and Hl > G as a view and as a selection) against the
    port's one process; heads whole pays no all-reduce after ``wo``."""
    world = worlds["4"] if name in CASES4 else worlds["2"]
    cfg = worlds["cases"][name]["cfg"]
    for r in world:
        res = r["results"][name]
        _hold(res["logits"], worlds["port"][name]["logits"], f"{name} rank {r['rank']}")
        calls = res["collectives"][1]["calls"].get("all-reduce", 0)
        if name == "heads_whole":  # only the MLP's all-reduce (and the embedding's)
            assert calls == cfg.num_layers + 1, calls
        elif name == "vocab_whole":  # no vocab-parallel embedding
            assert calls == 2 * cfg.num_layers, calls


def _virtual(cfg, mesh_shape, rank, kind, overrides=None):
    train = kind == "train"
    step = build_step(cfg, tconfigs.InputShape("x", 16 if train else S, 4 if train else B,
                                               kind),
                      make_virtual_mesh(mesh_shape, rank=rank), overrides)
    return measure(step)


def test_experts_over_data_and_model(worlds):
    """The rules' "experts" on (data, model) (the reference's perf_runs
    pair 5): each rank holds one of the 4 smoke experts and its row of the
    batch; every rank's logits are the one process's of its row, and each
    MoE layer adds one all-gather and one reduce-scatter over data."""
    name = "experts_over_data"
    cfg = worlds["cases"][name]["cfg"]
    n_moe = sum(s.ff == "moe" for s in cfg.layer_specs())
    for r in worlds["4"]:
        res = r["results"][name]
        d = res["coords"]["data"]
        _hold(res["logits"], worlds["port"][name]["logits"], f"{name} rank {r['rank']}",
              rows=slice(d, d + 1))
        calls = res["collectives"][1]["calls"]
        assert calls["all-gather"] == calls["reduce-scatter"] == n_moe, calls


@pytest.mark.parametrize("name", ["olmo-1b", "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "heads_whole", "kv_rep_hl_lt_g", "experts_over_data"])
def test_virtual_mesh_counts_like_gloo(worlds, name):
    """The meta-device dry-run's collectives (calls and bytes per kind) and
    argument bytes equal each real rank's, prefill, decode and (olmo-1b,
    deepseek-v3) train."""
    four = name in CASES4 or name == "experts_over_data"
    world, mesh_shape = (worlds["4"], MESH4) if four else (worlds["2"], MESH2)
    case = worlds["cases"][name]
    mesh_shape = case.get("mesh", mesh_shape)
    for r in world:
        res = r["results"][name]
        kinds = ["prefill", "decode"] + (["train"] if case.get("train") else [])
        for kind in kinds:
            got = _virtual(case["cfg"], mesh_shape, r["rank"], kind, case.get("overrides"))
            real = {"prefill": res["collectives"][0], "decode": res["collectives"][1],
                    "train": res.get("train_collectives")}[kind]
            assert got["collective_calls"] == real["calls"], (name, kind, r["rank"])
            assert got["collective_bytes"] == real["bytes"], (name, kind, r["rank"])
            assert got["memory"]["argument_bytes"] == res["argument_bytes"][kind], \
                (name, kind, r["rank"])
