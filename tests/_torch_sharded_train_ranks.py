"""Rank-side work of the port's sharded train-step tests, run by
``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo (one intra-op
thread per rank). Imports neither JAX nor ``repro``: the test process holds
the ranks' results against JAX's single-device step itself. Every rank
draws its slices of the port's seed-0 weights (``TrainSharding.params``)
and takes its rows of ``SyntheticLM(seed=0)`` batches; results travel back
as numpy."""
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.executor.sharded import train_slicer
from repro_torch.data import SyntheticLM, make_batches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import batch_extras
from repro_torch.models import build_model
from repro_torch.models.model import ENC_SPEC, _layer_forward
from repro_torch.models.moe import moe_apply, moe_param_axes
from repro_torch.optim import clip_by_global_norm
from repro_torch.train.loop import grads_of, init_train_state, make_train_step
from repro_torch.train.sharding import TrainSharding
from repro_torch.tree import tree_map, tree_paths

# the sharded steps' settings (the test holds JAX's single-device step to them)
STEP = dict(base_lr=1e-3, warmup_steps=1, total_steps=10)
STEP_MAX_NORM = 1.0  # make_train_step's default clip
B, S = 4, 16
MESH = {"data": 2, "model": 2}
POD = {"pod": 2, "data": 1, "model": 2}
FSDP = {"data": 2, "model": 1}
# the moe_apply case: smoke width, 2 rows of 4200 tokens (global T * k = 8400
# > NO_DROP_THRESHOLD, each shard's 4200 below it), capacity factor 1.0
MOE_ROWS, MOE_SEQ, MOE_CF = 2, 4200, 1.0


def synthetic_batches(cfg, steps, batch=B, seq=S):
    """``SyntheticLM(seed=0)`` batches with the family's extras
    (``launch/train.py::batch_extras``: audio frames, image rows)."""
    return list(make_batches(SyntheticLM(cfg.vocab_size, seq, seed=0), batch, steps,
                             batch_extras(cfg, batch)))


def smoke_batch(cfg, seed=0, batch=2, seq=16):
    """One batch with the family's extras (image rows, audio frames) and
    random labels over the text, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (0.1 * rng.normal(
            size=(batch, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = (0.1 * rng.normal(
            size=(batch, cfg.n_audio_ctx, cfg.d_model))).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    return out


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _counts(mesh):
    groups = [mesh.axis(a) for a in mesh.shape] + [mesh.batch]
    return {g.name: (g.all_gathers, g.reduce_scatters, g.all_reduces) for g in groups}


def _data_leaves(shard):
    """(leaves cut over data in the whole tree, of them in the layers)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return int(any(p == "data" for p in tree))
    return count(shard.specs), count(shard.specs["layers"])


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))


def train_run(arch, shape, options, batches, *, whole=False, grad0=False):
    """The port's train steps on this rank of ``shape``: per-step metrics,
    the collectives counted on the first step beside the number of leaves
    cut over data (all of them, the layers'), the bytes of the rank's
    parameter slices, with ``whole`` the final params gathered into one
    tree and with ``grad0`` the first batch's gradient gathered into one
    tree (numpy)."""
    cfg = configs.smoke_config(arch)
    mesh = make_mesh(shape, backend="gloo", device="cpu")
    shard = TrainSharding(cfg, mesh, len(batches[0]["tokens"]), options)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0, shard=shard)
    step = make_train_step(model, shard=shard, **STEP)
    out = {"metrics": [], "param_bytes": _bytes(state.params)}
    if grad0:
        g, _ = grads_of(model, state.params,
                        {k: torch.from_numpy(v) for k, v in shard.rows(batches[0]).items()}, shard)
        out["grad0"] = _numpy(shard.unshard(g))
    for i, b in enumerate(batches):
        for g in mesh.groups.values():
            g.reset_counts()
        state, m = step(state, {k: torch.from_numpy(v) for k, v in shard.rows(b).items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["counts"] = _counts(mesh)
    out["data_leaves"] = _data_leaves(shard)
    if whole:
        out["params"] = _numpy(shard.unshard(state.params))
    return out


def moe_case(x, params, sharded):
    """``moe_apply`` of llama4-scout's smoke MoE on this rank of the (data 2,
    model 2) mesh at capacity factor ``MOE_CF``: the rank's experts and
    shared-expert units cut by ``train_slicer`` and gathered over data, its
    rows of ``x``; returns (its rows of y, aux)."""
    cfg = configs.smoke_config("llama4-scout-17b-a16e")
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    shard = TrainSharding(cfg, mesh, x.shape[0], {"sharded_moe": sharded})
    axes = moe_param_axes(cfg)
    whole = tree_map(torch.from_numpy, params)
    local = train_slicer(cfg, mesh, shard.rules)(whole, axes)
    with torch.no_grad():
        p = shard.gather(local, shard.specs["layers"][0]["ff"])
        y, aux = moe_apply(p, cfg, torch.from_numpy(shard.rows({"x": x})["x"]),
                           capacity_factor=MOE_CF, tp=shard.tp, dp=mesh.batch,
                           sharded_moe=sharded)
    return y.numpy(), float(aux)


def checkpoint_case(tmpdir):
    """olmo-1b's seed-0 slices on (data 2, model 2): saved through the mesh
    (rank 0 writes the whole tree), restored onto the mesh; whether every
    restored slice equals the rank's and the step came back."""
    cfg = configs.smoke_config("olmo-1b")
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    shard = TrainSharding(cfg, mesh, B)
    params = shard.params(build_model(cfg, device="cpu"), 0)
    path = os.path.join(tmpdir, "sharded.npz")
    save_checkpoint(path, params, step=3, shard=shard)
    mesh.barrier()
    restored, step = load_checkpoint(path, params, shard=shard)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_paths(restored),
                                                          tree_paths(params)))
    return {"restored_equal": same, "step": step}


# (arch, steps, rules options, whole params back) of the dense cases on (2, 2)
DENSE = (("olmo-1b", 3, {}, True), ("qwen2.5-32b", 3, {}, True),
         ("gemma-2b", 1, {"onehot_ce": True}, True))
EP = ("llama4-scout-17b-a16e", 2, {"sharded_moe": True, "onehot_ce": True}, True)


def dense_cases(tmpdir):
    """The dense world-of-4 cases: (data 2, model 2) trains ``DENSE`` and
    round-trips a checkpoint; (pod 2, data 1, model 2) trains olmo-1b one
    step. Also the modules of JAX or the JAX package this rank's process
    holds (none: it runs this module alone)."""
    torch.set_num_threads(1)
    out = {}
    for arch, steps, options, whole in DENSE:
        cfg = configs.smoke_config(arch)
        out[arch] = train_run(arch, MESH, options, synthetic_batches(cfg, steps), whole=whole)
    out["pod olmo-1b"] = train_run("olmo-1b", POD, {}, synthetic_batches(
        configs.smoke_config("olmo-1b"), 1))
    out["checkpoint"] = checkpoint_case(tmpdir)
    out["modules"] = sorted(n for n in sys.modules
                            if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def ep_cases(args):
    """The expert-parallel world-of-4 cases on (data 2, model 2): ``EP``'s
    steps, then the moe_apply drop regime in both modes."""
    torch.set_num_threads(1)
    arch, steps, options, whole = EP
    out = {arch: train_run(arch, MESH, options,
                           synthetic_batches(configs.smoke_config(arch), steps), whole=whole)}
    out["moe"] = {mode: moe_case(args["moe_x"], args["moe_params"], mode == "sharded")
                  for mode in ("sharded", "global")}
    return out


def fsdp_grads(archs):
    """Pure FSDP on (data 2, model 1), the model code on whole (gathered)
    leaves: for each smoke config, ``grads_of`` on the rank's row of
    ``smoke_batch`` from the seed-0 weights drawn at max_seq 64 (what
    ``tests/test_torch_train_families.py`` holds JAX's gradient on), and
    the train step's clip norm of those slices. Returns per config the
    metrics, the norm and the gradient gathered into one tree (numpy)."""
    torch.set_num_threads(1)
    mesh = make_mesh(FSDP, backend="gloo", device="cpu")
    out = {}
    for arch in archs:
        cfg = configs.smoke_config(arch)
        batch = smoke_batch(cfg)
        shard = TrainSharding(cfg, mesh, len(batch["tokens"]), max_seq=64)
        model = build_model(cfg, device="cpu")
        params = shard.params(model, 0, 64)
        grads, metrics = grads_of(model, params,
                                  {k: torch.from_numpy(v) for k, v in shard.rows(batch).items()},
                                  shard)
        _, norm = clip_by_global_norm(grads, STEP_MAX_NORM, shard)
        out[arch] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grad_norm": float(norm), "grads": _numpy(shard.unshard(grads))}
    return out


# the families tensor parallelism reaches through their own mixers, encoder
# and MTP block: MLA (+ MoE + MTP) and Mamba, then the xLSTM's, whisper's
# and internvl's; each trains TP_STEPS steps on TP_MESH against JAX's
# single-device step, xlstm also on MESH
MLA_ARCHS = ("deepseek-v3-671b", "jamba-v0.1-52b")
MIXER_ARCHS = ("xlstm-1.3b", "whisper-base", "internvl2-2b")
TP_MESH = {"data": 1, "model": 2}
TP_STEPS = 2


def family_cases(archs):
    """On a world of 2 ranks, (data 1, model 2): each of ``archs`` trains
    ``TP_STEPS`` steps (metrics, the first batch's gradient and the final
    params gathered, the rank's parameter bytes); the JAX modules held."""
    torch.set_num_threads(1)
    out = {arch: train_run(arch, TP_MESH, {}, synthetic_batches(
        configs.smoke_config(arch), TP_STEPS), whole=True, grad0=True) for arch in archs}
    out["modules"] = sorted(n for n in sys.modules
                            if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def _counted(mesh, fn):
    """(fn(), the model group's collectives during it: all-reduces,
    all-gathers, reduce-scatters)."""
    g = mesh.axis("model")
    g.reset_counts()
    out = fn()
    return out, (g.all_reduces, g.all_gathers, g.reduce_scatters)


def layer_collectives(archs):
    """On a world of 2 ranks, (data 1, model 2): for each of ``archs``, the
    model group's collectives of one forward and of its backward pass, per
    decoder layer (in ``layer_specs()`` order; whisper's with its
    cross-attention over encoder states) and, for whisper, over its whole
    encoder (with the encoder's layer count)."""
    torch.set_num_threads(1)
    mesh = make_mesh(TP_MESH, backend="gloo", device="cpu")
    out = {}
    for arch in archs:
        cfg = configs.smoke_config(arch)
        shard = TrainSharding(cfg, mesh, 2)
        model = build_model(cfg, device="cpu")
        # leaves that take a gradient, as grads_of's do: a leaf that enters
        # the rank's part through copy_to_model all-reduces it
        params = tree_map(lambda t: t.detach().requires_grad_(), shard.params(model, 0))
        gen = torch.Generator().manual_seed(3)
        x = torch.randn((2, 16, cfg.d_model), generator=gen)
        enc = torch.randn((2, cfg.n_audio_ctx, cfg.d_model), generator=gen).requires_grad_() \
            if cfg.family == "audio" else None
        pos = torch.arange(16)
        rows = []
        for p, spec in zip(params["layers"], model.specs):
            xi = x.clone().requires_grad_()
            (y, aux), fwd = _counted(mesh, lambda: _layer_forward(
                p, spec, shard.layer_cfg, xi, pos, enc, shard))
            _, bwd = _counted(mesh, lambda: (y.sum() + aux).backward())
            rows.append({"spec": (spec.mixer, spec.ff), "forward": fwd, "backward": bwd})
        out[arch] = {"layers": rows}
        if enc is not None:
            frames = enc.clone().requires_grad_()
            e, fwd = _counted(mesh, lambda: model.run_encoder(params, frames, shard))
            _, bwd = _counted(mesh, lambda: e.sum().backward())
            out[arch]["encoder"] = {"layers": cfg.encoder_layers, "forward": fwd,
                                    "backward": bwd, "spec": (ENC_SPEC.mixer, ENC_SPEC.ff)}
    return out


def mixer_cases(archs):
    """The 2-rank world of the mixers file: ``family_cases`` of ``archs``
    and ``layer_collectives`` of every family of both files."""
    out = family_cases(archs)
    out["layer_collectives"] = layer_collectives(MLA_ARCHS + MIXER_ARCHS)
    return out


def xlstm_mesh_cases(tmpdir):
    """On a world of 4 ranks, (data 2, model 2): xlstm trains ``TP_STEPS``
    steps (as ``family_cases``), and its seed-0 slices are saved through the
    mesh and restored onto it (the checkpoint through the sLSTM's and the
    mLSTM's column orders)."""
    torch.set_num_threads(1)
    arch = "xlstm-1.3b"
    cfg = configs.smoke_config(arch)
    out = {arch: train_run(arch, MESH, {}, synthetic_batches(cfg, TP_STEPS), whole=True,
                           grad0=True)}
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    shard = TrainSharding(cfg, mesh, B)
    params = shard.params(build_model(cfg, device="cpu"), 0)
    path = os.path.join(tmpdir, "xlstm_sharded.npz")
    save_checkpoint(path, params, step=2, shard=shard)
    mesh.barrier()
    restored, step = load_checkpoint(path, params, shard=shard)
    out["checkpoint"] = {"restored_equal": all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_paths(restored), tree_paths(params))),
        "step": step}
    return out
