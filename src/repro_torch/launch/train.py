"""The port's training command (the twin of ``repro.launch.train``): random
weights from seed 0, ``SyntheticLM`` batches from seed 0, AdamW with 10
warmup steps of a cosine schedule, on one card or on a mesh of ranks.

    python -m repro_torch.launch.train --arch olmo-1b --steps 20 --batch 8 --seq 128
    python -m repro_torch.launch.train --arch olmo-1b --debug --device cpu --steps 20
    python -m repro_torch.launch.train --debug --device cpu --dp 2 --tp 2 \\
        --dist-backend gloo --options onehot_ce --steps 2

``--debug`` takes the reduced smoke config. ``--device`` defaults to
``cuda`` and raises where CUDA is absent (no CPU fallback). Prints
``step``, ``ce``, ``lr`` and tokens/s every 10 steps and at the last;
``--ckpt PATH`` saves the trained parameters (``checkpoint/ckpt.py``).
Batches hold tokens and labels, as the reference's command makes them,
and for whisper and internvl the stubbed frontends' outputs its forward
reads (``batch_extras``: seeded random audio frames or image rows, the
same in every batch; the reference's command makes none, so its forward
finds no ``audio_frames`` / ``vision_embeds`` to read).

``--dp N --tp M`` train on the mesh (data N, model M), every architecture
at any model axis that divides its widths (``--multi-pod``
puts a pod axis of 2 in front, as the reference's flag does): the command
spawns its ranks (``launch/mesh.py::spawn_ranks``), each drawing its
slices of the weights (``train/sharding.py``) and taking its rows of every
global batch; rank 0 prints the lines above and, with ``--ckpt``, writes
the whole tree. ``--dist-backend`` is ``nccl`` (a card per rank) or
``gloo`` (ranks may share a card or run on the CPU). ``--multi-pod``
without ``--dp`` / ``--tp`` names the reference's production mesh (pod
2, data 16, model 16), 512 ranks, and stops. ``--options`` binds the
rules' options (``sharded_moe``, ``onehot_ce``), with or without a mesh.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import SyntheticLM, make_batches
from repro_torch.launch.mesh import BACKENDS, make_mesh, production_shape, spawn_ranks
from repro_torch.models import build_model
from repro_torch.sharding.rules import Rules, use_rules
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.sharding import TrainSharding

OPTIONS = ("sharded_moe", "onehot_ce")


def to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def batch_extras(cfg, batch: int, seed: int = 0) -> dict:
    """The stubbed frontends' outputs a batch of ``batch`` rows carries:
    audio frames (B, n_audio_ctx, d) for whisper, image rows (B,
    num_image_tokens, d) for internvl, N(0, 0.1^2) f32 from a numpy
    generator seeded with ``seed``; {} for the other families."""
    rng = np.random.default_rng(seed)
    rows = {"audio": ("audio_frames", cfg.n_audio_ctx),
            "vlm": ("vision_embeds", cfg.num_image_tokens)}.get(cfg.family)
    if rows is None:
        return {}
    name, n = rows
    return {name: (0.1 * rng.standard_normal((batch, n, cfg.d_model))).astype(np.float32)}


def train(cfg, *, steps: int, batch: int, seq: int, device="cuda", ckpt: str = "",
          base_lr: float = 3e-4, warmup_steps: int = 10, log=print, shard=None,
          options=None):
    """``cfg`` trained for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``, as the command line runs it, with one host read of the
    metrics a step (so each step's wall time ends when the device has
    finished it). ``shard``: a rank's ``TrainSharding`` (its rows of each
    batch; its rules' options travel with it); ``options``: rules options
    without a mesh. Returns (state, one record per step: its metrics as
    floats and ``seconds``, the step's wall time)."""
    model = build_model(cfg, device=device)
    state = init_train_state(model, 0, max_seq=seq, shard=shard)
    step_fn = make_train_step(model, base_lr=base_lr, warmup_steps=warmup_steps,
                              total_steps=steps, shard=shard)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)
    rules = Rules({}, options=options) if options else None
    records = []
    t0 = time.perf_counter()
    with use_rules(rules):
        for i, b in enumerate(make_batches(ds, batch, steps, batch_extras(cfg, batch))):
            t = time.perf_counter()
            if shard is not None:
                b = shard.rows(b)
            state, metrics = step_fn(state, to_device(b, model.device))
            rec = {k: float(v) for k, v in metrics.items()}
            rec["seconds"] = time.perf_counter() - t
            records.append(rec)
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i:4d} ce={rec['ce']:.3f} lr={rec['lr']:.2e} "
                    f"tok/s={(i + 1) * batch * seq / (time.perf_counter() - t0):.0f}")
    if ckpt:
        save_checkpoint(ckpt, state.params, step=steps, shard=shard)
        log(f"checkpoint -> {ckpt}")
    return state, records


def mesh_shape(args) -> dict:
    """The mesh the flags ask for: (pod 2,) data, model; {} for one
    process. ``--multi-pod`` alone names the reference's production mesh,
    whose 512 ranks one host does not spawn: it raises."""
    if args.dp is None and args.tp is None:
        if args.multi_pod:
            shape = production_shape(multi_pod=True)
            raise SystemExit(f"--multi-pod alone asks for the production mesh {shape}, "
                             f"{math.prod(shape.values())} ranks; give --dp / --tp for a "
                             "mesh of this host's ranks")
        return {}
    shape = {"data": args.dp or 1, "model": args.tp or 1}
    return {"pod": 2, **shape} if args.multi_pod else shape


def train_rank(args, shape):
    """One rank of the mesh: its mesh (the backend asked for, the rank's
    card or ``--device cpu``), its plan, then ``train``; rank 0 logs.
    Returns the rank's per-step records."""
    mesh = make_mesh(shape, backend=args.dist_backend,
                     device=None if args.device == "cuda" else args.device, kind="train mesh")
    if mesh.device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // math.prod(shape.values())))
    cfg = configs.smoke_config(args.arch) if args.debug else configs.get_config(args.arch)
    shard = TrainSharding(cfg, mesh, args.batch, options=parse_options(args.options),
                          max_seq=args.seq)
    log = print if mesh.rank == 0 else (lambda _: None)
    if mesh.rank == 0:
        log(f"mesh {shape} over {mesh.backend}: {mesh.batch.size} batch shards of "
            f"{shard.local_batch} rows, options {sorted(shard.rules.options)}")
    _, records = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                       device=mesh.device, ckpt=args.ckpt, log=log, shard=shard)
    return records


def parse_options(text: str) -> dict:
    names = [n for n in text.split(",") if n]
    unknown = sorted(set(names) - set(OPTIONS))
    if unknown:
        raise SystemExit(f"unknown --options {unknown}: choose from {OPTIONS}")
    return {n: True for n in names}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--debug", action="store_true", help="the reduced smoke config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--dp", type=int, default=None, help="data axis (FSDP, batch rows)")
    ap.add_argument("--tp", type=int, default=None,
                    help="model axis (heads, inner channels, hidden units, experts, vocab)")
    ap.add_argument("--multi-pod", action="store_true", help="a pod axis of 2 in front")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS)
    ap.add_argument("--options", default="", help=f"comma-separated: {', '.join(OPTIONS)}")
    args = ap.parse_args(argv)
    options = parse_options(args.options)
    shape = mesh_shape(args)
    if not shape:
        cfg = configs.smoke_config(args.arch) if args.debug else configs.get_config(args.arch)
        train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=args.device,
              ckpt=args.ckpt, options=options)
        return
    ranks = spawn_ranks(train_rank, math.prod(shape.values()), args, shape)
    differ = [r for r, recs in enumerate(ranks)
              if [x["ce"] for x in recs] != [x["ce"] for x in ranks[0]]]
    if differ:
        raise SystemExit(f"ranks {differ} report another ce than rank 0")
    print(f"{len(ranks)} ranks over {args.dist_backend}: every rank's ce equal")


if __name__ == "__main__":
    main()
