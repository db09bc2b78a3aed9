"""Training driver of the port (the single-device part of
``repro.launch.train``): random weights from seed 0, ``SyntheticLM``
batches from seed 0, AdamW with 10 warmup steps of a cosine schedule,
one card.

    python -m repro_torch.launch.train --arch olmo-1b --steps 20 --batch 8 --seq 128
    python -m repro_torch.launch.train --arch olmo-1b --debug --device cpu --steps 20

``--debug`` takes the reduced smoke config. ``--device`` defaults to
``cuda`` and raises where CUDA is absent (no CPU fallback). Prints
``step``, ``ce``, ``lr`` and tokens/s every 10 steps and at the last;
``--ckpt PATH`` saves the trained parameters (``checkpoint/ckpt.py``).
Batches hold tokens and labels only, as the reference's driver makes
them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import SyntheticLM, make_batches
from repro_torch.models import build_model
from repro_torch.train.loop import init_train_state, make_train_step


def to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train(cfg, *, steps: int, batch: int, seq: int, device="cuda", ckpt: str = "",
          base_lr: float = 3e-4, warmup_steps: int = 10, log=print):
    """``cfg`` trained for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device``, as the command line runs it, with one host read of the
    metrics a step (so each step's wall time ends when the device has
    finished it). Returns (state, one record per step: its metrics as
    floats and ``seconds``, the step's wall time)."""
    model = build_model(cfg, device=device)
    state = init_train_state(model, 0, max_seq=seq)
    step_fn = make_train_step(model, base_lr=base_lr, warmup_steps=warmup_steps,
                              total_steps=steps)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)
    records = []
    t0 = time.perf_counter()
    for i, b in enumerate(make_batches(ds, batch, steps)):
        t = time.perf_counter()
        state, metrics = step_fn(state, to_device(b, model.device))
        rec = {k: float(v) for k, v in metrics.items()}
        rec["seconds"] = time.perf_counter() - t
        records.append(rec)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d} ce={rec['ce']:.3f} lr={rec['lr']:.2e} "
                f"tok/s={(i + 1) * batch * seq / (time.perf_counter() - t0):.0f}")
    if ckpt:
        save_checkpoint(ckpt, state.params, step=steps)
        log(f"checkpoint -> {ckpt}")
    return state, records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--debug", action="store_true", help="the reduced smoke config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="")
    args = ap.parse_args()
    cfg = configs.smoke_config(args.arch) if args.debug else configs.get_config(args.arch)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=args.device,
          ckpt=args.ckpt)


if __name__ == "__main__":
    main()
