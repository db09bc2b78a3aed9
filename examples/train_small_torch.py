"""Train a ~100M-param dense model on synthetic data with the PyTorch port.
The twin of ``examples/train_small.py``: the same flags, config, seeds,
schedule and report, plus ``--device`` (``cuda`` by default; raises where
CUDA is absent, ``--device cpu`` runs on the CPU).

    python examples/train_small_torch.py --steps 300 [--device cpu]

Uses a custom ~100M config (olmo-family), AdamW + cosine schedule,
checkpoint save. The step runs eagerly (the port has no jit); on a mesh of
ranks the same step runs through ``python -m repro_torch.launch.train
--dp N --tp M``.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs.base import dense_stages  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.loop import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# a file of its own: the JAX example writes /tmp/repro_100m.npz
CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_100m.npz")


def make_100m():
    base = configs.get_config("olmo-1b")
    return dataclasses.replace(
        base, name="olmo-100m", stages=dense_stages(12), d_model=768,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=16384, dtype="float32", param_dtype="float32")


def run(cfg, device, steps=300, batch=8, seq=128, ckpt=CKPT) -> dict:
    """Returns the printed numbers (one record per printed step) and, under
    ``params``, the trained tree that the checkpoint holds."""
    model = build_model(cfg, device=device)
    state = init_train_state(model, seed=0)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M")

    step_fn = make_train_step(model, base_lr=3e-4, warmup_steps=20, total_steps=steps)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)
    records = []
    t0 = time.time()
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=model.device) for k, v in ds.batch(batch).items()}
        state, metrics = step_fn(state, b)
        if i % 20 == 0 or i == steps - 1:
            toks = batch * seq * (i + 1)
            rec = dict(step=i, ce=float(metrics["ce"]), lr=float(metrics["lr"]),
                       gnorm=float(metrics["grad_norm"]), tok_s=toks / (time.time() - t0))
            records.append(rec)
            print(f"step {i:4d}  ce={rec['ce']:.3f}  "
                  f"lr={rec['lr']:.2e}  "
                  f"gnorm={rec['gnorm']:.2f}  "
                  f"{rec['tok_s']:.0f} tok/s")
    save_checkpoint(ckpt, state.params, step=steps)
    print(f"checkpoint -> {ckpt}")
    return dict(name=cfg.name, params_count=n_params, records=records, ckpt=ckpt,
                seconds=time.time() - t0, params=state.params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(make_100m(), args.device, steps=args.steps, batch=args.batch,
               seq=args.seq, ckpt=args.ckpt)


if __name__ == "__main__":
    main()
