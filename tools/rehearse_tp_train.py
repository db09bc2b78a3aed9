#!/usr/bin/env python
"""``chip_smoke.py`` phase 12d on the CPU: each family it trains on (data
1, model 2) at narrow widths with the published structure (its layers,
the vocabulary's parity, whether KV heads are cut, whether the sLSTM's FFN
units split), two gloo ranks against one process, through the phase's own
functions.

    PYTHONPATH=src python tools/rehearse_tp_train.py
    PYTHONPATH=src python tools/rehearse_tp_train.py --dtype bfloat16

By default (each family in the phase's dtype, d_model 96, S=16) it prints
the phase's lines (the byte counts are the slices' own: the CPU has no
allocator statistics) and each family's collectives of one ``grads_of``,
which depend on the structure alone. ``--dtype bfloat16`` runs every
family in bf16 at d_model 192, S=128, and prints instead, for each held
leaf, how far the ranks' gradient is from one bf16 process's and how far
one bf16 process's is from one f32 process's (relative Frobenius): where
the second is near the phase's 5% bound, bf16 rounding alone decides it.
"""
import argparse
import dataclasses
import os
import sys
import types

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.loop import grads_of  # noqa: E402
from repro_torch.train.sharding import tree_at  # noqa: E402

_published = c.tp_family_config
# --dtype: every family in it, wider and longer (set in the environment, so
# the ranks, which import this module again, read it too)
DTYPE = os.environ.get("REHEARSE_TP_DTYPE")


def narrow(arch, dtype):
    """The phase's cut of ``arch`` at d_model 96 (192 with ``DTYPE``: the
    sLSTM's FFN 128 or 256 units wide, which split over 2 ranks as its
    published 2730 do), 4 heads of 24, KV heads 4 where the published
    count is even."""
    cfg, cut = _published(arch, DTYPE or dtype)
    return dataclasses.replace(
        cfg, d_model=192 if DTYPE else 96, num_heads=4,
        num_kv_heads=4 if cfg.num_kv_heads % 2 == 0 else 1, head_dim=24, d_ff=128,
        moe_d_ff=64, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
        v_head_dim=8, n_audio_ctx=32, num_image_tokens=16), cut


# the phase on the CPU: the narrow configs, every tensor on the CPU, no
# allocator statistics; set when this module is imported, so the ranks run
# the same
c.tp_family_config = narrow
c.build_model = lambda cfg, device=None: build_model(cfg, device="cpu")
_to_device = c.train_mod.to_device
c.train_mod.to_device = lambda batch, device: _to_device(batch, "cpu")
c.torch = types.SimpleNamespace(**{n: getattr(torch, n) for n in dir(torch)
                                   if not n.startswith("__")})
c.torch.cuda = types.SimpleNamespace(synchronize=lambda *a: None,
                                     reset_peak_memory_stats=lambda *a: None,
                                     empty_cache=lambda: None)
c.device_bytes = c.peak_device_bytes = lambda: (0, 0)
c.TP_FAMILY_SEQ = 128 if DTYPE else 16
c.TP_FAMILY_REF = os.path.join(ROOT, "build", "rehearse_tp_train_ref.pt")


def rank(path):
    torch.set_num_threads(1)
    mesh = c.make_mesh(c.MESH_B, backend="gloo", device="cpu")
    refs = torch.load(path, weights_only=False)
    out = dict(rank=mesh.rank, tp_launches={n: k.launches for n, k in c.COUNTERS.items()})
    out["families"] = {label: c.tp_family_rank(mesh, label, *rest, refs[label])
                       for label, *rest in c.TP_FAMILIES}
    return out


def f32_gap(arch, dtype, paths):
    """Per held leaf, one ``DTYPE`` process's gradient against one f32
    process's from the same seed-0 weights and batch (relative Frobenius)."""
    cfg, _ = narrow(arch, dtype)
    grads = []
    for dt in (cfg.dtype, "float32"):
        model = build_model(dataclasses.replace(cfg, dtype=dt, param_dtype=dt), device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in c.tp_family_batch(cfg).items()}
        grads.append(grads_of(model, model.init(0, c.TP_FAMILY_SEQ), batch)[0])
    out = {}
    for p in paths:
        a, b = (tree_at(g, p).float() for g in grads)
        out["/".join(p)] = float((a - b).norm() / b.norm())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    args = ap.parse_args()
    if args.dtype and DTYPE != args.dtype:  # again, with the ranks reading it
        os.environ["REHEARSE_TP_DTYPE"] = args.dtype
        os.execv(sys.executable, [sys.executable] + sys.argv)
    torch.set_num_threads(1)
    refs = c.tp_family_refs()
    ranks = c.spawn_ranks(rank, 2, c.TP_FAMILY_REF, timeout=1800)
    if DTYPE:
        for label, arch, dtype, paths in c.TP_FAMILIES:
            ranks_err = ranks[0]["families"][label]["grad_errs"]
            gap = f32_gap(arch, dtype, paths)
            print(f"{label} ({DTYPE}): " + "; ".join(
                f"{k} ranks vs one process {ranks_err[k]:.2%}, one process vs f32 {gap[k]:.2%}"
                for k in ranks_err))
        return
    for r in ranks:  # the slices' bytes stand in for the allocator's
        for f in r["families"].values():
            held = f["memory"]["held"]
            f["memory"].update(drawn=[held, held], with_grads=[2 * held, 2 * held])
    c.hold_tp_families(ranks, refs)
    for label, f in ranks[0]["families"].items():
        t = f["timed"]
        print(f"{label}: {t['all_reduces']} all-reduces, {t['all_gathers']} all-gathers, "
              f"{t['reduce_scatters']} reduce-scatters a grads_of")


if __name__ == "__main__":
    main()
