"""The perf hill-climb variants of the dry-run (the port's twin of
``repro.launch.perf_runs``): the reference's nine tagged runs of pairs 1-5
through the port's ``run_one``, their artifacts beside the baselines so
``launch/roofline.py`` prints before / after rows. The reference's
``serving_mesh((32, 8))`` and ``(64, 4)`` of pair 2 are virtual meshes
here (``make_virtual_mesh``, the meta device).

    PYTHONPATH=src python -m repro_torch.launch.perf_runs [--only pair1|...|pair5]
"""
from __future__ import annotations

import argparse
import os

from repro_torch.launch.dryrun import ARTIFACT_DIR, run_one
from repro_torch.launch.mesh import make_virtual_mesh


def serving_mesh(shape, axes=("data", "model")):
    """Rank 0 of a virtual (data, model) mesh of ``shape``."""
    return make_virtual_mesh(dict(zip(axes, shape)))


def runs():
    """The nine (pair, run_one keywords) of the reference, in its order."""
    out = []
    # ---- pair 1: deepseek-v3-671b x train_4k (MoE EP + CE gather) ----------
    out += [
        ("pair1", dict(arch="deepseek-v3-671b", shape_name="train_4k", mesh_kind="single",
                       tag="shardedmoe", options={"sharded_moe": True})),
        ("pair1", dict(arch="deepseek-v3-671b", shape_name="train_4k", mesh_kind="single",
                       tag="onehotce", options={"onehot_ce": True})),
        ("pair1", dict(arch="deepseek-v3-671b", shape_name="train_4k", mesh_kind="single",
                       tag="shardedmoe+onehotce",
                       options={"sharded_moe": True, "onehot_ce": True})),
    ]
    # ---- pair 2: qwen2.5-32b x decode_32k (serving-mesh reshape) -----------
    out += [
        ("pair2", dict(arch="qwen2.5-32b", shape_name="decode_32k", mesh_kind="single",
                       tag="mesh32x8", mesh_override=serving_mesh((32, 8)))),
        ("pair2", dict(arch="qwen2.5-32b", shape_name="decode_32k", mesh_kind="single",
                       tag="mesh64x4", mesh_override=serving_mesh((64, 4)))),
    ]
    # ---- pair 3: llama4-scout x long_500k (context-parallel decode) --------
    out += [
        ("pair3", dict(arch="llama4-scout-17b-a16e", shape_name="long_500k",
                       mesh_kind="single", tag="cpdecode", options={"cp_decode": True})),
    ]
    # ---- pair 5: serve-time expert parallelism over the full mesh ----------
    # 256 experts over data x model = 256 ranks: one expert a rank
    out += [
        ("pair5", dict(arch="deepseek-v3-671b", shape_name="decode_32k", mesh_kind="single",
                       tag="ep256", rules_overrides={"experts": ("data", "model")})),
    ]
    # ---- pair 4: recurrent time-scan chunking --------------------------------
    out += [
        ("pair4", dict(arch="xlstm-1.3b", shape_name="train_4k", mesh_kind="single",
                       tag="timeremat")),
        ("pair4", dict(arch="jamba-v0.1-52b", shape_name="train_4k", mesh_kind="single",
                       tag="timeremat")),
    ]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    args = ap.parse_args()
    for pair, kw in runs():
        if args.only and args.only != pair:
            continue
        r = run_one(out_dir=args.out, **kw)
        extra = r.get("error", "")[:200] if r["status"] == "error" else (
            f"flops={r.get('flops_loopaware', 0):.3g} "
            f"coll={sum(r.get('collectives_loopaware', {}).values()):.3g} "
            f"mem/dev={(r['memory']['argument_bytes'] + r['memory']['temp_bytes'])/2**30:.1f}GiB"
            if r["status"] == "ok" else "")
        print(f"[{r['status']:7s}] {kw['arch']} {kw['shape_name']} tag={kw['tag']} {extra}",
              flush=True)


if __name__ == "__main__":
    main()
