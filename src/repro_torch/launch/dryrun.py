"""Dry-run: one rank's cost of every (arch x input shape) on the production
mesh, on the meta device over a virtual mesh (the port's twin of
``repro.launch.dryrun``).

The reference lowers and compiles each step for a 256- or 512-device mesh
of forced host devices and reads XLA's memory and cost analyses. Here a
rank is a process (``launch/mesh.py``), so the dry-run builds rank 0's
``Step`` (``launch/steps.py``) over a virtual production mesh
(``make_virtual_mesh``: one process, no process group, collectives that
return tensors of the right shape and count calls and bytes as a real
mesh's do) on the meta device (shapes, no memory, no arithmetic), draws
the rank's parameters, cache and rows, and runs the step once under
``launch/op_cost.OpCost``. It never touches a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

One JSON per run lands in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys: ``status``; ``lower_s`` (building the step and
drawing the rank's arguments) and ``compile_s`` (running it under the
counter); ``flops``, ``bytes_accessed`` and the ``*_loopaware`` fields
(the same counts: the counter multiplies each time loop's step by its
trip count, so ``unknown_loops`` is 0); ``memory``: ``argument_bytes``
(the rank's parameters, cache and inputs, each storage once),
``output_bytes`` (the storages the step returns that are not arguments:
logits, a state mixer's new states, gradients), ``temp_bytes`` (the
counter's peak of live storages made inside the step) and
``generated_code_bytes: 0``; ``collective_bytes`` (per kind, summed over
the mesh's groups) and ``hlo_collective_ops`` (the calls). Beyond the
reference's keys: ``kernel_launches`` (``flash_prefill`` calls a rank),
``whole`` (the widths the model group holds whole, ``tp_layout``) and
``assumptions``. A MoE layer on the meta device routes nothing: its
counts assume a balanced routing capped at the capacity
(``models/moe.py::_local_counts``), and follow the port's routed rows
(each expert's kept tokens), not the reference's dense capacity dispatch,
which runs every slot (16x the routed flops at deepseek-v3's 256 experts,
top-8, capacity factor 2; PERF.md).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import make_virtual_mesh, production_shape
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.steps import build_step

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter"}


def _storages(tree) -> Dict[int, int]:
    """storage key -> bytes of every tensor in a tree (dicts, lists,
    tuples), each storage once."""
    out: Dict[int, int] = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    walk(tree)
    return out


def _groups(mesh):
    """Each distinct group of the mesh once."""
    seen = {}
    for g in mesh.groups.values():
        seen[id(g)] = g
    return list(seen.values())


def collective_counts(mesh) -> Dict[str, Dict[str, float]]:
    """{"bytes": per kind, "calls": per kind} summed over the mesh's groups."""
    nbytes: Dict[str, float] = {}
    calls: Dict[str, float] = {}
    for g in _groups(mesh):
        for attr, kind in KINDS.items():
            n = getattr(g, attr + "s")
            if n:
                calls[kind] = calls.get(kind, 0) + n
                nbytes[kind] = nbytes.get(kind, 0) + getattr(g, attr + "_bytes")
    return {"bytes": nbytes, "calls": calls}


def step_arguments(step, seed: int = 0):
    """The rank's arguments of ``step``: (params, args after params) as
    ``step.fn`` takes them, on the step's device."""
    dev = step.mesh.device
    params = step.params(seed)
    rows = step.rows({k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                      for k, v in step.inputs.items()})
    if step.kind == "train":
        return params, (rows,)
    B = rows["tokens"].shape[0]
    cache = step.init_cache()
    if step.kind == "prefill":
        cache_len = torch.zeros((B,), dtype=torch.long, device=dev)
        extras = {k: v for k, v in rows.items() if k != "tokens"}
        return params, (rows["tokens"], cache, cache_len, extras or None)
    cache_len = torch.full((B,), step.max_seq - 512, dtype=torch.long, device=dev)
    return params, (rows["tokens"], cache, cache_len)


def measure(step, seed: int = 0) -> dict:
    """Build the rank's arguments of ``step`` and run it once under the
    counter: the artifact's numbers (without the status)."""
    t0 = time.time()
    params, args = step_arguments(step, seed)
    arg_st = _storages((params, args))
    for g in _groups(step.mesh):
        g.reset_counts()
    t1 = time.time()
    counter = OpCost()
    with counter:
        out = step.fn(params, *args)
    t2 = time.time()
    out_st = {k: v for k, v in _storages(out).items() if k not in arg_st}
    coll = collective_counts(step.mesh)
    tot = counter.totals()
    return {
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "flops": tot["flops"],
        "bytes_accessed": tot["bytes"],
        "flops_loopaware": tot["flops"],
        "eltwise_loopaware": tot["eltwise"],
        "bytes_loopaware": tot["bytes"],
        "transcendentals_loopaware": tot["transcendentals"],
        "collectives_loopaware": coll["bytes"],
        "unknown_loops": 0,
        "memory": {"argument_bytes": sum(arg_st.values()),
                   "output_bytes": sum(out_st.values()),
                   "temp_bytes": counter.peak_bytes,
                   "generated_code_bytes": 0},
        "collective_bytes": coll["bytes"],
        "collective_calls": coll["calls"],
        "hlo_collective_ops": int(sum(coll["calls"].values())),
        "kernel_launches": {"flash_prefill": int(counter.calls.get("flash_prefill", 0))},
    }


def run_one(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
            rules_overrides: Optional[dict] = None, tag: str = "", options=None,
            mesh_override=None) -> dict:
    """One (arch, shape, mesh) row: rank 0 of the production mesh ("single":
    (data 16, model 16); "multi": (pod 2, data 16, model 16)), or of
    ``mesh_override`` (a virtual mesh), with the rules' overrides and
    options; written to ``out_dir`` and returned."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.long_context_ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": "full-attention arch (DESIGN §4)"}
    mesh = mesh_override if mesh_override is not None else make_virtual_mesh(
        production_shape(multi_pod=mesh_kind == "multi"))
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "mesh_shape": dict(mesh.shape), "tag": tag}
    try:
        step = build_step(cfg, shape, mesh, rules_overrides, options)
        plan = step.shard if step.shard is not None else step.sharding
        result.update(status="ok", **measure(step))
        result["whole"] = list(plan.layout.whole) if plan is not None else []
        assumptions = ["cache_len = seq_len (decode), 0 (prefill)"]
        if any(s.ff == "moe" for s in cfg.layer_specs()):
            assumptions.append("MoE: balanced routing capped at capacity; routed rows only")
        result["assumptions"] = assumptions
    except Exception as e:
        result.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch}__{shape_name}__{mesh_kind}{suffix}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=2)
    return result


def describe(r: dict) -> str:
    if r["status"] == "ok":
        gb = (r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]) / 2**30
        return (f"flops={r['flops']:.3g} mem/dev={gb:.2f}GiB "
                f"lower={r['lower_s']}s compile={r['compile_s']}s")
    if r["status"] == "error":
        return r["error"][:200]
    return r.get("reason", "")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--opts", default="",
                    help="comma-separated rules options, e.g. sharded_moe,cp_decode")
    args = ap.parse_args()
    options = {k: True for k in args.opts.split(",") if k} or None

    archs = list(configs.ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                r = run_one(arch, shape, mesh_kind, args.out, tag=args.tag, options=options)
                print(f"[{r['status']:7s}] {arch:26s} {shape:12s} {mesh_kind:6s} {describe(r)}",
                      flush=True)


if __name__ == "__main__":
    main()
