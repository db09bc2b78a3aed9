"""Rank-side work of the port's tensor-parallel prefill / decode step tests
(``tests/test_torch_tp_steps.py``), run by
``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo (one intra-op
thread per rank). Imports neither JAX nor ``repro``: the test process holds
the ranks' results against JAX's steps and the port's one process itself.

Each case: ``build_step``'s prefill of B rows of S tokens (internvl: an
image over its first N positions), its cache copied into the decode step's
(S + DECODE_PAD slots), then STEPS decode steps of given tokens; the
logits of every step gathered over the vocab where the step cut it. Every
step's collective calls and bytes are recorded per kind, and the rank's
argument bytes (its slices, cache and rows, ``dryrun.step_arguments``)."""
import numpy as np
import torch

from repro_torch.configs import InputShape
from repro_torch.launch.dryrun import _storages, collective_counts, step_arguments
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_step

B, S, STEPS = 2, 13, 3


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.as_tensor(tree)


def _gather_vocab(step, logits):
    sh = step.sharding
    if sh is not None and sh.vocab_tp is not None:
        return sh.vocab_tp.all_gather(logits.contiguous(), -1)
    return logits


def _counts(mesh):
    c = collective_counts(mesh)
    return {"calls": c["calls"], "bytes": c["bytes"]}


def _reset(mesh):
    for g in {id(g): g for g in mesh.groups.values()}.values():
        g.reset_counts()


def run_case(cfg, mesh, tokens, extras=None, whole=None, seed=0, overrides=None):
    """Prefill then decode on this rank (``overrides``: the rules'); returns
    the gathered logits of each step (numpy; the rank's rows), the
    collectives of each step and the argument bytes."""
    pre = build_step(cfg, InputShape("p", S, B, "prefill"), mesh, overrides)
    dec = build_step(cfg, InputShape("d", S, B, "decode"), mesh, overrides)
    params = pre.params(seed) if whole is None else pre.shard_params(_to_torch(whole))
    text = tokens[:, :pre.inputs["tokens"].shape[1]]
    batch = {"tokens": torch.from_numpy(text)}
    if extras:
        batch.update({k: torch.from_numpy(v) for k, v in extras.items()})
    rows = pre.rows(batch)
    cache = pre.init_cache()
    out = {"logits": [], "collectives": [], "argument_bytes": {
        kind: sum(_storages(step_arguments(st)).values())
        for kind, st in (("prefill", pre), ("decode", dec))}}
    _reset(mesh)
    zero = torch.zeros(rows["tokens"].shape[0], dtype=torch.long)
    ex = {k: v for k, v in rows.items() if k != "tokens"} or None
    logits, cache = pre.fn(params, rows["tokens"], cache, zero, ex)
    out["collectives"].append(_counts(mesh))
    out["logits"].append(_gather_vocab(pre, logits).numpy())
    dcache = dec.init_cache()
    for layer, src in zip(dcache, cache):
        for name, t in layer.items():
            s = src[name]
            if t.shape == s.shape:
                t.copy_(s)
            else:  # a window: the prefill's S slots first
                t[:, :s.shape[1]].copy_(s)
    pos = S
    for t in range(STEPS):
        tok = dec.rows({"tokens": torch.from_numpy(tokens[:, S + t:S + t + 1])})["tokens"]
        lens = torch.full((tok.shape[0],), pos + t, dtype=torch.long)
        _reset(mesh)
        logits, dcache = dec.fn(params, tok, dcache, lens)
        out["collectives"].append(_counts(mesh))
        out["logits"].append(_gather_vocab(dec, logits).numpy())
    return out


def tp_cases(shape, cases):
    """Every case on this rank of a mesh of ``shape`` (or the case's own
    ``mesh`` over the same world) over gloo on the CPU: {name:
    run_case(...)}; a train step's collectives too for the cases that ask
    (``train``: the smoke batch of ``grads_of``)."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, backend="gloo", device="cpu")
    results = {}
    for name, case in cases.items():
        m = make_mesh(case["mesh"], backend="gloo", device="cpu") if "mesh" in case else mesh
        results[name] = run_case(case["cfg"], m, case["tokens"], case.get("extras"),
                                 case.get("whole"), overrides=case.get("overrides"))
        results[name]["coords"] = m.coords()
        if case.get("train"):
            step = build_step(case["cfg"], InputShape("t", 16, 4, "train"), mesh)
            params, args = step_arguments(step)
            rng = np.random.default_rng(1)
            batch = {k: torch.from_numpy(rng.integers(0, case["cfg"].vocab_size,
                                                      size=(4, 16)))
                     for k in ("tokens", "labels")}
            _reset(mesh)
            step.fn(params, step.rows(batch))
            results[name]["train_collectives"] = _counts(mesh)
            results[name]["argument_bytes"]["train"] = sum(_storages(
                (params, args)).values())
    return {"rank": mesh.rank, "results": results}
