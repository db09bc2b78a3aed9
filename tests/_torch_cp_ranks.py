"""Rank-side work of the port's context-parallel decode tests, run by
``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo (one intra-op
thread per rank). Imports neither JAX nor ``repro``: the test process
holds the ranks' results against JAX's dense decode itself. Weights and
tokens arrive as numpy; every rank prefills the whole cache with the
port's ``extend`` (cheap at smoke width), keeps its slice of the sequence
(``specs.shard_cache``) and decodes with its data group as ``cp``."""
import torch

from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import cache_axes_tree, shard_cache
from repro_torch.launch.steps import build_step
from repro_torch.models import build_model
from repro_torch.models.model import fill_ring
from repro_torch.sharding.rules import Rules, use_rules
from repro_torch.tree import tree_map

WORLD = 4
MESH = {"data": WORLD, "model": 1}
# the reference test's CP rules (tests/test_distributed.py)
CP_RULES = {"batch": None, "kv_seq": "data"}


def _prefill(model, params, toks, S, W):
    cache = model.init_cache(toks.shape[0], W)
    _, cache = model.extend(params, torch.from_numpy(toks[:, :S]), cache,
                            torch.zeros(toks.shape[0], dtype=torch.long))
    return cache


def dense_case(arch, values, toks, S, W, steps):
    """``Model.decode`` of ``steps`` tokens after an S-token prefill into a
    W-slot cache, each attention cache cut over the 4 ranks: per step the
    logits and the all-reduces the data group counted, then the rank's
    attention K slices."""
    torch.set_num_threads(1)
    cfg = configs.smoke_config(arch)
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    model = build_model(cfg, device="cpu")
    params = tree_map(torch.from_numpy, values)
    rules = Rules(mesh.shape, CP_RULES, {"cp_decode": True})
    axes, _ = cache_axes_tree(model, toks.shape[0], W)
    cache = shard_cache(model, _prefill(model, params, toks, S, W), mesh, rules, axes)
    out = {"logits": [], "all_reduces": [], "index": mesh.batch.index}
    for t in range(steps):
        mesh.batch.reset_counts()
        with use_rules(rules):
            lg, cache = model.decode(params, torch.from_numpy(toks[:, S + t:S + t + 1]), cache,
                                     torch.full((toks.shape[0],), S + t), cp=mesh.batch)
        out["logits"].append(lg.numpy())
        out["all_reduces"].append((mesh.batch.all_reduces, mesh.batch.all_reduce_bytes))
    out["k"] = [c["k"].numpy() for c in cache if "k" in c]
    return out


def _one_process(model, params, toks, S, W, window_ring, rules):
    cache = _prefill(model, params, toks, S, W)
    if window_ring:
        cache = fill_ring(model.init_cache(toks.shape[0], W, window_ring=True), cache, S)
    with use_rules(rules):
        lg, _ = model.decode(params, torch.from_numpy(toks[:, S:S + 1]), cache,
                             torch.full((toks.shape[0],), S))
    return lg.numpy()


def step_case(arch, toks, S, options):
    """``build_step``'s decode of one sequence (``mode_rules``: the KV
    sequence over data, so "cp_decode" cuts it 4 ways) against
    ``Model.decode`` on the whole cache in this rank: (step logits, one
    process's, the cp group's size, the rank's first attention K width,
    whether its ring stayed whole)."""
    torch.set_num_threads(1)
    cfg = configs.smoke_config(arch)
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    step = build_step(cfg, InputShape("cp_probe", S, 1, "decode"), mesh, options=options)
    params = step.params(0)
    whole = _prefill(step.model, params, toks, S, step.max_seq)
    if step.window_ring:
        whole = fill_ring(step.model.init_cache(1, step.max_seq, window_ring=True), whole, S)
    cache = step.shard_cache(whole)
    lg, cache = step.fn(params, torch.from_numpy(toks[:, S:S + 1]), cache,
                        torch.full((1,), S))
    one = _one_process(step.model, params, toks, S, step.max_seq, step.window_ring,
                       step.rules)
    return {"logits": lg.numpy(), "one": one, "cp": None if step.cp is None else step.cp.size,
            "width": cache[0]["k"].shape[1], "ring_whole": bool(step.window_ring)
            and cache[0]["k"].shape[1] == min(step.max_seq, cfg.sliding_window + 512)}


def mla_refused():
    """deepseek-v3's smoke decode under ``cp``: the message it raises."""
    torch.set_num_threads(1)
    cfg = configs.smoke_config("deepseek-v3-671b")
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    cache = model.init_cache(1, 16)
    try:
        model.decode(params, torch.zeros((1, 1), dtype=torch.long), cache,
                     torch.zeros(1, dtype=torch.long), cp=mesh.batch)
    except NotImplementedError as e:
        return str(e)
    return None


def run_all(cases, toks_step):
    """Every case of the test on this rank: the dense CP decodes, the
    ``build_step``'s (plain and ring), MLA's refusal."""
    out = {"dense": {arch: dense_case(arch, *args) for arch, args in cases.items()}}
    out["step"] = {
        "llama4": step_case("llama4-scout-17b-a16e", toks_step, 40, {"cp_decode": True}),
        "starcoder2 ring": step_case("starcoder2-3b", toks_step, 40,
                                     {"cp_decode": True, "window_ring": True})}
    out["mla"] = mla_refused()
    return out


