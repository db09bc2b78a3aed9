"""Rank-side work of the port's context-parallel decode tests, run by
``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo (one intra-op
thread per rank). Imports neither JAX nor ``repro``: the test process
holds the ranks' results against JAX's dense decode itself. Weights and
tokens arrive as numpy; every rank prefills the whole cache with the
port's ``extend`` (cheap at smoke width), keeps its slice of the sequence
(``specs.shard_cache``) and decodes with its data group as ``cp``; the
same world also runs ``build_step``'s decodes, one on a (data 2, model 2)
mesh of its own."""
import numpy as np
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
MESH_DM = {"data": 2, "model": 2}  # MLA heads over model, latents over data
# the reference test's CP rules (tests/test_distributed.py)
CP_RULES = {"batch": None, "kv_seq": "data"}


def _prefill(model, params, toks, S, W):
    cache = model.init_cache(toks.shape[0], W)
    _, cache = model.extend(params, torch.from_numpy(toks[:, :S]), cache,
                            torch.zeros(toks.shape[0], dtype=torch.long))
    return cache


def dense_case(arch, values, toks, starts, W, steps):
    """``Model.decode`` of ``steps`` tokens after a prefill of max(starts)
    tokens into a W-slot cache, row b decoding from position starts[b] (a
    row that starts behind the prefill rewrites the slots it passes and
    masks the rest), each attention cache and MLA latent cut over the 4
    ranks: per step the logits and the all-reduces the data group counted,
    then the rank's K, ``c_kv`` and ``k_pe`` slices of each layer that has
    them."""
    torch.set_num_threads(1)
    cfg = configs.smoke_config(arch)
    mesh = make_mesh(MESH, backend="gloo", device="cpu")
    model = build_model(cfg, device="cpu")
    params = tree_map(torch.from_numpy, values)
    rules = Rules(mesh.shape, CP_RULES, {"cp_decode": True})
    B = toks.shape[0]
    starts = np.broadcast_to(np.asarray(starts), (B,))
    axes, _ = cache_axes_tree(model, B, W)
    cache = shard_cache(model, _prefill(model, params, toks, int(starts.max()), W), mesh,
                        rules, axes)
    out = {"logits": [], "all_reduces": [], "index": mesh.batch.index}
    for t in range(steps):
        pos = starts + t
        mesh.batch.reset_counts()
        with use_rules(rules):
            lg, cache = model.decode(params, torch.from_numpy(toks[np.arange(B), pos, None]),
                                     cache, torch.from_numpy(pos), cp=mesh.batch)
        out["logits"].append(lg.numpy())
        out["all_reduces"].append((mesh.batch.all_reduces, mesh.batch.all_reduce_bytes))
    for name in ("k", "c_kv", "k_pe"):
        out[name] = [c[name].numpy() for c in cache if name in c]
    return out


def _one_process(model, params, toks, S, W, window_ring, rules):
    cache = _prefill(model, params, toks, S, W)
    if window_ring:
        cache = fill_ring(model.init_cache(toks.shape[0], W, window_ring=True), cache, S)
    with use_rules(rules):
        lg, _ = model.decode(params, torch.from_numpy(toks[:, S:S + 1]), cache,
                             torch.full((toks.shape[0],), S))
    return lg.numpy()


def step_case(arch, toks, S, options, shape=MESH):
    """``build_step``'s decode of one sequence on a mesh of ``shape`` over
    the same world (``mode_rules``: the KV sequence over data, so
    "cp_decode" cuts it over the data ranks; heads over model where the
    model axis is above 1) against ``Model.decode`` on the whole cache
    with the whole weights in this rank: (step logits, gathered over the
    vocab where the step cut it; one process's; the cp group's size; the
    rank's first K or ``c_kv`` width and its first ``k_pe`` width, if any;
    whether its ring stayed whole)."""
    torch.set_num_threads(1)
    cfg = configs.smoke_config(arch)
    mesh = make_mesh(shape, backend="gloo", device="cpu")
    step = build_step(cfg, InputShape("cp_probe", S, 1, "decode"), mesh, options=options)
    whole_params = step.model.init(0, step.init_max_seq)
    whole = _prefill(step.model, whole_params, toks, S, step.max_seq)
    if step.window_ring:
        whole = fill_ring(step.model.init_cache(1, step.max_seq, window_ring=True), whole, S)
    cache = step.shard_cache(whole)
    lg, cache = step.fn(step.shard_params(whole_params), torch.from_numpy(toks[:, S:S + 1]),
                        cache, torch.full((1,), S))
    if step.sharding is not None and step.sharding.vocab_tp is not None:
        lg = step.sharding.vocab_tp.all_gather(lg.contiguous(), -1)
    one = _one_process(step.model, whole_params, toks, S, step.max_seq, step.window_ring,
                       step.rules)
    first = cache[0]["k"] if "k" in cache[0] else cache[0]["c_kv"]
    return {"logits": lg.numpy(), "one": one, "cp": None if step.cp is None else step.cp.size,
            "width": first.shape[1],
            "pe_width": cache[0]["k_pe"].shape[1] if "k_pe" in cache[0] else None,
            "ring_whole": bool(step.window_ring)
            and first.shape[1] == min(step.max_seq, cfg.sliding_window + 512)}


def run_all(cases, toks_step):
    """Every case of the test on this rank: the dense CP decodes, the
    ``build_step``'s (plain, ring, and deepseek-v3's MLA on (data 2, model
    2))."""
    out = {"dense": {arch: dense_case(arch, *args) for arch, args in cases.items()}}
    out["step"] = {
        "llama4": step_case("llama4-scout-17b-a16e", toks_step, 40, {"cp_decode": True}),
        "starcoder2 ring": step_case("starcoder2-3b", toks_step, 40,
                                     {"cp_decode": True, "window_ring": True}),
        "deepseek (2, 2)": step_case("deepseek-v3-671b", toks_step, 40, {"cp_decode": True},
                                     MESH_DM)}
    return out
