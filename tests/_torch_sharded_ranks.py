"""Rank-side work of the port's tensor-parallel tests, run by
``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo (one intra-op
thread per rank). Imports neither JAX nor ``repro``: the test process
draws the weights and adapters with JAX and hands them over as numpy
trees, and holds the ranks' results against JAX's engine itself."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import (EngineConfig, LLMEngine, LoRAConfig, QuantConfig, Request,
                              SamplingParams, SchedulerConfig, SpeculativeConfig)
from repro_torch.kernels.paged_attention import paged_attention as kmod
from repro_torch.core.executor.sharded import rank_params, shard_params
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import attention, build_model
from repro_torch.models.convert import convert_params
from repro_torch.models.model import mlp_apply
from repro_torch.sharding import ShardingConfig

LORA = dict(rank=4, alpha=8.0, max_loaded_adapters=4)
SPEC_K = 3


def engine_cfg(mp=0, dp=1, **kw):
    """The reference's ``_SHARDED_SCRIPT`` engine settings on the CPU."""
    base = dict(block_size=8, num_blocks=128, num_state_slots=16, max_model_len=128,
                device="cpu",
                sharding=ShardingConfig(model_axis=mp, data_axis=dp) if mp else None,
                scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=48,
                                          prefill_chunk=16))
    base.update(kw)
    return EngineConfig(**base)


def drive(model, params, cfg, prompts, max_new=6, adapters=None, aids=None):
    eng = LLMEngine(model, params, cfg)
    for aid, w in (adapters or {}).items():
        eng.register_adapter(aid, w)
    for i, pr in enumerate(prompts):
        eng.add_request(Request(request_id=f"r{i}", prompt=list(pr),
                                adapter_id=aids[i] if aids else None,
                                sampling=SamplingParams(max_new_tokens=max_new)))
    eng.run()
    return eng


def streams(eng):
    return {rid: list(s.generated) for rid, s in eng.seqs.items()}


def fallback_config():
    """olmo-1b's smoke config at 6 heads over 3 KV heads: at a model axis
    of 2 the KV heads stay replicated and the q-side heads permute."""
    return dataclasses.replace(configs.smoke_config("olmo-1b"), num_heads=6,
                               num_kv_heads=3)


def on_mesh(mesh, cfg, params):
    """The ``engine_cfg`` mesh arguments and the params for an engine on
    ``mesh`` (None: one device, the whole tree)."""
    if mesh is None:
        return {}, params
    return (dict(mp=mesh.shape["model"], dp=mesh.shape["data"]),
            shard_params(params, cfg, mesh))


def scenarios(cfg, params, fb_cfg, fb_params, prompts, adapters, meshes,
              after_fp=lambda: None):
    """The five traces, each on a fresh engine: fp, KIVI 8-bit, mixed LoRA
    (a0, a1, None), speculative k = 3 (self-speculation: on a mesh the
    whole target is handed over as the draft), and the GQA fallback config
    on its own prompts (``meshes`` maps "fp", every trace but the
    fallback's, and "fallback" to a serving mesh: {} on one device; a
    sharded engine gets the rank's slices of the weights). ``after_fp``
    runs right after the fp trace. Returns the streams by trace and the fp
    and fallback engines."""
    model = build_model(cfg, device="cpu")
    mesh_kw, local = on_mesh(meshes.get("fp"), cfg, params)
    draft = dict(draft_model=model, draft_params=params) if mesh_kw else {}
    out, engines = {}, {}
    engines["fp"] = drive(model, local, engine_cfg(**mesh_kw), prompts)
    out["fp"] = streams(engines["fp"])
    after_fp()
    out["kivi8"] = streams(drive(model, local, engine_cfg(
        **mesh_kw, kv_quant=QuantConfig(bits=8)), prompts))
    out["lora"] = streams(drive(model, local, engine_cfg(**mesh_kw, lora=LoRAConfig(**LORA)),
                                prompts, adapters=adapters, aids=["a0", "a1", None]))
    out["spec"] = streams(drive(model, local, engine_cfg(
        **mesh_kw, speculative=SpeculativeConfig(num_draft_tokens=SPEC_K, **draft)), prompts))
    fb_model = build_model(fb_cfg, device="cpu")
    fb_kw, fb_local = on_mesh(meshes.get("fallback"), fb_cfg, fb_params)
    engines["fallback"] = drive(fb_model, fb_local, engine_cfg(**fb_kw),
                                [p[:16] for p in prompts], max_new=4)
    out["fallback"] = streams(engines["fallback"])
    return out, engines


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


def local_heads(params):
    """(query heads, KV heads) a layer of a parameter tree holds."""
    m = params["layers"][0]["mixer"]
    return m["wq"]["w"].shape[1], m["wk"]["w"].shape[1]


def serve_sharded(values, fb_values, prompts, adapters, kv_bytes_1):
    """One rank: the five traces at model axis 4 (the GQA fallback at
    data 2 x model 2 over the same four ranks). Returns the streams and,
    per engine, what the tests hold: runner kind, KV / ff sharding,
    host_copy_bytes, the capacity ratio against one device's store, the
    all-reduces against 2 x layers x paged steps."""
    torch.set_num_threads(1)
    mesh14 = make_serving_mesh(1, 4, backend="gloo", device="cpu")
    mesh22 = make_serving_mesh(2, 2, device="cpu")
    cfg, fb_cfg = configs.smoke_config("olmo-1b"), fallback_config()
    fp_reduces = []
    out, engines = scenarios(cfg, convert_params(cfg, values), fb_cfg,
                             convert_params(fb_cfg, fb_values), prompts, adapters,
                             {"fp": mesh14, "fallback": mesh22},
                             after_fp=lambda: fp_reduces.append(mesh14.model.all_reduces))
    info = {}
    for name, eng in engines.items():
        r = eng.paged_runner
        info[name] = dict(runner=type(r).__name__, gathered=eng.runner is not None,
                          heads=local_heads(eng.params), kv_sharded=r.kv_sharded,
                          ff_sharded=r.ff_sharded, permuted=r.layout.head_order is not None,
                          host_copy_bytes=eng.host_copy_bytes,
                          capacity=kv_bytes_1[name] / r.device_kv_bytes_per_block(),
                          paged_steps=eng.paged_steps, layers=eng.model.cfg.num_layers)
    info["fp"]["all_reduces"] = fp_reduces[0]
    info["fallback"]["all_reduces"] = mesh22.model.all_reduces
    info["model_group"] = {"model=4": mesh14.model.ranks, "data=2 model=2": mesh22.model.ranks}
    # the rank's slices drawn layer by layer equal the slices of the whole
    # init: olmo (GLU w1 order), the fallback (head order), qwen (qkv biases)
    info["rank_params"] = {}
    for c, mesh in ((cfg, mesh14), (fb_cfg, mesh22),
                    (configs.smoke_config("qwen2.5-32b"), mesh22)):
        model = build_model(c, device="cpu")
        info["rank_params"][c.name, c.num_heads] = same_tree(
            rank_params(model, 3, mesh=mesh), shard_params(model.init(3), c, mesh))
    return out, info


# ---------------------------------------------------------------------------
# the TP branches of proj_out_lora and mlp_apply
# ---------------------------------------------------------------------------

def tp_branches(inputs):
    """One rank of 2: ``proj_out_lora`` over this rank's heads (x, wo rows,
    the wo adapter's A rows) and ``mlp_apply`` over this rank's hidden units
    (w1's [u_i ; g_i] columns and bias, the w1 adapter's B columns, w2's
    rows and the w2 adapter's A rows), each with the replicated bias.
    Returns both outputs, the rank's all-reduce count and its bytes."""
    torch.set_num_threads(1)
    mesh = make_serving_mesh(1, 2, backend="gloo", device="cpu")
    tp = mesh.model
    i, n = tp.index, tp.size
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    H, f = t["wo_w"].shape[0], t["w2_w"].shape[0]
    hl, fl = H // n, f // n
    heads = slice(i * hl, (i + 1) * hl)
    hd = t["x_attn"].shape[-1]
    flat = slice(i * hl * hd, (i + 1) * hl * hd)
    units = slice(i * fl, (i + 1) * fl)
    cols = torch.cat([torch.arange(i * fl, (i + 1) * fl), f + torch.arange(i * fl, (i + 1) * fl)])
    ids = t["ids"]
    attn_out = attention.proj_out_lora(
        {"w": t["wo_w"][heads].contiguous(), "b": t["wo_b"]},
        t["x_attn"][:, :, heads].contiguous(),
        {"wo": {"a": t["wo_a"][:, flat].contiguous(), "b": t["wo_bb"]}}, ids, tp=tp)
    cfg = dataclasses.replace(configs.smoke_config("olmo-1b"), d_ff=fl, tp_axis="model",
                              tp_ff_sharded=True)
    p = {"w1": {"w": t["w1_w"][:, cols].contiguous(), "b": t["w1_b"][cols].contiguous()},
         "w2": {"w": t["w2_w"][units].contiguous(), "b": t["w2_b"]}}
    lora = {"w1": {"a": t["w1_a"], "b": t["w1_bb"][:, :, cols].contiguous()},
            "w2": {"a": t["w2_a"][:, units].contiguous(), "b": t["w2_bb"]}}
    mlp_out = mlp_apply(p, cfg, t["x_mlp"], lora, ids, tp=tp)
    return attn_out.numpy(), mlp_out.numpy(), tp.all_reduces, tp.all_reduce_bytes


# ---------------------------------------------------------------------------
# two ranks on one card
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def smoke_requests(eng):
    """4 greedy requests of 12 tokens (``tests/test_torch_cuda.py``'s
    ``_smoke_serve`` traffic)."""
    rng = np.random.default_rng(4)
    for i in range(4):
        eng.add_request(Request(
            request_id=f"r{i}", prompt=[int(t) for t in rng.integers(
                2, eng.model.cfg.vocab_size, int(rng.integers(12, 40)))],
            sampling=SamplingParams(max_new_tokens=12)))


def serve_smoke_on_card(values, device=None):
    """One of 2 ranks sharing the card (``device`` None: the rank's card)
    over gloo: olmo-1b's smoke config in f32 with the given weights
    (numpy), model axis 2, the smoke traffic. Returns the streams, this
    rank's ``paged_attention`` launches, its paged steps and the layers."""
    mesh = make_serving_mesh(1, 2, backend="gloo", device=device)
    model = build_model(configs.smoke_config("olmo-1b"), device=mesh.device)
    params = shard_params(tree_map(torch.from_numpy, values), model.cfg, mesh)
    eng = LLMEngine(model, params, EngineConfig(
        block_size=8, num_blocks=128, max_model_len=128, device=mesh.device.type,
        sharding=ShardingConfig(model_axis=2)))
    smoke_requests(eng)
    before = kmod.paged_attention.launches
    eng.run()
    return (streams(eng), kmod.paged_attention.launches - before, eng.paged_steps,
            model.cfg.num_layers)
