"""llama4-scout (routed + shared MoE, chunked attention, NoPE global layers)
on the port against the JAX package, on the CPU.

The smoke config has one chunked layer and one global NoPE layer (chunk 16,
4 experts at top-1 plus a shared expert, d_model 256, f32); the JAX init,
converted, gives both sides the same weights. Compared:
- the chunked mask and the plain attention against JAX's (atol 1e-5);
- ``Model.extend`` logits and written window slots against JAX's
  ``model.extend`` (atol 1e-4: f32, sums in another order over 2 layers):
  fresh rows with C > chunk_size (the chunked layer's plain branch), fresh
  rows with C <= chunk_size (the kernel's route), continuation rows crossing
  chunk boundaries and a mixed ragged batch;
- greedy streams of the port's gathered engine against JAX's
  ``LLMEngine`` (prompts over several 16-token chunks, first chunks of 32
  tokens); an all-global MoE stack on the paged backend, and with LoRA
  tenants (attention sites only) on the gathered one;
- backend selection as ``tests/test_executor.py::test_backend_fallbacks``;
- a chunked layer's queries past a chunk boundary blind to the earlier
  chunk's keys, bit for bit;
- the published config's width (one interleave block is ~10.9 B params) and
  the converter keeping the router in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import EngineConfig as JEngineConfig
from repro.core import LLMEngine as JLLMEngine
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.lora import make_adapter as jmake_adapter
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import paged_decode_supported as jpaged_supported
from repro.models import split_params
from repro_torch import configs as tconfigs
from repro_torch.core import (EngineConfig, LLMEngine, Request, SamplingParams,
                              SchedulerConfig)
from repro_torch.core.lora import LoRAConfig
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, paged_decode_supported
from repro_torch.models.convert import convert_params

ARCH = "llama4-scout-17b-a16e"
ATOL = 1e-4
W = 48


def _global(cfg):
    """The smoke stack with both layers global (MoE kept): paged-eligible."""
    spec = cfg.stages[0][0][1]
    assert spec.attn_kind == "global" and spec.ff == "moe"
    return dataclasses.replace(cfg, stages=(((spec, spec), 1),),
                               name=cfg.name + "-global")


_MODELS = {}


def _pair(all_global=False):
    """(jax cfg, jax model, jax values, port model, port params), cached."""
    if all_global not in _MODELS:
        jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
        if all_global:
            jcfg, tcfg = _global(jcfg), _global(tcfg)
        jm = jbuild_model(jcfg)
        values, _ = split_params(jm.init(jax.random.PRNGKey(0), max_seq=512))
        values = jax.device_get(values)
        tm = build_model(tcfg, device="cpu")
        _MODELS[all_global] = (jcfg, jm, values, tm, convert_params(tcfg, values))
    return _MODELS[all_global]


def test_smoke_config_is_one_chunked_and_one_global_moe_layer():
    cfg = tconfigs.smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.smoke_config(ARCH))
    assert [(s.attn_kind, s.ff) for s in cfg.layer_specs()] == \
        [("chunked", "moe"), ("global", "moe")]
    assert (cfg.chunk_size, cfg.num_experts, cfg.top_k, cfg.num_shared_experts,
            cfg.nope_on_global) == (16, 4, 1, 1, True)


# ---------------------------------------------------------------------------
# masks and plain attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,start,Sq,Sk", [(16, 0, 40, 40), (16, 10, 12, 30),
                                              (8, 5, 1, 48), (0, 3, 6, 12)])
def test_chunked_attention_matches_jax(chunk, start, Sq, Sk):
    rng = np.random.default_rng(chunk + start)
    B, H, KV, D = 2, 4, 2, 32
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    q_pos = start + np.arange(Sq)
    k_pos = np.arange(Sk)
    np.testing.assert_array_equal(
        tattn.pair_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), "chunked",
                        chunk=chunk).numpy(),
        np.asarray(jattn.pair_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), "chunked",
                                   chunk=chunk)))
    kv_valid = k_pos[None, :] < np.array([[Sk], [start + Sq]])
    got = tattn.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_pos=torch.from_numpy(q_pos),
        k_pos=torch.from_numpy(k_pos), kind="chunked", chunk=chunk, scale=D ** -0.5,
        kv_valid=torch.from_numpy(kv_valid))
    want = jattn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), kind="chunked", chunk=chunk, scale=D ** -0.5,
        kv_valid=jnp.asarray(kv_valid), q_block=8, kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_fresh_rows_take_kernel_only_inside_the_first_chunk():
    cfg = tconfigs.smoke_config(ARCH)
    chunked, glob = cfg.layer_specs()
    assert [tattn.fresh_rows_take_kernel(cfg, chunked, C) for C in (1, 16, 17, 32)] == \
        [True, True, False, False]
    assert all(tattn.fresh_rows_take_kernel(cfg, glob, C) for C in (1, 16, 17, 32))
    full = tconfigs.get_config(ARCH)
    assert tattn.fresh_rows_take_kernel(full, chunked, 512)
    assert not tattn.fresh_rows_take_kernel(full, chunked, 8193)


# ---------------------------------------------------------------------------
# model level: Model.extend against JAX's model.extend
# ---------------------------------------------------------------------------

def _windows(cfg, B, seed):
    rng = np.random.default_rng(seed)
    shape = (B, W, cfg.num_kv_heads, cfg.head_dim)
    return [{n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
            for _ in range(cfg.num_layers)]


BATCHES = {  # chunk width C, cache_len per row, chunk length per row
    "fresh_C24": (24, [0, 0], [24, 24]),  # C > chunk_size: plain chunked branch
    "fresh_C16": (16, [0, 0, 0], [16, 9, 16]),  # C <= chunk_size: the kernel's route
    "continuation_crossing": (12, [10, 20, 30], [12, 12, 5]),  # over 16 and 32
    "mixed_ragged": (20, [0, 14, 0, 31], [20, 1, 7, 11]),
}


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_extend_matches_jax(kind):
    jcfg, jm, values, tm, params = _pair()
    C, cache_len, lens = BATCHES[kind]
    cache_len, lens = np.asarray(cache_len), np.asarray(lens)
    B = len(cache_len)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32)
    wins = _windows(jcfg, B, 12)
    jcache = {"stages": ({f"l{i}": {n: jnp.asarray(a)[None] for n, a in w.items()}
                          for i, w in enumerate(wins)},)}
    jl, jc = jm.extend(values, jnp.asarray(tokens), jcache,
                       jnp.asarray(cache_len.astype(np.int32)))
    cache = [{n: torch.from_numpy(a.copy()) for n, a in w.items()} for w in wins]
    before = dict(tm.route_rows)
    tl, tc = tm.extend(params, torch.from_numpy(tokens), cache,
                       torch.from_numpy(cache_len))
    fresh = int((cache_len == 0).sum())
    # fresh rows count under flash_prefill (the global layer takes the kernel)
    # and, at C > chunk_size, under flash_attention too (the chunked layer)
    plain_fresh = fresh if C > tm.cfg.chunk_size else 0
    assert tm.route_rows["flash_prefill"] - before["flash_prefill"] == fresh
    assert tm.route_rows["flash_attention"] - before["flash_attention"] == \
        B - fresh + plain_fresh
    for b in range(B):
        np.testing.assert_allclose(tl[b, :lens[b]].numpy(),
                                   np.asarray(jl)[b, :lens[b]], atol=ATOL)
        pos = np.arange(cache_len[b], cache_len[b] + lens[b])
        for i, layer in enumerate(tc):
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    layer[n][b, pos].numpy(),
                    np.asarray(jc["stages"][0][f"l{i}"][n])[0, b, pos], atol=ATOL)


def test_chunked_queries_ignore_earlier_chunks():
    """A chunked layer's queries past a chunk boundary read only their own
    chunk: noise in every window slot of the earlier chunk leaves them
    bit-for-bit as they were. The global layer's do move."""
    _, _, _, tm, params = _pair()
    cfg = tm.cfg
    chunked, glob = tm.specs
    rng = np.random.default_rng(3)
    B, C, start = 2, 8, 12  # positions 12..19 cross the boundary at 16
    x = torch.from_numpy(rng.normal(size=(B, C, cfg.d_model)).astype(np.float32))
    cache_len = torch.full((B,), start)
    win = _windows(cfg, B, 4)[0]
    noisy = {n: a.copy() for n, a in win.items()}
    for a in noisy.values():
        a[:, :16] = rng.normal(size=a[:, :16].shape) * 50
    route = tattn.extend_route(cache_len, C, W)
    outs = {}
    for spec, p in ((chunked, params["layers"][0]["mixer"]),
                    (glob, params["layers"][1]["mixer"])):
        for label, w in (("clean", win), ("noisy", noisy)):
            cache = {n: torch.from_numpy(a.copy()) for n, a in w.items()}
            outs[spec.attn_kind, label] = tattn.attn_extend(p, cfg, spec, x, cache,
                                                            cache_len, route)[0]
    past = slice(16 - start, C)
    assert torch.equal(outs["chunked", "clean"][:, past], outs["chunked", "noisy"][:, past])
    assert not torch.equal(outs["chunked", "clean"][:, :past.start],
                           outs["chunked", "noisy"][:, :past.start])
    assert not torch.equal(outs["global", "clean"][:, past], outs["global", "noisy"][:, past])


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

def _requests(cfg, n, seed, lo=20, hi=60):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", [int(t) for t in rng.integers(2, cfg.vocab_size,
                                                    size=int(rng.integers(lo, hi)))],
             int(rng.integers(4, 16))) for i in range(n)]


def _engines(all_global=False, **kw):
    jcfg, jm, values, tm, params = _pair(all_global)
    sched = dict(max_batch_slots=8, max_batched_tokens=64, prefill_chunk=32)
    base = dict(block_size=8, num_blocks=512, max_model_len=256)
    base.update(kw)
    jlora, tlora = base.pop("lora", (None, None))
    tm.route_rows = dict.fromkeys(tm.route_rows, 0)
    jeng = JLLMEngine(jm, values, JEngineConfig(scheduler=JSchedulerConfig(**sched),
                                                lora=jlora, **base))
    teng = LLMEngine(tm, params, EngineConfig(scheduler=SchedulerConfig(**sched),
                                              lora=tlora, device="cpu", **base))
    return jcfg, jeng, teng


def _serve(jeng, teng, reqs, aids=None):
    from repro.core import Request as JRequest
    from repro.core import SamplingParams as JSamplingParams

    for i, (rid, prompt, n) in enumerate(reqs):
        aid = None if aids is None else aids[i]
        jeng.add_request(JRequest(request_id=rid, prompt=list(prompt), adapter_id=aid,
                                  sampling=JSamplingParams(max_new_tokens=n)))
        teng.add_request(Request(request_id=rid, prompt=list(prompt), adapter_id=aid,
                                 sampling=SamplingParams(max_new_tokens=n)))
    jeng.run()
    teng.run()
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    assert len(tout) == len(reqs) and all(len(t) > 0 for t in tout.values())
    return jout, tout


def test_gathered_streams_equal_jax():
    """Prompts of 20-60 tokens in first chunks of 32 (> chunk_size 16: the
    chunked layer's plain branch) and later chunks; decodes cross the chunk
    boundaries at 16, 32, 48 and 64."""
    jcfg, jeng, teng = _engines()
    jout, tout = _serve(jeng, teng, _requests(jcfg, 5, 0))
    assert tout == jout
    assert teng.paged_runner is None and jeng.paged_runner is None
    assert teng.steps == jeng.steps == teng.runner.steps
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    rows = teng.model.route_rows
    assert rows["flash_prefill"] >= 5 and rows["flash_attention"] > rows["flash_prefill"]


def test_all_global_moe_paged_streams_equal_jax():
    jcfg, jeng, teng = _engines(all_global=True)
    assert teng.paged_runner is not None and jeng.paged_runner is not None
    jout, tout = _serve(jeng, teng, _requests(jcfg, 4, 1))
    assert tout == jout
    assert teng.paged_steps == teng.steps == jeng.steps > 0
    assert teng.host_copy_bytes == 0


def test_all_global_moe_lora_streams_equal_jax():
    """Three tenants and the base model in one gathered batch; the adapters
    have the attention sites only (no w1/w2 on a MoE layer)."""
    jcfg, _, _, tm, _ = _pair(all_global=True)
    jlc = JLoRAConfig(rank=4, alpha=8.0, max_loaded_adapters=4)
    lc = LoRAConfig(rank=4, alpha=8.0, max_loaded_adapters=4)
    adapters = {f"a{j}": jmake_adapter(jcfg, jlc, seed=j + 1) for j in range(3)}
    assert set(adapters["a0"][0]["l0"]) == {"wq", "wk", "wv", "wo"}
    _, jeng, teng = _engines(all_global=True, lora=(jlc, lc), num_blocks=256,
                             max_model_len=128, enable_prefix_cache=False,
                             execution_backend="gathered")
    for aid, w in adapters.items():
        jeng.register_adapter(aid, w)
        teng.register_adapter(aid, w)
    jout, tout = _serve(jeng, teng, _requests(jcfg, 5, 5),
                        aids=["a0", "a1", None, "a2", "a0"])
    assert tout == jout
    assert teng.paged_runner is None and teng.runner.steps == teng.steps
    assert dataclasses.asdict(teng.adapters.stats) == dataclasses.asdict(jeng.adapters.stats)


def test_backend_selection_matches_jax():
    """As ``tests/test_executor.py::test_backend_fallbacks``: chunked stacks
    have no paged family (the gathered backend serves them, and LoRA and
    the paged backend raise); an all-global MoE stack has one."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    assert not jpaged_supported(jcfg) and not paged_decode_supported(tcfg)
    assert jbuild_model(jcfg).decode_paged is None
    tm = build_model(tcfg, device="cpu")
    assert tm.decode_paged is None and tm.extend_paged is None and tm.verify_paged is None
    assert jpaged_supported(_global(jcfg)) and paged_decode_supported(_global(tcfg))
    with pytest.raises(ValueError, match="no paged decode path"):
        LLMEngine(tm, tm.init(0), EngineConfig(device="cpu", execution_backend="paged"))
    with pytest.raises(ValueError, match="pure global-attention"):
        LLMEngine(tm, tm.init(0), EngineConfig(device="cpu", lora=LoRAConfig()))


# ---------------------------------------------------------------------------
# published width and the converter
# ---------------------------------------------------------------------------

def test_published_config_and_block_size():
    """The published config equals the reference's; one interleave block (3
    chunked + 1 global layer, the card's cut) with the untied embedding and
    head holds ~10.9 B parameters, ~2.2 B a layer, ~2.01 B of them the
    routed experts."""
    cfg = tconfigs.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get_config(ARCH))
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.vocab_size, cfg.num_experts, cfg.top_k, cfg.moe_d_ff,
            cfg.num_shared_experts, cfg.chunk_size) == \
        (48, 5120, 40, 8, 128, 202048, 16, 1, 8192, 1, 8192)
    assert [s.attn_kind for s in cfg.stages[0][0]] == ["chunked"] * 3 + ["global"]
    from repro_torch.models.model import _layer_init

    # the layers' own init on the meta device: shapes and dtypes, no memory
    layers = [_layer_init(None, spec, cfg, torch.bfloat16, "meta")
              for spec in cfg.stages[0][0]]

    def numel(t):
        return sum(numel(v) for v in t.values()) if isinstance(t, dict) else t.numel()
    per_layer = [numel(layer) for layer in layers]
    routed = layers[0]["ff"]["w1"].numel() + layers[0]["ff"]["w2"].numel()
    total = sum(per_layer) + 2 * cfg.vocab_size * cfg.d_model + cfg.d_model
    assert all(2.19e9 < n < 2.21e9 for n in per_layer), per_layer
    assert 2.0e9 < routed < 2.02e9 and 10.8e9 < total < 11.0e9, (routed, total)
    assert layers[0]["ff"]["router"]["w"].dtype == torch.float32
    assert layers[0]["ff"]["w1"].dtype == torch.bfloat16


def test_converter_keeps_router_f32():
    """A bf16 JAX init converts to the port's own tree: every leaf with the
    shape and dtype ``Model.init`` gives it, the router in f32."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), dtype="bfloat16",
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), dtype="bfloat16",
                               param_dtype="bfloat16")
    values, _ = split_params(jbuild_model(jcfg).init(jax.random.PRNGKey(0), max_seq=64))
    conv = convert_params(tcfg, jax.device_get(values))
    own = build_model(tcfg, device="cpu").init(0)

    def spec(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in spec(sub, f"{pre}.{key}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in spec(sub, f"{pre}[{i}]").items()}
        return {pre: (tuple(tree.shape), tree.dtype)}
    assert spec(conv) == spec(own)
    for layer in conv["layers"]:
        assert layer["ff"]["router"]["w"].dtype == torch.float32
        assert layer["ff"]["w1"].dtype == layer["ff"]["shared_w1"]["w"].dtype == torch.bfloat16


def test_serve_entry_point_on_cpu(capsys):
    """``--arch llama4-scout-17b-a16e`` serves the smoke config on the
    gathered backend (its only one), through the existing flags."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--arch", ARCH])
    out = capsys.readouterr().out
    assert f"{ARCH}-smoke on cpu: 2 requests" in out and "(0 paged)" in out
    assert "host_copy=0.0MB" not in out and "rows flash_prefill=2" in out
