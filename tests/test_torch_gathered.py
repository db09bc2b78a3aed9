"""The port's gathered backend vs the JAX package's, on the CPU.

Model level: ``Model.extend`` over a gathered cache window, against JAX's
``model.extend`` with the same weights (the JAX init, converted) and the
same numpy-seeded windows, on the four ported smoke models (starcoder2-3b
has sliding-window attention, window 16 at smoke width): a fresh batch
(every row's chunk starts at 0: the ``flash_prefill`` route), a
continuation batch (the plain ``flash_attention`` route) and a mixed
ragged batch (both). Compared: the logits of real positions and the window
slots the chunk wrote (``atol 1e-4``: f32, sums in another order over 2
layers).

Engine level: greedy streams equal the JAX engine's on the same traces —
starcoder2-3b under ``auto`` (the gathered backend is its only one; prompts
longer than its window), olmo-1b under ``execution_backend="gathered"``
(plain, shared-prefix and preempting traces, and LoRA adapters), and the
port's gathered streams equal its paged ones. ``host_copy_bytes`` (window
bytes per gather, written payload per scatter) equals JAX's.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.core.lora import LoRAConfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fmod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ARCHS = ["olmo-1b", "gemma-2b", "qwen2.5-32b", "starcoder2-3b"]
ATOL = 1e-4
W, C = 48, 8


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, jm, values = bcommon.small_model(request.param)
    tm = build_model(tconfigs.smoke_config(request.param), device="cpu")
    return jcfg, jm, values, tm, convert_params(tm.cfg, values)


def _windows(cfg, B, seed):
    rng = np.random.default_rng(seed)
    shape = (B, W, cfg.num_kv_heads, cfg.head_dim)
    return [{n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
            for _ in range(cfg.num_layers)]


def _jax_cache(wins):
    # one smoke stage of one repeat: leaves (R=1, B, W, KV, D)
    return {"stages": ({f"l{i}": {n: jnp.asarray(a)[None] for n, a in w.items()}
                        for i, w in enumerate(wins)},)}


BATCHES = {  # cache_len per row, chunk length per row
    "fresh": ([0, 0, 0], [C, C, C]),
    "continuation": ([5, 17, 30], [C, C, C]),
    "mixed_ragged": ([0, 23, 0, 1], [C, 1, 3, 6]),
}


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_extend_matches_jax(models, kind):
    jcfg, jm, values, tm, params = models
    cache_len, lens = (np.asarray(a) for a in BATCHES[kind])
    B = len(cache_len)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32)
    wins = _windows(jcfg, B, 12)
    jl, jc = jm.extend(values, jnp.asarray(tokens), _jax_cache(wins),
                       jnp.asarray(cache_len.astype(np.int32)))
    cache = [{n: torch.from_numpy(a.copy()) for n, a in w.items()} for w in wins]
    before = dict(tm.route_rows)
    tl, tc = tm.extend(params, torch.from_numpy(tokens), cache,
                       torch.from_numpy(cache_len))
    fresh = int((cache_len == 0).sum())
    assert tm.route_rows["flash_prefill"] - before["flash_prefill"] == fresh
    assert tm.route_rows["flash_attention"] - before["flash_attention"] == B - fresh
    assert tl.shape == (B, C, jcfg.vocab_size)
    for b in range(B):
        np.testing.assert_allclose(tl[b, :lens[b]].numpy(),
                                   np.asarray(jl)[b, :lens[b]], atol=ATOL)
        pos = np.arange(cache_len[b], cache_len[b] + lens[b])
        for i, layer in enumerate(tc):
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    layer[n][b, pos].numpy(),
                    np.asarray(jc["stages"][0][f"l{i}"][n])[0, b, pos], atol=ATOL)


def test_paged_family_only_on_global_stacks():
    sc = build_model(tconfigs.smoke_config("starcoder2-3b"), device="cpu")
    assert sc.decode_paged is None and sc.extend_paged is None
    assert sc.specs[0].attn_kind == "window" and sc.cfg.sliding_window == 16
    olmo = build_model(tconfigs.smoke_config("olmo-1b"), device="cpu")
    assert olmo.decode_paged is not None and olmo.extend_paged is not None


def test_full_width_starcoder2_config():
    cfg = tconfigs.get_config("starcoder2-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        (30, 3072, 24, 2, 128, 12288, 49152, 4096)
    assert (cfg.norm, cfg.activation, cfg.qkv_bias, cfg.mlp_bias,
            cfg.attn_out_bias, cfg.tie_embeddings) == \
        ("layernorm", "gelu", True, True, True, True)
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    per_layer = (qkv + (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
                 + cfg.num_heads * cfg.head_dim * d + d + 2 * d * f + f + d + 4 * d)
    assert 3.0e9 < V * d + 2 * d + L * per_layer < 3.1e9


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

def _port_request(r, adapter_id=None):
    sp = r.sampling
    return Request(request_id=r.request_id, prompt=list(r.prompt),
                   user_id=r.user_id, adapter_id=adapter_id,
                   sampling=SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                                           max_new_tokens=sp.max_new_tokens,
                                           stop_token=sp.stop_token))


def _torch_engine(arch, **kw):
    _, _, values = bcommon.small_model(arch)
    model = build_model(tconfigs.smoke_config(arch), device="cpu")
    cfg = dict(block_size=8, num_blocks=512, max_model_len=256, device="cpu",
               scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=64,
                                         prefill_chunk=16))
    cfg.update(kw)
    return LLMEngine(model, convert_params(model.cfg, values), EngineConfig(**cfg))


def _serve_both(arch, seed, n=6, num_blocks=512, first_alone=False, backend="auto",
                req_kw=None, **kw):
    """Serve one trace on both engines (``first_alone``: the first request
    finishes before the others arrive, so they can hit its prefix blocks)."""
    cfg, _, _ = bcommon.small_model(arch)
    reqs = bcommon.make_requests(cfg, n, np.random.default_rng(seed), **(req_kw or {}))
    jeng = bcommon.make_engine(arch, num_blocks=num_blocks, execution_backend=backend,
                               **kw)
    teng = _torch_engine(arch, num_blocks=num_blocks, execution_backend=backend, **kw)
    for wave in ([reqs[:1], reqs[1:]] if first_alone else [reqs]):
        for r in wave:
            teng.add_request(_port_request(r))
            jeng.add_request(dataclasses.replace(r))
        jeng.run()
        teng.run()
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    assert len(tout) == n and all(len(t) > 0 for t in tout.values())
    return jeng, teng, jout, tout


@pytest.fixture(scope="module")
def starcoder_trace():
    # prompts of 20-60 tokens against a 16-token window
    return _serve_both("starcoder2-3b", 4, req_kw=dict(prompt_lo=20, prompt_hi=60))


def test_starcoder2_streams_equal_jax(starcoder_trace):
    jeng, teng, jout, tout = starcoder_trace
    assert tout == jout
    assert teng.paged_runner is None and jeng.paged_runner is None
    assert teng.steps == jeng.steps == teng.runner.steps
    assert teng.paged_steps == 0
    snap = teng.metrics_snapshot()
    assert snap["engine.dispatch.gathered"] == teng.steps
    assert snap["runner.gathered.prefill_steps"] == teng.runner.prefill_steps > 0
    rows = teng.model.route_rows
    assert rows["flash_prefill"] >= 6 and rows["flash_attention"] > 0


def test_starcoder2_host_copy_bytes_equal_jax(starcoder_trace):
    jeng, teng, _, _ = starcoder_trace
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0


def test_starcoder2_paged_backend_raises():
    with pytest.raises(ValueError, match="no paged decode path"):
        _torch_engine("starcoder2-3b", execution_backend="paged")


def _serve_kivi(arch, bits, backend):
    """One trace on both engines with KIVI pages at ``bits`` (the two
    packages' own QuantConfig)."""
    from repro.core.kv_quant import QuantConfig as JQuantConfig
    from repro_torch.core import QuantConfig

    cfg, _, _ = bcommon.small_model(arch)
    reqs = bcommon.make_requests(cfg, 4, np.random.default_rng(9))
    jeng = bcommon.make_engine(arch, execution_backend=backend,
                               kv_quant=JQuantConfig(bits=bits))
    teng = _torch_engine(arch, execution_backend=backend, kv_quant=QuantConfig(bits=bits))
    for r in reqs:
        jeng.add_request(dataclasses.replace(r))
        teng.add_request(_port_request(r))
    jeng.run()
    teng.run()
    assert teng.paged_runner is None and teng.store.quantized
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    return ({rid: s.generated for rid, s in jeng.seqs.items()},
            {rid: s.generated for rid, s in teng.seqs.items()})


def test_starcoder2_kv_quant_and_lora_raise():
    """KIVI pages serve starcoder2-3b on the gathered backend, with JAX's
    streams; LoRA still needs a pure global-attention stack, in both
    packages."""
    from repro_torch.core import QuantConfig

    jout, tout = _serve_kivi("starcoder2-3b", 8, "auto")
    assert tout == jout
    with pytest.raises(ValueError, match="pure global-attention"):
        _torch_engine("starcoder2-3b", lora=LoRAConfig())
    with pytest.raises(ValueError, match="no paged decode path"):
        _torch_engine("starcoder2-3b", execution_backend="paged",
                      kv_quant=QuantConfig(bits=8))


def test_kivi_pages_on_gathered_backend_raise():
    """olmo-1b's KIVI pages on the gathered backend: JAX's streams."""
    jout, tout = _serve_kivi("olmo-1b", 4, "gathered")
    assert tout == jout


@pytest.fixture(scope="module")
def olmo_gathered_trace():
    return _serve_both("olmo-1b", 0, backend="gathered")


def test_olmo_gathered_streams_equal_jax(olmo_gathered_trace):
    jeng, teng, jout, tout = olmo_gathered_trace
    assert tout == jout
    assert teng.paged_runner is None and jeng.paged_runner is None
    assert teng.steps == jeng.steps == teng.runner.steps
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0


def test_olmo_gathered_equals_port_paged(olmo_gathered_trace):
    _, gathered, _, gout = olmo_gathered_trace
    paged = _torch_engine("olmo-1b")
    cfg, _, _ = bcommon.small_model("olmo-1b")
    for r in bcommon.make_requests(cfg, 6, np.random.default_rng(0)):
        paged.add_request(_port_request(r))
    paged.run()
    assert {rid: s.generated for rid, s in paged.seqs.items()} == gout
    assert paged.paged_steps == paged.steps == gathered.steps
    assert paged.host_copy_bytes == 0


def test_olmo_gathered_shared_prefix_matches_jax():
    jeng, teng, jout, tout = _serve_both("olmo-1b", 1, backend="gathered",
                                         first_alone=True,
                                         req_kw=dict(shared_prefix=32))
    assert tout == jout
    assert teng.prefix_cache.stats.hit_blocks == jeng.prefix_cache.stats.hit_blocks > 0
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes
    # prefix hits start their first chunk past 0: continuation rows
    assert teng.model.route_rows["flash_attention"] > 0


def test_olmo_gathered_preemption_matches_jax():
    jeng, teng, jout, tout = _serve_both("olmo-1b", 2, backend="gathered",
                                         num_blocks=24)
    assert tout == jout
    preempts = teng.metrics_snapshot()["engine.preemptions"]
    assert preempts > 0 and preempts == jeng.metrics_snapshot()["engine.preemptions"]
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes


def test_olmo_gathered_lora_matches_jax():
    """Three tenants and the base model in one gathered batch."""
    jcfg, _, _ = bcommon.small_model("olmo-1b")
    jlc = JLoRAConfig(rank=4, alpha=8.0, max_loaded_adapters=4)
    lc = LoRAConfig(rank=4, alpha=8.0, max_loaded_adapters=4)
    adapters = {f"a{j}": jmake_adapter(jcfg, jlc, seed=j + 1) for j in range(3)}
    kw = dict(num_blocks=256, max_model_len=128, enable_prefix_cache=False,
              execution_backend="gathered")
    jeng = bcommon.make_engine("olmo-1b", lora=jlc, **kw)
    teng = _torch_engine("olmo-1b", lora=lc, **kw)
    for aid, w in adapters.items():
        jeng.register_adapter(aid, w)
        teng.register_adapter(aid, w)
    reqs = bcommon.make_requests(jcfg, 5, np.random.default_rng(5))
    aids = ["a0", "a1", None, "a2", "a0"]
    for r, aid in zip(reqs, aids):
        jeng.add_request(dataclasses.replace(r, adapter_id=aid))
        teng.add_request(_port_request(r, adapter_id=aid))
    jeng.run()
    teng.run()
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    assert all(len(t) > 0 for t in tout.values()) and tout == jout
    assert teng.paged_runner is None and teng.runner.steps == teng.steps
    assert dataclasses.asdict(teng.adapters.stats) == dataclasses.asdict(jeng.adapters.stats)


def test_traced_gathered_serve_records_window_spans():
    from repro_torch.core.telemetry import TelemetryConfig

    eng = _torch_engine("starcoder2-3b", telemetry=TelemetryConfig())
    tracer = eng.trace
    cfg = eng.model.cfg
    rng = np.random.default_rng(3)
    for i in range(2):
        eng.add_request(Request(request_id=f"r{i}", prompt=[int(x) for x in rng.integers(
            2, cfg.vocab_size, 20)], sampling=SamplingParams(max_new_tokens=3)))
    eng.run()
    names = {e.name for e in tracer.events}
    assert {"gather", "window_upload", "scatter", "dispatch"} <= names


def test_serve_entry_point_gathered_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--arch", "starcoder2-3b"])
    out = capsys.readouterr().out
    assert "starcoder2-3b-smoke on cpu: 2 requests" in out and "(0 paged)" in out
    assert "host_copy=0.0MB" not in out and "rows flash_prefill=2" in out
    serve.main(["--device", "cpu", "--requests", "2", "--backend", "gathered"])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke on cpu: 2 requests" in out and "(0 paged)" in out


def test_wrapper_launch_count_untouched_on_cpu():
    """On CPU tensors the op takes the plain version: no launch is counted."""
    before = fmod.flash_prefill.launches
    q = torch.zeros(1, 2, 4, 32)
    fmod.flash_prefill(q, q[:, :1], q[:, :1], scale=1.0)
    assert fmod.flash_prefill.launches == before
