"""DeepSeek-V3 (MLA + routed MoE) in the port vs the JAX package, on the CPU.

The config equals the reference's field by field, and ``param_counts``
(``launch/roofline.py``) equals the reference roofline's, total and
active, at published width and at smoke width. At smoke width (2 MLA
layers: a dense one, then a MoE one of 4 experts at top-2 with sigmoid
routing and a shared expert), with the JAX init converted:
``Model.extend`` over gathered latent windows matches JAX's logits and
written latents (``ATOL``, f32) on fresh, continuation and mixed ragged
batches; every row takes the plain attention. Served on the gathered
backend (MLA has no paged family), greedy streams EQUAL JAX's engine's over
one trace with chunked prefill, a shared prefix (prefix-cache hits, and a
copy-on-write of a latent block forced on both engines), and a pool of 32
blocks that preempts; ``host_copy_bytes`` is equal. Under ``kv_quant``
the latents take the reference's quantize–dequantize round trip: streams
equal and stores within a code step of JAX's. An ``export_seq`` /
``import_seq`` round trip of latent blocks keeps the streams of an
unmigrated engine. ``convert_params`` skips the ``mtp`` block, which the
port does not build.
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
from repro import configs as jconfigs  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.scheduler import ChunkWork as JChunkWork  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig,  # noqa: E402
                              SchedulerConfig)
from repro_torch.core.scheduler import ChunkWork  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from test_torch_gathered import _port_request  # noqa: E402
from test_torch_gathered_quant import _as_jax, _port_vs_jax_leaves  # noqa: E402

ARCH = "deepseek-v3-671b"
ATOL = 1e-4  # f32 logits over 2 layers, XLA vs PyTorch summation order
W, C = 40, 8
SCHED = dict(max_batch_slots=8, max_batched_tokens=64, prefill_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread: on a shared machine
    a contended thread pool makes each small op take milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg, jm, values = bcommon.small_model(ARCH)
    tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    return jcfg, jm, values, tm, convert_params(tm.cfg, values)


def test_config_equals_reference():
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) == want
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.q_lora_rank,
            cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.num_experts, cfg.top_k, cfg.vocab_size) == \
        (61, 7168, 128, 1536, 512, 128, 64, 128, 256, 8, 129280)


@pytest.mark.parametrize("get", ["get_config", "smoke_config"])
def test_param_counts_equal_reference(get):
    assert troofline.param_counts(getattr(tconfigs, get)(ARCH)) == \
        jroofline.param_counts(getattr(jconfigs, get)(ARCH))


def test_published_param_counts():
    """The full model's total and active counts, and the one dense + one
    MoE layer block served on the card: 13 944 094 720 parameters."""
    cfg = tconfigs.get_config(ARCH)
    n = troofline.param_counts(cfg)
    assert 6.7e11 < n["total"] < 6.8e11 and 3.7e10 < n["active"] < 3.8e10
    block = dataclasses.replace(cfg, stages=((cfg.stages[0][0], 1), (cfg.stages[1][0], 1)))
    assert troofline.param_counts(block)["total"] == 13_944_094_720


def _windows(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return [{"c_kv": rng.normal(size=(B, W, cfg.kv_lora_rank)).astype(np.float32),
             "k_pe": rng.normal(size=(B, W, cfg.qk_rope_head_dim)).astype(np.float32)}
            for _ in range(cfg.num_layers)]


BATCHES = {  # cache_len per row, chunk length per row
    "fresh": ([0, 0], [C, 5]),
    "continuation": ([5, 17, 30], [C, C, C]),
    "mixed_ragged": ([0, 23, 0, 1], [C, 1, 3, 6]),
}


@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_extend_matches_jax(models, kind):
    jcfg, jm, values, tm, params = models
    cache_len, lens = (np.asarray(a) for a in BATCHES[kind])
    B = len(cache_len)
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab_size, size=(B, C)
                                                ).astype(np.int32)
    wins = _windows(jcfg, B, 12)
    jcache = {"stages": ({f"l{i}": {n: jnp.asarray(a)[None] for n, a in w.items()}
                          for i, w in enumerate(wins)},)}
    jl, jc = jm.extend(values, jnp.asarray(tokens), jcache,
                       jnp.asarray(cache_len.astype(np.int32)))
    cache = [{n: torch.from_numpy(a.copy()) for n, a in w.items()} for w in wins]
    before = dict(tm.route_rows)
    tl, tc = tm.extend(params, torch.from_numpy(tokens), cache, torch.from_numpy(cache_len))
    assert tm.route_rows["flash_prefill"] == before["flash_prefill"]
    assert tm.route_rows["flash_attention"] - before["flash_attention"] == B
    for b in range(B):
        np.testing.assert_allclose(tl[b, :lens[b]].numpy(),
                                   np.asarray(jl)[b, :lens[b]], atol=ATOL)
        pos = np.arange(cache_len[b], cache_len[b] + lens[b])
        for i, layer in enumerate(tc):
            for n in ("c_kv", "k_pe"):
                np.testing.assert_allclose(
                    layer[n][b, pos].numpy(),
                    np.asarray(jc["stages"][0][f"l{i}"][n])[0, b, pos], atol=ATOL)


def _engines(models, num_blocks, qc=None):
    _, _, _, tm, params = models
    common = dict(block_size=8, num_blocks=num_blocks, max_model_len=256)
    jeng = bcommon.make_engine(ARCH, kv_quant=None if qc is None else JQuantConfig(**qc),
                               **common)
    teng = LLMEngine(tm, params, EngineConfig(
        device="cpu", kv_quant=None if qc is None else QuantConfig(**qc),
        scheduler=SchedulerConfig(**SCHED), **common))
    return jeng, teng


def _streams(eng):
    return {rid: s.generated for rid, s in eng.seqs.items()}


@pytest.fixture(scope="module")
def served(models):
    """One trace on both engines: 6 requests over a 36-token shared prefix,
    the first served alone (its blocks published), then the other five into
    a 32-block pool; r1's first block, shared with r0's prefix, copied on
    write on both engines before it runs."""
    jcfg = models[0]
    reqs = bcommon.make_requests(jcfg, 6, np.random.default_rng(2), shared_prefix=36)
    jeng, teng = _engines(models, 32)
    for w, wave in enumerate((reqs[:1], reqs[1:])):
        for r in wave:
            jeng.add_request(dataclasses.replace(r))
            teng.add_request(_port_request(r))
        if w:
            for eng, chunk in ((jeng, JChunkWork), (teng, ChunkWork)):
                seq = eng.seqs["r1"]
                eng._handle_cow(seq, chunk(seq, 0, 8))
        jeng.run()
        teng.run()
    return jeng, teng


def test_streams_equal_jax(served):
    jeng, teng = served
    tout = _streams(teng)
    assert len(tout) == 6 and all(len(t) > 0 for t in tout.values())
    assert tout == _streams(jeng)
    assert teng.paged_runner is None and jeng.paged_runner is None
    assert teng.steps == jeng.steps == teng.runner.steps
    assert teng.bm.stats.cow_copies == jeng.bm.stats.cow_copies == 1
    hits = teng.prefix_cache.stats.hit_blocks
    assert hits == jeng.prefix_cache.stats.hit_blocks > 0
    pre = teng.metrics_snapshot()["engine.preemptions"]
    assert pre == jeng.metrics_snapshot()["engine.preemptions"] > 0
    assert teng.model.route_rows["flash_prefill"] == 0


def test_host_copy_bytes_equal_jax(served):
    jeng, teng = served
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    # one c_kv (32) and one k_pe (16) f32 slot per token per layer: the
    # store holds latents, not 4 heads x 48 of K and of V
    assert teng.store.kv_bytes_per_block() == 2 * 8 * (32 + 16) * 4


def test_kv_quant_round_trip_serve_matches_jax(models):
    """The latents' quantize–dequantize round trip at 8 bits."""
    reqs = bcommon.make_requests(models[0], 3, np.random.default_rng(5))
    jeng, teng = _engines(models, 512, qc=dict(bits=8))
    for r in reqs:
        jeng.add_request(dataclasses.replace(r))
        teng.add_request(_port_request(r))
    jeng.run()
    teng.run()
    assert _streams(teng) == _streams(jeng)
    assert not teng.store.quantized and teng.paged_runner is None
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes
    js, ts = jeng.store, teng.store
    for jl, r, tl in _port_vs_jax_leaves(teng.model.cfg, js, ts):
        want = js.stores[jl][r]
        np.testing.assert_allclose(_as_jax(ts, tl, want.shape), want,
                                   atol=np.abs(want).max() * 2 / 255)


def test_export_import_round_trip_keeps_streams(models):
    """r0 leaves engine A mid-decode for engine B; every stream equals an
    unmigrated engine's."""
    jcfg, _, _, tm, params = models
    reqs = bcommon.make_requests(jcfg, 3, np.random.default_rng(8))

    def engine():
        return LLMEngine(tm, params, EngineConfig(
            block_size=8, num_blocks=128, max_model_len=256, device="cpu",
            scheduler=SchedulerConfig(**SCHED)))
    ref, a, b = engine(), engine(), engine()
    for eng in (ref, a):
        for r in reqs:
            eng.add_request(_port_request(r))
    ref.run()
    while len(a.seqs["r0"].generated) < 3:
        a.step()
    payload = a.export_seq("r0")
    assert len(payload["blocks"][0]) == 2 * tm.cfg.num_layers  # c_kv, k_pe a layer
    b.import_seq(payload)
    assert b.last_import_bytes == len(payload["blocks"]) * a.store.kv_bytes_per_block()
    a.run()
    b.run()
    got = dict(_streams(a), **_streams(b))
    assert got == _streams(ref)


def test_convert_skips_mtp(models):
    _, _, values, tm, params = models
    assert "mtp" in values and "mtp" not in params
    assert "mtp" not in tm.init(0)
    assert set(params) == {"embed", "final_norm", "lm_head", "layers"}
