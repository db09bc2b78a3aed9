"""The port's multi-tenant LoRA serving vs the JAX package, on the CPU.

The same numpy inputs go through both packages: the ``bgmv`` plain version
against JAX's oracle and its Pallas kernel in interpret mode; the adapter
registry (``make_adapter`` draws, sites, bytes, the dense merge); the paged
adapter store over the same ``ensure`` sequences (statistics, rented pages,
table bytes); ``decode_paged`` / ragged ``extend_paged`` logits with
adapter deltas on the olmo-1b, gemma-2b (MQA) and qwen2.5-32b (GQA, qkv
bias) smoke models; and whole engines serving mixed-adapter traces, whose
greedy streams must EQUAL the JAX LoRA engine's and the port's
dense-merged single-tenant engines'. Adapters are made once, by JAX's
``make_adapter``, and the same numpy trees are registered on both sides.

Tolerances: f32 ``bgmv`` atol 1e-6 (summation order only, O(1) outputs);
bf16 one bf16 step (both sum in f32 and round once); smoke logits atol 1e-4
(XLA and PyTorch sum in other orders over 2 layers).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro import configs as jconfigs  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import LLMEngine as JLLMEngine  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core.block_manager import BlockManager as JBlockManager  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import PagedAdapterStore as JStore  # noqa: E402
from repro.core.lora import adapter_nbytes as jadapter_nbytes  # noqa: E402
from repro.core.lora import lora_layer_sites as jlora_layer_sites  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro.core.lora import merge_adapter as jmerge_adapter  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.kernels.lora import bgmv as jbgmv  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.core.block_manager import BlockManager, OutOfBlocks  # noqa: E402
from repro_torch.core.lora import (LoRAConfig, PagedAdapterStore,  # noqa: E402
                                   adapter_nbytes, lora_layer_sites, make_adapter,
                                   merge_adapter)
from repro_torch.core.scheduler import Scheduler  # noqa: E402
from repro_torch.kernels.lora.ops import bgmv  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_adapter, convert_params  # noqa: E402

ARCH = "olmo-1b"
ARCHS = ["olmo-1b", "gemma-2b", "qwen2.5-32b"]
ATOL = 1e-4
RANK, ALPHA = 4, 8.0
LC, JLC = LoRAConfig(rank=RANK, alpha=ALPHA, max_loaded_adapters=4), \
    JLoRAConfig(rank=RANK, alpha=ALPHA, max_loaded_adapters=4)


# ---------------------------------------------------------------------------
# kernel: the plain version vs JAX's oracle and interpret-mode Pallas kernel
# ---------------------------------------------------------------------------

def _bgmv_inputs(seed, B, C, Din, R, Dout, T):
    """O(1) outputs: A and B scaled as make_adapter scales them; slot 0 the
    null adapter."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, C, Din)).astype(np.float32)
    a = (r.standard_normal((T, Din, R)) / np.sqrt(Din)).astype(np.float32)
    b = (r.standard_normal((T, R, Dout)) / np.sqrt(R)).astype(np.float32)
    a[0] = 0
    b[0] = 0
    return x, a, b


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bgmv_matches_jax(impl, dtype):
    x, a, b = _bgmv_inputs(0, 5, 3, 16, 4, 24, 4)  # test_lora.py's shape case
    idx = np.asarray([0, 2, 1, 3, 2])
    want = np.asarray(jbgmv(jnp.asarray(x, dtype), jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(idx, jnp.int32), impl=impl).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = bgmv(tx, torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(idx))  # int64 ids: the op casts
    assert got.dtype == tx.dtype and got.shape == (5, 3, 24)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:  # one bf16 step apart at most
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)
    assert np.abs(got[0]).max() == 0.0  # null slot 0: an exact zero delta


# ---------------------------------------------------------------------------
# registry: the same adapters, sites, bytes and merge as JAX
# ---------------------------------------------------------------------------

def _tree_equal(jt, tt):
    assert len(jt) == len(tt)
    for js, ts in zip(jt, tt):
        assert js.keys() == ts.keys()
        for lk in js:
            assert js[lk].keys() == ts[lk].keys()
            for site in js[lk]:
                for k in ("a", "b"):
                    ja, ta = np.asarray(js[lk][site][k]), ts[lk][site][k]
                    assert ja.dtype == ta.dtype and ja.shape == ta.shape
                    assert ja.tobytes() == ta.tobytes(), (lk, site, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_adapter_layout_matches_jax(arch):
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    for js, ts in zip(jcfg.layer_specs(), tcfg.layer_specs()):
        assert lora_layer_sites(tcfg, ts) == jlora_layer_sites(jcfg, js)
    assert adapter_nbytes(tcfg, LC) == jadapter_nbytes(jcfg, JLC)
    _tree_equal(jmake_adapter(jcfg, JLC, seed=3), make_adapter(tcfg, LC, seed=3))


def test_full_width_olmo_adapter_rents_eleven_fp_blocks():
    """At olmo-1b's published width and rank 8 one adapter is 23 068 672 B
    of f32 factors: exactly 11 fp KV blocks of 16 bf16 tokens (2 097 152 B
    across the 16 layers)."""
    cfg = tconfigs.get_config("olmo-1b")
    spec = cfg.layer_specs()[0]
    assert ("w1", 2048, 16384) in lora_layer_sites(cfg, spec)
    nbytes = adapter_nbytes(cfg, LoRAConfig())
    assert nbytes == jadapter_nbytes(jconfigs.get_config("olmo-1b"), JLoRAConfig())
    block = cfg.num_layers * 2 * 16 * cfg.num_kv_heads * cfg.head_dim * 2
    assert nbytes == 23_068_672 == 11 * block


def test_convert_adapter_unstacks_repeats():
    base = tconfigs.smoke_config(ARCH)
    pattern = base.stages[0][0]
    cfg = dataclasses.replace(base, stages=((pattern, 3),))  # 3 repeats of 2
    tree = make_adapter(cfg, LC, seed=5)
    layers = convert_adapter(cfg, tree)
    assert len(layers) == 3 * len(pattern) == len(cfg.layer_specs())
    for r in range(3):
        for i in range(len(pattern)):
            for site, ab in layers[r * len(pattern) + i].items():
                np.testing.assert_array_equal(ab["a"], tree[0][f"l{i}"][site]["a"][r])
                np.testing.assert_array_equal(ab["b"], tree[0][f"l{i}"][site]["b"][r])


@pytest.fixture(scope="module")
def olmo():
    """The JAX smoke model and values, the port model and converted params,
    and three adapters made by JAX."""
    jcfg, jm, values = bcommon.small_model(ARCH)
    tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    adapters = {f"a{j}": jmake_adapter(jcfg, JLC, seed=j + 1) for j in range(3)}
    return jcfg, jm, values, tm, convert_params(tm.cfg, values), adapters


def test_merge_adapter_matches_jax(olmo):
    jcfg, _, values, tm, params, adapters = olmo
    want = convert_params(tm.cfg, jmerge_adapter(values, adapters["a1"], jcfg, JLC))
    got = merge_adapter(params, adapters["a1"], tm.cfg, LC)
    for gl, wl, bl in zip(got["layers"], want["layers"], params["layers"]):
        for group, site in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
                            ("mixer", "wo"), ("ff", "w1"), ("ff", "w2")):
            assert torch.equal(gl[group][site]["w"], wl[group][site]["w"]), site
            assert not torch.equal(gl[group][site]["w"], bl[group][site]["w"])
    assert torch.equal(params["layers"][0]["ff"]["w1"]["w"],
                       convert_params(tm.cfg, values)["layers"][0]["ff"]["w1"]["w"])


# ---------------------------------------------------------------------------
# paged adapter store: the same fault / evict / rent sequence as JAX's
# ---------------------------------------------------------------------------

def _stores(jcfg, tcfg, lora_kw, num_blocks, kv_block_bytes, adapters):
    jst = JStore(jcfg, JLoRAConfig(**lora_kw), JBlockManager(num_blocks, 8),
                 kv_block_bytes=kv_block_bytes)
    tst = PagedAdapterStore(tcfg, LoRAConfig(**lora_kw), BlockManager(num_blocks, 8),
                            kv_block_bytes=kv_block_bytes, device="cpu")
    for aid, w in adapters.items():
        jst.registry.register(aid, w)
        tst.registry.register(aid, w)
    return jst, tst


def _same_state(jst, tst):
    assert dataclasses.asdict(tst.stats) == dataclasses.asdict(jst.stats)
    assert tst.rented_pages == jst.rented_pages
    assert tst.bm.used_blocks == jst.bm.used_blocks
    assert tst.loaded == jst.loaded
    assert {a: tst.slot(a) for a in tst.loaded} == {a: jst.slot(a) for a in jst.loaded}


def _tables_equal(jst, tst, slots):
    """The port's (T, Din, r) tables equal JAX's (R, T', Din, r) stage
    tables in every resident slot, byte for byte (the scale folded into B
    the same way)."""
    for li, layer in enumerate(tst.tables):
        for site, t in layer.items():
            jt = jst.tables[0][f"l{li}"][site]
            for k in ("a", "b"):
                for s in slots:
                    np.testing.assert_array_equal(t[k][s].numpy(), np.asarray(jt[k])[0, s])
    for site, t in tst.tables[0].items():  # the null slot stays zero
        assert not t["a"][0].any() and not t["b"][0].any()


def test_store_rents_pages_and_lru_evicts_like_jax(olmo):
    jcfg, _, _, tm, _, adapters = olmo
    nb = adapter_nbytes(tm.cfg, LC)
    jst, tst = _stores(jcfg, tm.cfg, dict(rank=RANK, max_loaded_adapters=2), 64,
                       nb // 4, adapters)
    assert tst.capacity == 3  # no pow2 padding: 2 usable slots + the null slot
    for step in (["a0", "a1"], ["a2"], ["a2"], ["a1", "a2"]):
        jst.ensure(step)
        tst.ensure(step)
        _same_state(jst, tst)
    assert tst.stats.evictions == 1 and tst.stats.hits == 3
    assert tst.pages_per_adapter >= 4
    _tables_equal(jst, tst, [tst.slot(a) for a in tst.loaded])
    with pytest.raises(OutOfBlocks):  # both residents protected
        tst.ensure(["a0"], protected=["a1", "a2"])
    marsh = tst.marshal([None, "a2", None, "a1"])
    assert marsh["ids"].dtype == np.int32
    assert marsh["ids"].tolist() == jst.marshal([None, "a2", None, "a1"])["ids"].tolist()
    assert marsh["ids"].tolist()[::2] == [0, 0] and marsh["layers"] is tst.tables


def test_store_pool_cap_like_jax(olmo):
    jcfg, _, _, tm, _, adapters = olmo
    nb = adapter_nbytes(tm.cfg, LC)
    kw = dict(rank=RANK, max_loaded_adapters=4, pool_pages=2 * (nb // (nb // 4)))
    jst, tst = _stores(jcfg, tm.cfg, kw, 256, nb // 4, adapters)
    for step in (["a0", "a1"], ["a2"]):  # at the cap, then evict with free slots
        jst.ensure(step)
        tst.ensure(step)
        _same_state(jst, tst)
    assert tst.stats.evictions == 1 and tst.rented_pages <= kw["pool_pages"]
    with pytest.raises(ValueError, match="cannot hold even one adapter"):
        PagedAdapterStore(tm.cfg, LoRAConfig(rank=RANK, pool_pages=1),
                          BlockManager(64, 8), kv_block_bytes=nb // 4, device="cpu")


# ---------------------------------------------------------------------------
# model: decode_paged / ragged extend_paged with adapter deltas vs JAX
# ---------------------------------------------------------------------------

NB, P, NP = 32, 8, 4


def _lora_operands(jcfg, tcfg, ids):
    """The same two adapters loaded into a JAX store and a port store; the
    rows' slots ``ids`` (0 = no adapter) as each model takes them."""
    adapters = {f"a{j}": jmake_adapter(jcfg, JLC, seed=j + 7) for j in range(2)}
    jst, tst = _stores(jcfg, tcfg, dict(rank=RANK, alpha=ALPHA), 64, 1 << 20, adapters)
    jst.ensure(["a0", "a1"])
    tst.ensure(["a0", "a1"])
    ids = np.asarray(ids, np.int32)
    return ({"ids": jnp.asarray(ids), "stages": jst.tables},
            {"ids": torch.from_numpy(ids), "layers": tst.tables})


def _models(arch):
    jcfg = jconfigs.smoke_config(arch)
    jm = jbuild(jcfg)
    values = jax.device_get(split_params(jm.init(jax.random.PRNGKey(0)))[0])
    tm = build_model(tconfigs.smoke_config(arch), device="cpu")
    return jcfg, jm, values, tm, convert_params(tm.cfg, values)


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_kv_heads, NB, P, cfg.head_dim)
    return [{n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
            for _ in range(cfg.num_layers)]


def _jax_pages(pools):
    return ({"r0": {f"l{i}": {n: jnp.asarray(a) for n, a in p.items()}
                    for i, p in enumerate(pools)}},)


def _torch_pages(pools):
    return [{n: torch.from_numpy(a.copy()) for n, a in p.items()} for p in pools]


@pytest.mark.parametrize("arch", ARCHS)
def test_lora_decode_and_extend_match_jax(arch):
    jcfg, jm, values, tm, params = _models(arch)
    rng = np.random.default_rng(31)
    pools = _pools(jcfg, 32)
    tables = rng.permutation(np.arange(1, NB))[: 4 * NP].reshape(4, NP).astype(np.int64)
    t = torch.from_numpy
    # decode, B=3: rows on adapter slot 1, the null slot, slot 2
    lengths = np.asarray([0, 9, NP * P - 1], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
    jl_lora, tl_lora = _lora_operands(jcfg, tm.cfg, [1, 0, 2])
    jl, _, _ = jm.decode_paged(values, jnp.asarray(tokens), _jax_pages(pools),
                               jnp.asarray(tables[:3]), jnp.asarray(lengths),
                               lora=jl_lora)
    tl, _, _ = tm.decode_paged(params, t(tokens), _torch_pages(pools), t(tables[:3]),
                               t(lengths), lora=tl_lora)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    base, _, _ = tm.decode_paged(params, t(tokens), _torch_pages(pools), t(tables[:3]),
                                 t(lengths))
    assert torch.equal(tl[1], base[1])  # the null slot adds exactly 0
    assert (tl[0] - base[0]).abs().max() > 1e-2  # the deltas reach the logits
    # ragged extend, B=4, chunks crossing pages
    lengths = np.asarray([0, 5, 16, 20], np.int32)
    chunk_lens = np.asarray([8, 3, 1, 6], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, size=(4, 8)).astype(np.int32)
    jl_lora, tl_lora = _lora_operands(jcfg, tm.cfg, [2, 1, 0, 1])
    jl, _, jw = jm.extend_paged(values, jnp.asarray(tokens), _jax_pages(pools),
                                jnp.asarray(tables), jnp.asarray(lengths),
                                jnp.asarray(chunk_lens), jnp.asarray(0, jnp.int32),
                                lora=jl_lora)
    tl, _, tw = tm.extend_paged(params, t(tokens), _torch_pages(pools), t(tables),
                                t(lengths), t(chunk_lens), 0, lora=tl_lora)
    real = np.arange(8)[None, :] < chunk_lens[:, None]
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL)
    for i, twl in enumerate(tw):  # the k/v deltas reach the host writeback
        for n in ("k", "v"):
            np.testing.assert_allclose(twl[n].numpy()[real],
                                       np.asarray(jw[0]["r0"][f"l{i}"][n])[real],
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# engine: greedy streams equal JAX's LoRA engine and the dense merge
# ---------------------------------------------------------------------------

def _cfg_kw(lora, **kw):
    base = dict(block_size=8, num_blocks=256, max_model_len=128, lora=lora,
                enable_prefix_cache=False)
    base.update(kw)
    return base


def _sched(cls, **kw):
    return cls(max_batch_slots=4, max_batched_tokens=48, prefill_chunk=16, **kw)


def _drive_both(olmo, aids, prompts, *, lora_kw=None, max_new=6, sched_kw=None,
                quant=None, waves=None, **kw):
    """Serve the same trace on a JAX LoRA engine and a port LoRA engine
    (``waves``: index groups, each run to completion before the next)."""
    jcfg, jm, values, tm, params, adapters = olmo
    lora_kw = lora_kw or dict(rank=RANK, alpha=ALPHA, max_loaded_adapters=4)
    sched_kw = sched_kw or {}
    jeng = JLLMEngine(jm, values, JEngineConfig(
        **_cfg_kw(JLoRAConfig(**lora_kw), **kw), num_state_slots=16,
        scheduler=_sched(JSchedulerConfig, **sched_kw),
        kv_quant=None if quant is None else JQuantConfig(bits=quant)))
    teng = LLMEngine(tm, params, EngineConfig(
        **_cfg_kw(LoRAConfig(**lora_kw), **kw), device="cpu",
        scheduler=_sched(SchedulerConfig, **sched_kw),
        kv_quant=None if quant is None else QuantConfig(bits=quant)))
    for aid in sorted({a for a in aids if a is not None}):
        jeng.register_adapter(aid, adapters[aid])
        teng.register_adapter(aid, adapters[aid])
    for wave in waves or [range(len(prompts))]:
        for i in wave:
            jeng.add_request(JRequest(request_id=f"r{i}", prompt=list(prompts[i]),
                                      adapter_id=aids[i],
                                      sampling=JSamplingParams(max_new_tokens=max_new)))
            teng.add_request(Request(request_id=f"r{i}", prompt=list(prompts[i]),
                                     adapter_id=aids[i],
                                     sampling=SamplingParams(max_new_tokens=max_new)))
        jeng.run()
        teng.run()
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    assert all(len(t) > 0 for t in tout.values())
    assert tout == jout
    assert dataclasses.asdict(teng.adapters.stats) == dataclasses.asdict(jeng.adapters.stats)
    assert teng.paged_steps == teng.steps and teng.host_copy_bytes == 0
    return jeng, teng


def _prompts(cfg, rng, n=4):
    return [list(map(int, rng.integers(2, cfg.vocab_size, size=int(rng.integers(10, 40)))))
            for _ in range(n)]


def _dense_merged_streams(olmo, aids, prompts, max_new=6):
    """Per tenant, a port engine without LoRA over the dense-merged weights."""
    _, _, _, tm, params, adapters = olmo
    out = {}
    for aid in set(aids):
        p = merge_adapter(params, adapters[aid], tm.cfg, LC) if aid else params
        eng = LLMEngine(tm, p, EngineConfig(**_cfg_kw(None), device="cpu",
                                            scheduler=_sched(SchedulerConfig)))
        for i, a in enumerate(aids):
            if a == aid:
                eng.add_request(Request(request_id=f"r{i}", prompt=list(prompts[i]),
                                        sampling=SamplingParams(max_new_tokens=max_new)))
        eng.run()
        out.update({rid: s.generated for rid, s in eng.seqs.items()})
    return out


def test_mixed_adapter_batch_matches_jax_and_dense_merge(olmo):
    prompts = _prompts(olmo[0], np.random.default_rng(3))
    aids = ["a0", "a1", None, "a0"]
    _, teng = _drive_both(olmo, aids, prompts)
    assert teng.adapters.stats.misses == 2  # both tenants faulted in once
    snap = teng.metrics_snapshot()
    assert snap["lora.misses"] == 2 and snap["lora.loads"] == 2
    assert snap["lora.rented_pages"] == teng.adapters.rented_pages > 0
    assert snap["lora.load_bytes"] == 2 * teng.adapters.nbytes_per_adapter
    dense = _dense_merged_streams(olmo, aids, prompts)
    assert {rid: s.generated for rid, s in teng.seqs.items()} == dense


def test_adapter_churn_under_preemption_matches_jax(olmo):
    """Tight pool + more tenants than slots: adapters fault and evict while
    sequences preempt; streams equal JAX's and the roomy run's."""
    prompts = _prompts(olmo[0], np.random.default_rng(5))
    aids = ["a0", "a1", "a2", "a0"]
    lora_kw = dict(rank=RANK, alpha=ALPHA, max_loaded_adapters=2)
    jeng, tight = _drive_both(olmo, aids, prompts, lora_kw=lora_kw, num_blocks=64)
    assert tight.adapters.stats.evictions >= 1
    assert tight.metrics_snapshot()["engine.preemptions"] == \
        jeng.metrics_snapshot()["engine.preemptions"]
    dense = _dense_merged_streams(olmo, aids, prompts)
    assert {rid: s.generated for rid, s in tight.seqs.items()} == dense


def test_one_adapter_per_batch_grouping_matches_jax(olmo):
    """``max_adapters_per_batch=1`` groups steps by tenant: every plan holds
    at most one adapter, and the streams still equal JAX's and the dense
    merge."""
    prompts = _prompts(olmo[0], np.random.default_rng(11))
    aids = ["a0", "a1", "a2", "a1"]
    seen = []
    plan = Scheduler.plan

    def recorded(self, *a, **k):  # the adapters of every port plan
        p = plan(self, *a, **k)
        seen.append({c.seq.request.adapter_id for c in p.chunks} - {None})
        return p
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Scheduler, "plan", recorded)
        _, teng = _drive_both(olmo, aids, prompts,
                              sched_kw=dict(max_adapters_per_batch=1))
    assert teng.scheduler.cfg.max_adapters_per_batch == 1
    assert seen and max(len(s) for s in seen) == 1
    dense = _dense_merged_streams(olmo, aids, prompts)
    assert {rid: s.generated for rid, s in teng.seqs.items()} == dense


def test_pool_cap_clamps_adapters_per_batch_like_jax(olmo):
    """A pool cap of one adapter's rent clamps the grouping cap to 1: the
    tenants rotate through the store, streams as JAX's."""
    tm = olmo[3]
    probe = LLMEngine(tm, olmo[4], EngineConfig(**_cfg_kw(LC), device="cpu"))
    ppa = probe.adapters.pages_per_adapter
    prompts = _prompts(olmo[0], np.random.default_rng(31))
    aids = ["a0", "a1", "a2", "a1"]
    _, teng = _drive_both(olmo, aids, prompts, lora_kw=dict(
        rank=RANK, alpha=ALPHA, max_loaded_adapters=4, pool_pages=ppa))
    assert teng.scheduler.cfg.max_adapters_per_batch == 1
    assert teng.adapters.rented_pages <= ppa and teng.adapters.stats.evictions >= 2


def test_lora_over_kivi_pages_matches_jax(olmo):
    prompts = _prompts(olmo[0], np.random.default_rng(17))
    _, teng = _drive_both(olmo, ["a0", "a1", None, "a0"], prompts, quant=8)
    assert teng.store.quantized


def test_prefix_cache_is_adapter_namespaced_like_jax(olmo):
    """An identical prompt under another adapter (or none) never hits a
    tenant's cached blocks; the same tenant reuses them."""
    prompt = list(map(int, np.random.default_rng(29).integers(2, olmo[0].vocab_size,
                                                              size=24)))
    aids = ["a0", "a1", "a0", None]
    jeng, teng = _drive_both(olmo, aids, [prompt] * 4, max_new=4,
                             enable_prefix_cache=True, waves=[[0], [1], [2], [3]])
    hits = {rid: s.prefix_hit_tokens for rid, s in teng.seqs.items()}
    assert hits == {rid: s.prefix_hit_tokens for rid, s in jeng.seqs.items()}
    assert hits["r1"] == 0 and hits["r3"] == 0 and hits["r2"] >= 16
    dense = _dense_merged_streams(olmo, aids, [prompt] * 4, max_new=4)
    assert {rid: s.generated for rid, s in teng.seqs.items()} == dense


def test_adapter_requests_refused_without_lora_or_registration(olmo):
    tm, params = olmo[3], olmo[4]
    plain = LLMEngine(tm, params, EngineConfig(**_cfg_kw(None), device="cpu"))
    with pytest.raises(ValueError, match="EngineConfig.lora"):
        plain.add_request(Request(request_id="r0", prompt=[3, 4, 5], adapter_id="a0"))
    with pytest.raises(ValueError, match="EngineConfig.lora"):
        plain.register_adapter("a0", olmo[5]["a0"])
    eng = LLMEngine(tm, params, EngineConfig(**_cfg_kw(LC), device="cpu"))
    eng.add_request(Request(request_id="r0", prompt=[3, 4, 5, 6], adapter_id="ghost",
                            sampling=SamplingParams(max_new_tokens=2)))
    with pytest.raises(KeyError, match="ghost"):
        eng.run()


def test_serve_entry_point_reports_lora(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "4", "--num-adapters", "2"])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke on cpu: 4 requests" in out
    assert "lora=2 adapters r8 (hits=" in out and "misses=2 evicts=0" in out
    assert "pages rented)" in out
