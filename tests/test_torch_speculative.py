"""The port's speculative decoding vs the JAX package, on the CPU.

Sampler: ``sampling_probs`` on the same numpy logits equals JAX's within
1e-6 (greedy, temperature, top-k, ties at the kth value); greedy
``rejection_sample`` gives JAX's tokens and accepted counts; a draft equal
to the target accepts everything; under temperature and top-k the first
emitted token follows ``sampling_probs(target)`` (total variation over
40 000 draws from a seeded generator, bound stated below).

Model: ``verify_paged`` over C=4 positions equals 4 sequential
``decode_paged`` steps (logits and pages within 2e-2, as the reference
test holds them) and JAX's ``verify_paged`` on the same pages (f32 logits
within 1e-4: XLA and PyTorch sum in other orders).

Engine: the same weights (the JAX init, converted), the same prompts, on
three engines: the JAX speculative engine, the port's speculative engine
and the port's plain paged engine. Greedy streams must be EQUAL over every
case of ``CASES`` and ``PAGE_CASES`` (the latter run from
``test_torch_speculative_pages.py``), and ``spec.*`` counts, draft catch-up tokens and draft
resets equal JAX's. KIVI cases also hold the stores: pages of the first
layer (whose K/V depend on the tokens alone) byte-equal to the plain
paged run's on every packed page of the same content (at 4 bits, those
of the streams' common prefixes, which hold generated tokens too), so no
rejected token reached a page's statistics; every packed page against
JAX's speculative engine as ``test_torch_engine_quant.py`` holds the
plain path. Later layers' pages are not byte-equal to plain paged
decoding by design, in both packages: a verify chunk that crosses a page
boundary attends the page it just filled through the fp tail, where plain
decoding reads it packed. At 4 bits that difference flips a greedy token
of the ``kivi4`` trace, in JAX's engines as in the port's: the test
asserts that JAX's two engines part there, then holds the speculative
streams to JAX's speculative engine and the plain streams to JAX's plain
engine.
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
from repro import core as jcore  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig, SpeculativeConfig,
                              TelemetryConfig, rejection_sample, sampling_probs)
from repro_torch.core.lora import LoRAConfig  # noqa: E402
from repro_torch.core.prefix_cache import chain_hashes  # noqa: E402
from repro_torch.core.scheduler import ChunkWork  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from test_torch_engine_quant import _stores_agree  # noqa: E402

ATOL = 1e-4  # f32 logits, 2 smoke layers, XLA vs PyTorch summation order
PROB_ATOL = 1e-6
# L1 distance of the first token's empirical distribution from the target's
# over N draws at V=8: its expectation is about sum_i sqrt(2 p_i / (pi N)),
# ~0.011 at N = 40 000; the bound is 4x that, so a sampler that ignored the
# residual (emitting the draft's distribution) fails by 0.3 or more
TV_DRAWS, TV_L1 = 40_000, 0.05


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def _ties_logits(rng):
    """(3, 4, 16) logits where the 4th-largest value of every row is shared
    by three entries: top_k=4 keeps all of them."""
    x = rng.normal(size=(3, 4, 16)).astype(np.float32)
    s = -np.sort(-x, axis=-1)
    kth = s[..., 3:4]
    below = np.argsort(x, axis=-1)[..., :2]  # two entries below the kth
    np.put_along_axis(x, below, kth, axis=-1)
    return x


@pytest.mark.parametrize("temperature,top_k,ties", [
    (0.0, 0, False), (0.7, 0, False), (1.0, 5, False), (0.8, 4, True)],
    ids=["greedy", "temperature", "top_k", "top_k_ties"])
def test_sampling_probs_match_jax(temperature, top_k, ties):
    rng = np.random.default_rng(5)
    x = _ties_logits(rng) if ties else (rng.normal(size=(3, 4, 16)) * 2).astype(np.float32)
    sp = SamplingParams(temperature=temperature, top_k=top_k)
    jsp = jcore.SamplingParams(temperature=temperature, top_k=top_k)
    got = sampling_probs(torch.from_numpy(x), sp).numpy()
    want = np.asarray(jcore.sampling_probs(jnp.asarray(x), jsp))
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    if ties:
        assert ((got > 0).sum(-1) == 6).all()  # 4 + the two tied entries


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_rejection_matches_jax(seed):
    """Drafts that agree with the target's argmax on a random prefix of
    positions: tokens and accepted counts equal JAX's."""
    B, k, V = 6, 4, 32
    rng = np.random.default_rng(seed)
    tl = (rng.normal(size=(B, k + 1, V)) * 2).astype(np.float32)
    dl = (rng.normal(size=(B, k, V)) * 2).astype(np.float32)
    agree = rng.integers(0, k + 1, size=B)  # positions [0, agree) agree
    for b in range(B):
        for j in range(agree[b]):
            dl[b, j] = tl[b, j]
        if agree[b] < k:  # the next draft is the target's second choice
            j = agree[b]
            dl[b, j] = tl[b, j]
            dl[b, j, tl[b, j].argmax()] = -10.0
    draft = dl.argmax(-1).astype(np.int32)
    sp, jsp = SamplingParams(), jcore.SamplingParams()
    gen = torch.Generator().manual_seed(seed)
    toks, na = rejection_sample(gen, torch.from_numpy(draft), torch.from_numpy(dl),
                                torch.from_numpy(tl), sp)
    jtoks, jna = jcore.rejection_sample(jax.random.PRNGKey(seed), jnp.asarray(draft),
                                        jnp.asarray(dl), jnp.asarray(tl), jsp)
    np.testing.assert_array_equal(na.numpy(), np.asarray(jna))
    np.testing.assert_array_equal(na.numpy(), agree)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for b in range(B):  # the emitted run ends on the target's argmax
        assert toks[b, agree[b]].item() == tl[b, agree[b]].argmax()


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 8)],
                         ids=["greedy", "temperature_top_k"])
def test_rejection_accepts_all_when_draft_is_target(temperature, top_k):
    B, k, V = 64, 4, 32
    rng = np.random.default_rng(3)
    tl = torch.from_numpy((rng.normal(size=(B, k + 1, V)) * 2).astype(np.float32))
    sp = SamplingParams(temperature=temperature, top_k=top_k)
    gen = torch.Generator().manual_seed(7)
    q = sampling_probs(tl[:, :k], sp)
    draft = torch.multinomial(q.reshape(B * k, V), 1, generator=gen).reshape(B, k)
    _, na = rejection_sample(gen, draft, tl[:, :k], tl, sp)
    assert (na == k).all()


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 4)],
                         ids=["temperature", "temperature_top_k"])
def test_first_token_is_target_distributed(temperature, top_k):
    """The draft proposes from its own distribution on every row; the first
    emitted token's distribution must be the TARGET's."""
    V, k, N = 8, 3, TV_DRAWS
    rng = np.random.default_rng(11)
    tl = torch.from_numpy((rng.normal(size=(1, k + 1, V)) * 2).astype(np.float32))
    dl = torch.from_numpy((rng.normal(size=(1, k, V)) * 2).astype(np.float32))
    sp = SamplingParams(temperature=temperature, top_k=top_k)
    gen = torch.Generator().manual_seed(0)
    q = sampling_probs(dl, sp)[0]  # (k, V)
    draft = torch.stack([torch.multinomial(q[j], N, replacement=True, generator=gen)
                         for j in range(k)], 1)
    toks, _ = rejection_sample(gen, draft, dl.expand(N, k, V), tl.expand(N, k + 1, V), sp)
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / N
    want = sampling_probs(tl, sp)[0, 0].numpy()
    jwant = np.asarray(jcore.sampling_probs(
        jnp.asarray(tl.numpy()), jcore.SamplingParams(temperature=temperature,
                                                      top_k=top_k)))[0, 0]
    np.testing.assert_allclose(want, jwant, atol=PROB_ATOL)
    assert np.abs(emp - want).sum() < TV_L1, (emp, want)
    assert np.abs(q[0].numpy() - want).sum() > 0.3  # the draft is far off


# ---------------------------------------------------------------------------
# verify_paged
# ---------------------------------------------------------------------------

_JAX, _PORT = {}, {}


def _jax_model(arch, seed=0):
    """JAX's smoke model and its init at ``seed`` (0: ``small_model``'s)."""
    if (arch, seed) not in _JAX:
        cfg, jm, values = bcommon.small_model(arch)
        if seed:
            values = split_params(jm.init(jax.random.PRNGKey(seed), max_seq=512))[0]
        _JAX[arch, seed] = (cfg, jm, values)
    return _JAX[arch, seed]


def _port_model(arch, seed=0):
    """The port's model and the JAX init at ``seed``, converted."""
    if (arch, seed) not in _PORT:
        values = jax.device_get(_jax_model(arch, seed)[2])
        tm = build_model(tconfigs.smoke_config(arch), device="cpu")
        _PORT[arch, seed] = (tm, convert_params(tm.cfg, values))
    return _PORT[arch, seed]


def test_verify_paged_matches_sequential_decode_and_jax():
    """Prefill 11 tokens through ``verify_paged``, then score C=4 tokens in
    one ``verify_paged`` and in 4 ``decode_paged`` steps on copies of the
    same pages; the same verify on JAX's model over the same pages."""
    jcfg, jm, values = _jax_model("olmo-1b")
    tm, params = _port_model("olmo-1b")
    NB, P, B, C = 16, 8, 2, 4
    KV, D = tm.cfg.num_kv_heads, tm.cfg.head_dim
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, tm.cfg.vocab_size, size=(B, 11))
    tables = torch.tensor([list(range(8)), list(range(8, 16))])
    pages = tm.init_pages(NB, P)
    tm.verify_paged(params, torch.from_numpy(prompt), pages, tables, torch.zeros(B))
    toks = rng.integers(2, tm.cfg.vocab_size, size=(B, C))
    seq_pages = [{n: x.clone() for n, x in pg.items()} for pg in pages]
    jpages = ({"r0": {f"l{i}": {n: jnp.asarray(x.numpy().copy()) for n, x in pg.items()}
                      for i, pg in enumerate(pages)}},)
    seq_logits = []
    for j in range(C):
        lg, _, _ = tm.decode_paged(params, torch.from_numpy(toks[:, j: j + 1]), seq_pages,
                                   tables, torch.full((B,), 11 + j))
        seq_logits.append(lg[:, 0])
    vg, vpages, writes = tm.verify_paged(params, torch.from_numpy(toks), pages, tables,
                                         torch.full((B,), 11))
    assert vg.shape == (B, C, tm.cfg.vocab_size)
    np.testing.assert_allclose(vg.numpy(), torch.stack(seq_logits, 1).numpy(),
                               atol=2e-2, rtol=2e-2)
    for a, b in zip(vpages, seq_pages):
        for n in ("k", "v"):
            np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), atol=2e-2)
    assert writes[0]["k"].shape == (B, C, KV, D)
    jg, _, _ = jm.verify_paged(values, jnp.asarray(toks, jnp.int32), jpages,
                               jnp.asarray(tables.numpy(), jnp.int32),
                               jnp.full((B,), 11, jnp.int32))
    np.testing.assert_allclose(vg.numpy(), np.asarray(jg, np.float32), atol=ATOL, rtol=0)


def test_verify_paged_absent_without_paged_path():
    tm = build_model(tconfigs.smoke_config("starcoder2-3b"), device="cpu")
    assert tm.verify_paged is None and tm.decode_paged is None


# ---------------------------------------------------------------------------
# engine: port speculative == port paged == JAX speculative
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str = "olmo-1b"
    k: int = 4
    draft_seed: int = 0  # 0: self-speculation
    min_acceptance: float = 0.0
    window: int = 64
    prompts: str = "make_requests"  # make_requests | reference | shared | edge
    seed: int = 3
    n: int = 4
    max_new: int = 8
    num_blocks: int = 128
    prefix_cache: bool = True
    bits: int = 0  # KIVI pages at this many bits
    adapters: tuple = ()  # adapter id (or None) per request, cycled
    stop: bool = False  # stop token: the plain stream's third token


CASES = [
    Case("self", seed=7),
    # a low-acceptance draft: also the tail-block rollback (blocks allocated
    # for 1 + k positions and freed past the accepted run)
    Case("hostile", k=3, draft_seed=99, prompts="reference", seed=13),
    Case("auto_disable", k=3, draft_seed=5, min_acceptance=0.9, window=12,
         prompts="reference", seed=17, max_new=10),
    Case("prefix_cache_cow", prompts="shared", max_new=6),
    Case("preemption", prompts="shared", max_new=6, num_blocks=10,
         prefix_cache=False),
    Case("window_edge", prompts="edge", seed=37, max_new=16),
    Case("stop_in_accepted_run", prompts="reference", seed=23, n=3, max_new=16,
         stop=True),
]
# KIVI pages, LoRA and GQA: the same parity test, run from
# tests/test_torch_speculative_pages.py so that the runner's workers share
# the load
PAGE_CASES = [
    Case("kivi8", bits=8, n=6, seed=31),
    Case("kivi4", bits=4, n=6, seed=31),
    Case("kivi8_hostile", k=3, draft_seed=99, bits=8, n=6, seed=31),
    Case("lora", adapters=("a0", "a1", None, "a0"), prompts="reference", seed=3,
         max_new=6),
    Case("qwen2.5-32b", arch="qwen2.5-32b", seed=7),
]
LORA = dict(rank=4, alpha=8.0, max_loaded_adapters=4)


def _prompts(case, cfg):
    """Token lists, max_new_tokens per request."""
    rng = np.random.default_rng(case.seed)
    if case.prompts == "make_requests":
        reqs = bcommon.make_requests(cfg, case.n, rng, prompt_hi=40, gen_hi=case.max_new + 4)
        return [list(r.prompt) for r in reqs], [r.sampling.max_new_tokens for r in reqs]
    if case.prompts == "shared":  # 24 shared tokens: later requests hit them
        prefix = list(map(int, rng.integers(2, cfg.vocab_size, size=24)))
        out = [prefix + list(map(int, rng.integers(2, cfg.vocab_size, size=n)))
               for n in (5, 9, 7, 11)]
    elif case.prompts == "edge":  # one row near the 128-token window edge
        out = [list(map(int, rng.integers(2, cfg.vocab_size, size=n))) for n in (118, 12)]
    else:  # the reference test's prompts
        out = [list(map(int, rng.integers(2, cfg.vocab_size, size=int(rng.integers(10, 40)))))
               for _ in range(case.n)]
    return out, [case.max_new] * len(out)


def _engine_kw(case, backend):
    return dict(block_size=8, num_blocks=case.num_blocks, max_model_len=128,
                execution_backend=backend, enable_prefix_cache=case.prefix_cache)


def _jax_engine(case, backend="speculative"):
    _, jm, values = _jax_model(case.arch)
    draft = _jax_model(case.arch, case.draft_seed)[2] if case.draft_seed else None
    spec = jcore.SpeculativeConfig(
        num_draft_tokens=case.k, draft_model=jm if case.draft_seed else None,
        draft_params=draft, min_acceptance=case.min_acceptance,
        window=case.window) if backend == "speculative" else None
    return jcore.LLMEngine(jm, values, jcore.EngineConfig(
        **_engine_kw(case, backend), num_state_slots=16, speculative=spec,
        kv_quant=JQuantConfig(bits=case.bits) if case.bits else None,
        lora=JLoRAConfig(**LORA) if case.adapters else None,
        scheduler=JSchedulerConfig(max_batch_slots=4, max_batched_tokens=48,
                                   prefill_chunk=16)))


def _port_engine(case, backend="speculative", seed=0, telemetry=None):
    tm, params = _port_model(case.arch)
    spec = None
    if backend == "speculative":
        dm = dp = None
        if case.draft_seed:
            dm, dp = _port_model(case.arch, case.draft_seed)
        spec = SpeculativeConfig(num_draft_tokens=case.k, draft_model=dm, draft_params=dp,
                                 min_acceptance=case.min_acceptance, window=case.window)
    return LLMEngine(tm, params, EngineConfig(
        **_engine_kw(case, backend), device="cpu", seed=seed, speculative=spec,
        telemetry=telemetry,
        kv_quant=QuantConfig(bits=case.bits) if case.bits else None,
        lora=LoRAConfig(**LORA) if case.adapters else None,
        scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=48,
                                  prefill_chunk=16)))


def _serve(eng, case, prompts, max_new, jax_side, stop=None, temperature=0.0, top_k=0):
    """Serve the prompts (the shared-prefix trace under a prefix cache in two
    waves: the first request alone, so the others hit its published
    blocks)."""
    sp_cls = jcore.SamplingParams if jax_side else SamplingParams
    req_cls = jcore.Request if jax_side else Request
    if case.adapters:  # JAX's adapters, the same numpy trees on every engine
        jcfg = _jax_model(case.arch)[0]
        for aid in sorted({a for a in case.adapters if a is not None}):
            eng.register_adapter(aid, jmake_adapter(jcfg, JLoRAConfig(**LORA),
                                                    seed=int(aid[1:]) + 1))
    waves = [[0], list(range(1, len(prompts)))] \
        if case.prompts == "shared" and case.prefix_cache else [list(range(len(prompts)))]
    for wave in waves:
        for i in wave:
            aid = case.adapters[i % len(case.adapters)] if case.adapters else None
            eng.add_request(req_cls(
                request_id=f"r{i}", prompt=list(prompts[i]), adapter_id=aid,
                sampling=sp_cls(max_new_tokens=max_new[i], stop_token=stop,
                                temperature=temperature, top_k=top_k)))
        eng.run()
    return {rid: s.generated for rid, s in eng.seqs.items()}


def _packed_pages(eng):
    """Content hash -> (block id, whether the page holds a generated token)
    of every packed page the prefix cache holds (block ids differ between
    runs whose allocations differ)."""
    out, bs = {}, eng.cfg.block_size
    for s in eng.seqs.values():
        hashes = chain_hashes(s.all_tokens, bs, s.request.adapter_id)
        for i, (h, _) in enumerate(hashes):
            b = eng.prefix_cache._device.get(h)
            if b is not None and eng.store.block_quantized[b]:
                out[h] = (b, (i + 1) * bs > len(s.request.prompt))
    return out


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_spec_streams_equal_paged_and_jax(case):
    check_spec_case(case)


def check_spec_case(case):
    """Serve ``case`` on the three engines and hold them to each other."""
    cfg = tconfigs.smoke_config(case.arch)
    prompts, max_new = _prompts(case, cfg)
    peng = _port_engine(case, "paged")
    plain = _serve(peng, case, prompts, max_new, False)
    stop = None
    if case.stop:  # a stop token inside the first request's accepted run
        stop = plain["r0"][2]
        plain = _serve(_port_engine(case, "paged"), case, prompts, max_new, False, stop)
        assert len(plain["r0"]) == plain["r0"].index(stop) + 1 <= 3
    teng = _port_engine(case)
    jeng = _jax_engine(case)
    spec = _serve(teng, case, prompts, max_new, False, stop)
    jspec = _serve(jeng, case, prompts, max_new, True, stop)
    assert all(len(t) > 0 for t in spec.values())
    assert spec == jspec
    if case.bits == 4:
        # JAX's own speculative and paged engines part here too (module
        # docstring): that witness, and the plain streams held to JAX's
        # plain engine
        jplain = _serve(_jax_engine(case, "paged"), case, prompts, max_new, True)
        assert jspec != jplain
        assert plain == jplain
    else:
        assert spec == plain
    snap, jsnap = teng.metrics_snapshot(), jeng.metrics_snapshot()
    for key in ("spec.steps", "spec.proposed", "spec.accepted", "spec.emitted",
                "runner.spec.draft_catchup_tokens", "runner.spec.draft_resets",
                "engine.dispatch.speculative", "engine.dispatch.paged",
                "engine.preemptions"):
        assert snap[key] == jsnap[key], (key, snap[key], jsnap[key])
    assert snap["spec.steps"] > 0 and teng.host_copy_bytes == 0
    # one counter covers the host writebacks of both paths (JAX keeps two)
    assert snap["runner.paged.writeback_bytes"] == \
        jeng.paged_runner.writeback_bytes + jeng.spec_runner.writeback_bytes > 0
    st = teng.spec_stats
    assert st.disabled_at_step == jeng.spec_stats.disabled_at_step
    if case.draft_seed == 0 and not case.min_acceptance:
        # the draft's fp pages against the target's KIVI pages: not 1.0
        assert st.acceptance_rate == 1.0 if not case.bits else st.acceptance_rate > 0.5
        assert len(teng._spec_window) == 0  # min_acceptance 0: nothing kept
    if case.draft_seed in (42, 99):
        assert st.acceptance_rate < 0.5
    if case.min_acceptance:
        assert st.disabled_at_step is not None and not teng._spec_active
        assert teng.scheduler.cfg.speculative_tokens == 0
    if case.prompts == "shared" and case.prefix_cache:
        assert teng.seqs["r1"].prefix_hit_tokens >= 16
        assert snap["prefix_cache.hit_blocks"] == jsnap["prefix_cache.hit_blocks"] > 0
    if case.name == "preemption":
        assert snap["engine.preemptions"] > 0
    if case.prompts == "edge":  # the long row ran past the edge: peeled
        assert len(prompts[0]) + len(spec["r0"]) >= 128 - 1
    if case.name == "hostile":  # rolled back and finished: only the scratch
        # page and the prefix cache's blocks stay allocated
        assert all(not s.block_table for s in teng.seqs.values())
        assert teng.bm.used_blocks == 1 + teng.prefix_cache.cached_device_blocks()
    if case.adapters:
        assert teng.spec_runner.draft_lora_ok
        assert dataclasses.asdict(teng.adapters.stats) == \
            dataclasses.asdict(jeng.adapters.stats)
    if case.bits:
        assert teng.store.quantized and snap["store.pack_transfer_bytes"] > 0
        _stores_agree(jeng, teng)
        # the first layer's packed pages against the plain run's, by content:
        # at 8 bits every page (the streams are equal); at 4 bits the pages
        # of the streams' common prefixes, generated tokens among them
        got, want = _packed_pages(teng), _packed_pages(peng)
        same = got.keys() & want.keys()
        if case.bits == 8:
            assert got.keys() == want.keys()
        assert any(got[h][1] for h in same)
        for h in same:
            b, wb = got[h][0], want[h][0]
            for idx in (0, 1):  # the first layer's K and V
                assert torch.equal(teng.store.stores[idx][:, b], peng.store.stores[idx][:, wb])
                for n in ("scale", "zero"):
                    assert torch.equal(teng.store.qplanes[idx][n][:, b],
                                       peng.store.qplanes[idx][n][:, wb])


def test_spec_requires_paged_path():
    tm = build_model(tconfigs.smoke_config("starcoder2-3b"), device="cpu")
    cfg = EngineConfig(device="cpu", execution_backend="speculative")
    with pytest.raises(ValueError, match="no paged"):
        LLMEngine(tm, tm.init(0), cfg)
    # a draft without a paged path is refused too
    om, op = _port_model("olmo-1b")
    bad = SpeculativeConfig(draft_model=tm, draft_params=None)
    with pytest.raises(ValueError, match="no paged decode path"):
        LLMEngine(om, op, EngineConfig(device="cpu", speculative=bad))


def test_spec_engine_defaults_to_cuda():
    from repro_torch.launch.serve import build_engine

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine("olmo-1b", backend="speculative")


def test_spec_snapshot_check_clamps_watermark_after_cow():
    """A copy-on-write of a block under a running sequence's draft
    watermark: the next step's snapshot check clamps the watermark at the
    copied block and the catch-up recomputes from there, nothing before it;
    streams still equal plain paged decoding."""
    case = Case("cow")
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(2, 512, size=n))) for n in (30, 20)]
    max_new = [20, 20]
    plain = _serve(_port_engine(case, "paged"), case, prompts, max_new, False)
    eng = _port_engine(case)
    for i, p in enumerate(prompts):
        eng.add_request(Request(request_id=f"r{i}", prompt=list(p),
                                sampling=SamplingParams(max_new_tokens=max_new[i])))
    while eng.spec_stats.steps < 2:
        eng.step()
    seq = eng.seqs["r0"]
    runner = eng.spec_runner
    dc = runner._draft_computed["r0"]
    assert dc == seq.num_computed > 2 * eng.cfg.block_size
    # the prompt's full blocks are published, so shared with the prefix
    # cache: the engine's CoW copies block 1 of the table
    old = seq.block_table[1]
    eng._handle_cow(seq, ChunkWork(seq, eng.cfg.block_size, 1))
    assert seq.block_table[1] != old and eng.bm.stats.cow_copies == 1
    t0, r0 = runner.draft_catchup_tokens, runner.draft_resets
    eng.step()
    assert runner.draft_resets == r0 + 1
    assert runner.draft_catchup_tokens - t0 == dc - eng.cfg.block_size
    eng.run()
    assert {rid: s.generated for rid, s in eng.seqs.items()} == plain


def test_spec_lora_with_evictions_equals_paged():
    """More adapters than store slots (4 over 2, as the chip's LoRA serve
    runs): adapters fault in and evict between speculative steps, and the
    draft's catch-up and propose read whatever slot each row's adapter holds
    at that step. Self-speculation accepts every draft and the streams equal
    the plain paged engine's."""
    from repro_torch.core.lora import make_adapter

    tm, params = _port_model("olmo-1b")
    lora = LoRAConfig(rank=4, alpha=8.0, max_loaded_adapters=2)
    names = [f"a{j}" for j in range(4)]
    rng = np.random.default_rng(41)
    prompts = [list(map(int, rng.integers(2, tm.cfg.vocab_size, size=int(n))))
               for n in rng.integers(10, 40, size=6)]
    out = []
    for spec in (None, SpeculativeConfig(num_draft_tokens=3)):
        eng = LLMEngine(tm, params, EngineConfig(
            block_size=8, num_blocks=128, max_model_len=128, device="cpu",
            lora=lora, speculative=spec,
            scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=48,
                                      prefill_chunk=16)))
        for j, name in enumerate(names):
            eng.register_adapter(name, make_adapter(tm.cfg, lora, seed=j + 1))
        for i, p in enumerate(prompts):
            eng.add_request(Request(request_id=f"r{i}", prompt=list(p),
                                    adapter_id=(names + [None])[i % 5],
                                    sampling=SamplingParams(max_new_tokens=10)))
        eng.run()
        out.append(eng)
    plain, spec = out
    assert spec.spec_stats.steps > 0 and spec.spec_stats.acceptance_rate == 1.0
    assert spec.metrics_snapshot()["lora.evictions"] > 0
    assert {r: s.generated for r, s in spec.seqs.items()} == \
        {r: s.generated for r, s in plain.seqs.items()}


def test_spec_temperature_reproducible_within_port():
    case = Case("temperature", prompts="reference", seed=23, n=3)
    cfg = tconfigs.smoke_config("olmo-1b")
    prompts, max_new = _prompts(case, cfg)
    runs = [_serve(_port_engine(case, seed=s), case, prompts, max_new, False,
                   temperature=0.8, top_k=16) for s in (0, 0, 1)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_spec_traced_run_records_spans():
    case = Case("traced", prompts="reference", n=2, max_new=6)
    cfg = tconfigs.smoke_config("olmo-1b")
    prompts, max_new = _prompts(case, cfg)
    eng = _port_engine(case, telemetry=TelemetryConfig())
    tracer = eng.trace
    _serve(eng, case, prompts, max_new, False)
    names = {e.name for e in tracer.events}
    assert {"draft_catchup", "spec_propose", "spec_verify", "spec_accept"} <= names
    accepts = [e for e in tracer.events if e.name == "spec_accept"]
    assert len(accepts) == eng.spec_stats.steps
    assert sum(e.args["accepted"] for e in accepts) == eng.spec_stats.accepted
    dispatch = [e for e in tracer.events if e.name == "dispatch"
                and e.args["backend"] == "speculative"]
    assert len(dispatch) == eng.spec_stats.steps and dispatch[0].args["k"] == case.k


def test_serve_entry_point_reports_spec(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--backend", "speculative",
                "--spec-k", "3"])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke on cpu: 2 requests" in out
    assert "spec: acceptance=1.00 tokens/step=" in out and "steps=" in out
