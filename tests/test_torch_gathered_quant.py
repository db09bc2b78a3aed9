"""Quantized KV stores on the port's gathered backend vs the JAX package's,
on the CPU.

KIVI pages (``kv_quant=QuantConfig(bits)``, keys per channel, values per
token, no GEAR residual: ``PagedModelState.quantized``) on olmo-1b under
``execution_backend="gathered"`` and on starcoder2-3b (no paged family), at
8 and 4 bits: greedy streams EQUAL JAX's gathered engine's, ``host_copy_bytes``
equal, and after the serve the stores agree as
``test_torch_engine_quant._stores_agree`` holds them (``block_quantized``
equal; codes, planes and staging apart only where XLA's and PyTorch's f32
sums put a value on the other side of a rounding boundary; the port's pack
of JAX's own staging pages byte-equal to JAX's). olmo-1b's gathered KIVI
streams equal the port's paged KIVI streams. The window the gathered runner
dequantizes on its device (``gathered.dequantize_window``, the unpack's
plain version on the CPU) is bit-equal to the store's host dequantization.

The fallback round trip (MLA latents under any ``kv_quant``, a GEAR
``residual_rank``, non-KIVI axes: fp stores, each written value quantized
and dequantized in ``scatter``): on IDENTICAL windows the port's store and
JAX's end byte-equal, on configs whose stage repeats a pattern slot (R = 2:
the statistics pool the repeats); served end to end, streams equal JAX's
and the stores agree within a few code steps. And ``make_runners``' routing:
a paged runner only for KIVI pages on a pure global-attention stack.
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
from repro.core.executor.state import PagedModelState as JPagedModelState  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.core.executor.gathered import dequantize_window  # noqa: E402
from repro_torch.core.executor.state import PagedModelState  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from test_torch_engine_quant import _stores_agree  # noqa: E402

KIVI = [("olmo-1b", 8), ("olmo-1b", 4), ("starcoder2-3b", 8), ("starcoder2-3b", 4)]
# the fallback round trip's configs: a GEAR residual (its rank is not read),
# keys per token, values per channel (the axes are not read either)
FALLBACK = {"gear_r2": dict(bits=8, residual_rank=2),
            "keys_per_token": dict(bits=4, key_axis="token"),
            "values_per_channel": dict(bits=8, value_axis="channel")}
SCHED = dict(max_batch_slots=8, max_batched_tokens=64, prefill_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread: on a shared machine
    a contended thread pool makes each small op take milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_request(r):
    sp = r.sampling
    return Request(request_id=r.request_id, prompt=list(r.prompt), user_id=r.user_id,
                   sampling=SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                                           max_new_tokens=sp.max_new_tokens,
                                           stop_token=sp.stop_token))


_MODELS = {}


def _built(arch, repeats=None):
    """(JAX model, port model) of an arch's smoke config, without weights;
    ``repeats``: the last slot of its smoke pattern repeated that many times
    as the one stage, on both sides."""
    cfgs = [jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)]
    if repeats is not None:
        cfgs = [dataclasses.replace(c, stages=((c.stages[0][0][1:], repeats),))
                for c in cfgs]
    return jbuild_model(cfgs[0]), build_model(cfgs[1], device="cpu")


def _models(arch, repeats=None):
    """(JAX model, JAX values, port model, port params) as ``_built``, with
    the JAX init, converted."""
    key = (arch, repeats)
    if key not in _MODELS:
        if repeats is None:
            _, jm, values = bcommon.small_model(arch)
            tm = build_model(tconfigs.smoke_config(arch), device="cpu")
        else:
            jm, tm = _built(arch, repeats)
            values, _ = split_params(jm.init(jax.random.PRNGKey(0), max_seq=512))
        _MODELS[key] = (jm, values, tm, convert_params(tm.cfg, values))
    return _MODELS[key]


def _serve_both(arch, qc, seed, *, repeats=None, backend="auto", n=6, **kw):
    jm, values, tm, params = _models(arch, repeats)
    reqs = bcommon.make_requests(jm.cfg, n, np.random.default_rng(seed))
    common = dict(block_size=8, num_blocks=512, max_model_len=256,
                  execution_backend=backend, **kw)
    jeng = JLLMEngine(jm, values, JEngineConfig(
        kv_quant=None if qc is None else JQuantConfig(**qc),
        scheduler=JSchedulerConfig(**SCHED), **common))
    teng = LLMEngine(tm, params, EngineConfig(
        kv_quant=None if qc is None else QuantConfig(**qc), device="cpu",
        scheduler=SchedulerConfig(**SCHED), **common))
    for r in reqs:
        jeng.add_request(dataclasses.replace(r))
        teng.add_request(_port_request(r))
    jeng.run()
    teng.run()
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    assert len(tout) == n and all(len(t) > 0 for t in tout.values())
    return jeng, teng, jout, tout


@pytest.fixture(scope="module", params=KIVI, ids=[f"{a}-{b}bit" for a, b in KIVI])
def kivi_serve(request):
    arch, bits = request.param
    return _serve_both(arch, dict(bits=bits), 3, n=4,
                       backend="gathered" if arch == "olmo-1b" else "auto")


def test_kivi_gathered_streams_equal_jax(kivi_serve):
    jeng, teng, jout, tout = kivi_serve
    assert tout == jout
    assert teng.paged_runner is None and jeng.paged_runner is None
    assert teng.store.quantized and jeng.store.quantized
    assert teng.steps == jeng.steps == teng.runner.steps
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    # the upload is the distinct blocks' codes and planes, not the fp window
    assert 0 < teng.runner.window_upload_bytes < teng.host_copy_bytes


def test_kivi_gathered_store_agrees_with_jax(kivi_serve):
    jeng, teng, _, _ = kivi_serve
    _stores_agree(jeng, teng)


@pytest.mark.parametrize("bits", [8, 4])
def test_olmo_gathered_kivi_equals_port_paged(bits):
    """The parity the reference's gathered backend exists for: the same
    KIVI trace on the port's gathered and paged backends."""
    outs, engs = [], []
    for backend in ("gathered", "paged"):
        _, _, tm, params = _models("olmo-1b")
        eng = LLMEngine(tm, params, EngineConfig(
            block_size=8, num_blocks=512, max_model_len=256, device="cpu",
            execution_backend=backend, kv_quant=QuantConfig(bits=bits),
            scheduler=SchedulerConfig(**SCHED)))
        for r in bcommon.make_requests(tm.cfg, 6, np.random.default_rng(4)):
            eng.add_request(_port_request(r))
        eng.run()
        outs.append({rid: s.generated for rid, s in eng.seqs.items()})
        engs.append(eng)
    gathered, paged = engs
    assert outs[0] == outs[1]
    assert gathered.paged_steps == 0 and paged.paged_steps == paged.steps == gathered.steps
    # the paged engine reserves a scratch block first, so block ids differ:
    # compare what each sequence's table holds packed
    for rid, seq in gathered.seqs.items():
        np.testing.assert_array_equal(
            gathered.store.block_quantized[seq.block_table],
            paged.store.block_quantized[paged.seqs[rid].block_table])


def test_device_window_bit_equal_to_host_dequantization():
    """Mid-serve, with packed blocks and blocks still filling: the runner's
    window (codes and planes of the distinct blocks, dequantized by the
    unpack's plain version, staging overlaid, spread by the table) equals
    the store's host window bit for bit, and both charge the fp window."""
    _, _, tm, params = _models("olmo-1b")
    eng = LLMEngine(tm, params, EngineConfig(
        block_size=8, num_blocks=128, max_model_len=128, device="cpu",
        execution_backend="gathered", kv_quant=QuantConfig(bits=4),
        scheduler=SchedulerConfig(**SCHED)))
    for r in bcommon.make_requests(tm.cfg, 4, np.random.default_rng(6)):
        eng.add_request(_port_request(r))
    for _ in range(7):
        eng.step()
    store = eng.store
    seqs = list(eng.seqs.values())
    tables = np.zeros((len(seqs), 128 // 8), np.int64)
    for b, s in enumerate(seqs):
        tables[b, :len(s.block_table)] = s.block_table
    used = np.unique(tables)
    assert store.block_quantized[used].any() and not store.block_quantized[used].all()
    h0 = store.host_copy_bytes
    host = store.gather(tables)
    h1 = store.host_copy_bytes
    dev = dequantize_window(store.gather_quantized(tables), "cpu", store.dtype)
    assert store.host_copy_bytes - h1 == h1 - h0 > 0
    for hl, dl in zip(host, dev):
        for n in ("k", "v"):
            assert hl[n].shape == dl[n].shape == (
                len(seqs), 128, tm.cfg.num_kv_heads, tm.cfg.head_dim)
            assert torch.equal(hl[n], dl[n])


# ---------------------------------------------------------------------------
# the fallback round trip
# ---------------------------------------------------------------------------

def _jax_leaf(jstore, si, i, name):
    for li, path in enumerate(jstore.paths):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys == ["stages", si, f"l{i}", name]:
            return li
    raise KeyError((si, i, name))


def _port_vs_jax_leaves(cfg, jstore, tstore):
    """(JAX leaf index, repeat, port store index) for every port store, in
    ``models/convert.py``'s order of layers."""
    idx = {(layer, name): li for layer, name, li in tstore._leaves}
    offset = 0
    for si, (pattern, reps) in enumerate(cfg.stages):
        for r in range(reps):
            for i in range(len(pattern)):
                for layer, name in [k for k in idx if k[0] == offset + r * len(pattern) + i]:
                    yield _jax_leaf(jstore, si, i, name), r, idx[layer, name]
        offset += len(pattern) * reps


def _as_jax(tstore, li, jshape):
    """A port store (heads, NB, P, width) in JAX's (NB, P, ...) layout."""
    return tstore.stores[li].permute(1, 2, 0, 3).reshape(jshape).numpy()


# arch, repeats of the last slot of its smoke pattern
ROUND_TRIP_MODELS = {"olmo-R2": ("olmo-1b", 2), "deepseek-R2": ("deepseek-v3-671b", 2)}


@pytest.mark.parametrize("model", sorted(ROUND_TRIP_MODELS))
@pytest.mark.parametrize("qc", sorted(FALLBACK))
def test_round_trip_store_bytes_equal_jax(model, qc):
    """Two scatters of the same ragged rows of the same random windows into
    JAX's store and the port's: every store byte-equal."""
    jm, tm = _built(*ROUND_TRIP_MODELS[model])
    W, bs = 32, 8
    kw = dict(block_size=bs, num_blocks=24, max_model_len=W,
              kv_quant=JQuantConfig(**FALLBACK[qc]))
    jstore = JPagedModelState(jm, JEngineConfig(**kw))
    kw["kv_quant"] = QuantConfig(**FALLBACK[qc])
    tstore = PagedModelState(tm.cfg, EngineConfig(device="cpu", **kw), "cpu")
    assert not jstore.quantized and not tstore.quantized
    tables = np.arange(16, dtype=np.int64).reshape(4, 4)[:, ::-1].copy()
    rng = np.random.default_rng(2)
    # two row lengths only: JAX compiles its eager round trip per shape
    for starts, lens in (([0, 0, 0, 0], [13, 1, 13, 1]), ([13, 1, 13, 1], [1, 13, 0, 1])):
        jcache = jax.tree.map(lambda a: rng.normal(size=(a.shape[0], 4) + a.shape[2:])
                              .astype(np.float32), jax.eval_shape(
                                  lambda: jm.init_cache(1, W)))
        tcache = tm.init_cache(4, W)
        for jl, r, tl in _port_vs_jax_leaves(tm.cfg, jstore, tstore):
            layer, name, _ = tstore._leaves[tl]
            tcache[layer][name].copy_(torch.from_numpy(
                jax.tree_util.tree_leaves(jcache)[jl][r]))
        jstore.scatter(jax.tree.map(jnp.asarray, jcache), tables, np.zeros(4, np.int32),
                       starts, lens, quant=jstore.quant)
        tstore.scatter(tcache, tables, starts, lens, quant=tstore.quant)
    assert tstore.host_copy_bytes == jstore.host_copy_bytes > 0
    for jl, r, tl in _port_vs_jax_leaves(tm.cfg, jstore, tstore):
        want = jstore.stores[jl][r]
        np.testing.assert_array_equal(_as_jax(tstore, tl, want.shape), want)


@pytest.mark.parametrize("qc", ["gear_r2", "keys_per_token"])
def test_round_trip_serve_matches_jax(qc):
    """olmo-1b's smoke layer repeated twice (R = 2); deepseek's latents are
    served in ``test_torch_deepseek.py``."""
    qc = FALLBACK[qc]
    jeng, teng, jout, tout = _serve_both("olmo-1b", qc, 5, repeats=2, n=3)
    assert tout == jout
    assert teng.paged_runner is None and jeng.paged_runner is None
    assert not teng.store.quantized and teng.store.qplanes == {}
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    # stores: the same round trip of values XLA and PyTorch computed in
    # other summation orders; a value on a rounding boundary moves by one
    # code step, at most a 1/15 of its group's range at 4 bits
    js, ts = jeng.store, teng.store
    for jl, r, tl in _port_vs_jax_leaves(teng.model.cfg, js, ts):
        want = js.stores[jl][r]
        got = _as_jax(ts, tl, want.shape)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got, want, atol=scale * 2 / (2 ** qc["bits"] - 1))


def test_round_trip_changes_what_is_stored():
    """The round trip is not a no-op: at 4 bits the stored latents are not
    the fp latents an unquantized serve stores."""
    out = {}
    _, tm = _built("deepseek-v3-671b")
    params = tm.init(0)
    for qc in (None, dict(bits=4)):
        eng = LLMEngine(tm, params, EngineConfig(
            block_size=8, num_blocks=64, max_model_len=64, device="cpu",
            kv_quant=None if qc is None else QuantConfig(**qc),
            scheduler=SchedulerConfig(**SCHED)))
        eng.add_request(Request(request_id="r", prompt=list(range(2, 30)),
                                sampling=SamplingParams(max_new_tokens=1)))
        eng.step()
        out[qc is None] = eng.store.stores[0][:, eng.seqs["r"].block_table[0]].clone()
    assert not torch.equal(out[True], out[False])
    assert torch.allclose(out[True], out[False], atol=out[True].abs().max().item() / 7)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_kv_quant_routing_on_mla_and_window_stacks():
    """An MLA stack (deepseek) and a window stack (starcoder2-3b) have no
    paged runner under any kv_quant; KIVI pages need an attention K/V store
    (starcoder2-3b's is quantized, deepseek's latents are not); asking for
    the paged backend raises."""
    for arch, quantized in (("deepseek-v3-671b", False), ("starcoder2-3b", True)):
        _, tm = _built(arch)
        params = tm.init(0)
        for qc in (QuantConfig(bits=8), QuantConfig(bits=8, residual_rank=2)):
            eng = LLMEngine(tm, params, EngineConfig(device="cpu", kv_quant=qc,
                                                     num_blocks=64))
            assert eng.paged_runner is None
            assert eng.store.quantized == (quantized and qc.residual_rank == 0)
            assert bool(eng.store.attn_kv_leaves()) == (arch == "starcoder2-3b")
        with pytest.raises(ValueError, match="no paged decode path"):
            LLMEngine(tm, params, EngineConfig(device="cpu", kv_quant=QuantConfig(bits=8),
                                               num_blocks=64, execution_backend="paged"))
