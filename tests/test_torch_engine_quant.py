"""The port's KIVI-quantized serving path vs the JAX package, on the CPU.

Both engines serve the olmo-1b smoke model with the same weights (the JAX
init, converted) and ``kv_quant=QuantConfig(bits)`` on the paged backend
(JAX: ``paged_impl="ref"``, the jnp oracles; the port: the plain versions of
its kernels, since the tensors lie on the CPU). Greedy streams must be
EQUAL on every trace: a plain ``make_requests`` trace at 8 and 4 bits,
block size 4 with prompt chunks crossing several page fills, a shared
prefix (copy-on-write of quantized blocks), and a small pool with the prefix
cache off (preemption, recompute, repacking).

After a run the host stores agree too (``_stores_agree``): K and V come
from matmuls whose summation order differs between XLA and PyTorch, so a
value near a rounding boundary of the pack can land on either side; codes
may differ on at most 0.1% of elements, planes are f16 within rtol 1e-3,
``block_quantized`` is equal, and the port's pack of JAX's own staging
pages is byte-equal to JAX's. Also: the model's quantized ``decode_paged``
and ragged ``extend_paged`` against JAX on identical pages and tails
(f32 logits, atol 1e-4), a ``block_payload`` -> ``restore_block`` round
trip, and the capacity ratio at block size 32.
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
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels.kv_quant.ref import quantize_pages_ref as jquantize_pages_ref  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.kernels import kv_quant as tpa_quant  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ARCH = "olmo-1b"
ATOL = 1e-4  # f32 logits, 2 smoke layers, XLA vs PyTorch summation order


@pytest.fixture(scope="module")
def port_model():
    _, _, values = bcommon.small_model(ARCH)
    model = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    return model, convert_params(model.cfg, values)


def _port_request(r):
    sp = r.sampling
    return Request(request_id=r.request_id, prompt=list(r.prompt),
                   user_id=r.user_id,
                   sampling=SamplingParams(temperature=sp.temperature,
                                           top_k=sp.top_k,
                                           max_new_tokens=sp.max_new_tokens,
                                           stop_token=sp.stop_token))


def _serve_both(port_model, bits, reqs, *, waves=None, block_size=8,
                num_blocks=512, enable_prefix_cache=True, chunk=16,
                max_batched_tokens=64, max_batch_slots=8):
    """Serve ``reqs`` (in ``waves``: each wave runs to completion before the
    next arrives) on both engines with ``kv_quant`` at ``bits``."""
    model, params = port_model
    jeng = bcommon.make_engine(
        ARCH, block_size=block_size, num_blocks=num_blocks,
        enable_prefix_cache=enable_prefix_cache, paged_impl="ref",
        kv_quant=JQuantConfig(bits=bits),
        scheduler=JSchedulerConfig(max_batch_slots=max_batch_slots,
                                   max_batched_tokens=max_batched_tokens,
                                   prefill_chunk=chunk))
    teng = LLMEngine(model, params, EngineConfig(
        block_size=block_size, num_blocks=num_blocks, max_model_len=256,
        device="cpu", enable_prefix_cache=enable_prefix_cache,
        kv_quant=QuantConfig(bits=bits),
        scheduler=SchedulerConfig(max_batch_slots=max_batch_slots,
                                  max_batched_tokens=max_batched_tokens,
                                  prefill_chunk=chunk)))
    for wave in waves or [reqs]:
        for r in wave:
            teng.add_request(_port_request(r))
            jeng.add_request(dataclasses.replace(r))
        jeng.run()
        teng.run()
    assert jeng.store.quantized and teng.store.quantized
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    return jeng, teng, jout, tout


def _kernel_layout(a):
    """JAX store leaf (R=1, NB, bs, KV, X) -> the port's (KV, NB, bs, X)."""
    return np.asarray(a)[0].transpose(2, 0, 1, 3)


def _stores_agree(jeng, teng, max_frac=0.001):
    """Host stores after a run. ``block_quantized`` equal; f16 planes within
    rtol 1e-3 and an atol of the largest difference of the two stores' fp
    staging of that leaf (at least 1e-3: a layer's K and V differ where an
    earlier layer's codes did); codes differ on at most ``max_frac`` of the
    elements (0.1%),
    each by at most 1 plus 4 delta / scale code steps, where delta is the
    largest difference of the two staging pages over the code's group (it
    bounds the moves of x - lo and of the scale) — so a small-range group
    (4 tokens at block size 4) may turn a 1e-6 difference of K into
    several steps. And on JAX's own staging pages the
    port's pack equals JAX's ``quantize_pages_ref`` byte for byte. (JAX's
    store may differ from that by a code on a rounding boundary: its pack
    runs under ``jit``, whose fused division is not the eager one.)"""
    js, ts = jeng.store, teng.store
    np.testing.assert_array_equal(ts.block_quantized, js.block_quantized)
    packed = np.flatnonzero(ts.block_quantized)
    assert len(packed) > 0
    jleaves = js.attn_kv_leaves()
    assert len(jleaves) == len(ts.attn_kv_leaves())
    ndiff = total = 0
    for (_, _, _, jidx), (_, name, tidx) in zip(jleaves, ts.attn_kv_leaves()):
        jstage = _kernel_layout(js.qstage[jidx])[:, packed].astype(np.float32)
        tstage = ts.qstage[tidx][:, packed].float().numpy()
        atol = max(1e-3, float(np.abs(tstage - jstage).max()))
        for n in ("scale", "zero"):
            np.testing.assert_allclose(
                ts.qplanes[tidx][n][:, packed].float().numpy(),
                _kernel_layout(js.qplanes[jidx][n])[:, packed].astype(np.float32),
                rtol=1e-3, atol=atol)
        # the port's pack of JAX's own staging pages: byte-equal to JAX's ref
        KV, n, P, D = jstage.shape
        pages = np.ascontiguousarray(jstage.transpose(1, 0, 2, 3)).reshape(-1, P, D)
        got = tpa_quant.quantize_kv_pages(torch.from_numpy(pages),
                                          bits=ts.quant.bits, axis=ts.qaxis[tidx])
        want = jquantize_pages_ref(jnp.asarray(pages), bits=ts.quant.bits,
                                   axis=ts.qaxis[tidx])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # the stores' codes: apart only where their fp inputs are apart
        scale = got[1].reshape((n, KV) + got[1].shape[1:]).transpose(0, 1).numpy()
        jcodes = _kernel_layout(js.stores[jidx])[:, packed].astype(np.int64)
        tcodes = ts.stores[tidx][:, packed].numpy().astype(np.int64)
        d = np.abs(tcodes - jcodes)
        delta = np.abs(tstage - jstage).max(axis=2 if ts.qaxis[tidx] == "channel" else 3,
                                            keepdims=True)
        assert np.all(d <= 4 * delta / scale + 1 + 1e-3), (d.max(), name)
        ndiff += int((d > 0).sum())
        total += d.size
    assert ndiff <= max_frac * total, (ndiff, total)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_greedy_streams_equal_jax(port_model, bits):
    cfg, _, _ = bcommon.small_model(ARCH)
    reqs = bcommon.make_requests(cfg, 6, np.random.default_rng(31))
    jeng, teng, jout, tout = _serve_both(port_model, bits, reqs)
    assert len(tout) == 6 and all(len(t) > 0 for t in tout.values())
    assert tout == jout
    assert teng.steps == jeng.steps and teng.paged_steps == teng.steps
    assert teng.host_copy_bytes == 0
    snap = teng.metrics_snapshot()
    assert snap["runner.paged.tail_upload_bytes"] > 0
    assert snap["runner.paged.mirror_upload_bytes"] > 0
    assert snap["store.pack_transfer_bytes"] > 0
    _stores_agree(jeng, teng)


def test_quant_prefill_chunks_crossing_page_fills(port_model):
    """Block size 4, prompt chunks of 12: each chunk fills several pages in
    one writeback, every token rides the P + C tail."""
    cfg, _, _ = bcommon.small_model(ARCH)
    r = np.random.default_rng(43)
    reqs = [bcommon.Request(request_id=f"r{i}",
                            prompt=list(map(int, r.integers(2, cfg.vocab_size, size=n))),
                            sampling=bcommon.SamplingParams(max_new_tokens=6))
            for i, n in enumerate((30, 17, 11))]
    jeng, teng, jout, tout = _serve_both(port_model, 8, reqs, block_size=4,
                                         chunk=12, max_batched_tokens=48,
                                         max_batch_slots=4)
    assert tout == jout
    assert teng.paged_steps == teng.steps and teng.host_copy_bytes == 0
    # 4-token groups have small ranges, so more codes sit near a boundary
    # that a 1e-6 difference of K crosses (0.19% measured)
    _stores_agree(jeng, teng, max_frac=0.005)


def test_quant_shared_prefix_copy_on_write(port_model):
    """A shared prefix published by the first request is reused by the
    others; their decode re-opens shared quantized blocks through CoW."""
    cfg, _, _ = bcommon.small_model(ARCH)
    reqs = bcommon.make_requests(cfg, 4, np.random.default_rng(3), shared_prefix=24)
    jeng, teng, jout, tout = _serve_both(port_model, 8, reqs,
                                         waves=[reqs[:1], reqs[1:]])
    assert tout == jout
    assert teng.prefix_cache.stats.hit_blocks > 0
    assert teng.prefix_cache.stats.hit_blocks == jeng.prefix_cache.stats.hit_blocks
    _stores_agree(jeng, teng)


def test_quant_preemption_recompute(port_model):
    """A 14-block pool with the prefix cache off: sequences are preempted and
    recomputed, and their pages pack again from recomputed staging."""
    cfg, _, _ = bcommon.small_model(ARCH)
    reqs = bcommon.make_requests(cfg, 6, np.random.default_rng(2))
    jeng, teng, jout, tout = _serve_both(port_model, 8, reqs, num_blocks=14,
                                         enable_prefix_cache=False)
    assert tout == jout
    preempts = teng.metrics_snapshot()["engine.preemptions"]
    assert preempts > 0
    assert preempts == jeng.metrics_snapshot()["engine.preemptions"]


# ---------------------------------------------------------------------------
# the model's quantized steps on identical pages and tails
# ---------------------------------------------------------------------------

NB, P, NP = 32, 8, 4


def _quant_pools(cfg, seed, C):
    """Per layer, per k/v: codes and f16 planes packed (by the port's plain
    pack) from random fp pages, plus a random tail of P + C slots."""
    from repro_torch.kernels.kv_quant import quantize_pages_ref
    rng = np.random.default_rng(seed)
    KV, D = cfg.num_kv_heads, cfg.head_dim
    pools = []
    for _ in range(cfg.num_layers):
        layer = {}
        for name, axis in (("k", "channel"), ("v", "token")):
            fp = rng.normal(size=(KV * NB, P, D)).astype(np.float32)
            codes, scale, zero = quantize_pages_ref(torch.from_numpy(fp), bits=8,
                                                    axis=axis)
            back = lambda t: t.reshape((KV, NB) + t.shape[1:]).numpy()  # noqa: E731
            layer[name] = {"codes": back(codes), "scale": back(scale.half()),
                           "zero": back(zero.half()),
                           "tail": rng.normal(size=(4, P + C, KV, D)).astype(np.float32)}
        pools.append(layer)
    return pools


def _run_quant_model(port_model, seed, lengths, C, chunk_lens=None):
    """decode_paged (C == 1, no chunk_lens) or ragged extend_paged on both
    models over the same quantized pools; returns (jax, port) logits and
    per-layer writes."""
    cfg, jm, values = bcommon.small_model(ARCH)
    tm, params = port_model
    pools = _quant_pools(cfg, seed, C)
    rng = np.random.default_rng(seed + 1)
    B = len(lengths)
    tables = rng.permutation(np.arange(1, NB))[: B * NP].reshape(B, NP).astype(np.int64)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    jpages = ({"r0": {f"l{i}": {n: {k: jnp.asarray(a[:B] if k == "tail" else a)
                                     for k, a in leaf.items()}
                                 for n, leaf in p.items()}
                      for i, p in enumerate(pools)}},)
    tpages = [{n: {k: torch.from_numpy(np.ascontiguousarray(a[:B] if k == "tail" else a))
                   for k, a in leaf.items()} for n, leaf in p.items()} for p in pools]
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    if chunk_lens is None:
        jl, _, jw = jm.decode_paged(values, j(tokens), jpages, j(tables), j(lengths))
        tl, _, tw = tm.decode_paged(params, t(tokens), tpages, t(tables), t(lengths))
    else:
        cl = np.asarray(chunk_lens, np.int32)
        jl, _, jw = jm.extend_paged(values, j(tokens), jpages, j(tables), j(lengths),
                                    j(cl), jnp.asarray(0, jnp.int32))
        tl, _, tw = tm.extend_paged(params, t(tokens), tpages, t(tables), t(lengths),
                                    t(cl), 0)
    jw = [jw[0]["r0"][f"l{i}"] for i in range(cfg.num_layers)]
    return np.asarray(jl), tl.numpy(), jw, tw


def test_quant_decode_paged_matches_jax(port_model):
    # a row with tail_start 0, a mid-page row, and a row at a page's last slot
    jl, tl, jw, tw = _run_quant_model(port_model, 51, [3, 13, NP * P - 1], 1)
    np.testing.assert_allclose(tl, jl, atol=ATOL)
    for jwl, twl in zip(jw, tw):
        for n in ("k", "v"):
            np.testing.assert_allclose(twl[n].numpy(), np.asarray(jwl[n]), atol=ATOL)


def test_quant_ragged_extend_paged_matches_jax(port_model):
    """Ragged chunks (one of them crossing a page boundary), a first chunk
    with tail_start 0; logits of real positions compared."""
    C = 8
    chunk_lens = [8, 3, 1, 6]
    jl, tl, jw, tw = _run_quant_model(port_model, 61, [0, 5, 16, 20], C, chunk_lens)
    real = np.arange(C)[None, :] < np.asarray(chunk_lens)[:, None]
    np.testing.assert_allclose(tl[real], jl[real], atol=ATOL)
    for jwl, twl in zip(jw, tw):
        for n in ("k", "v"):
            np.testing.assert_allclose(twl[n].numpy()[real], np.asarray(jwl[n])[real],
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# store bookkeeping, routing, the serve entry point
# ---------------------------------------------------------------------------

def _port_engine(port_model, **kw):
    model, params = port_model
    cfg = dict(block_size=8, num_blocks=64, max_model_len=128, device="cpu",
               kv_quant=QuantConfig(bits=8),
               scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=64,
                                         prefill_chunk=16))
    cfg.update(kw)
    return LLMEngine(model, params, EngineConfig(**cfg))


def _drive(eng, cfg, seed, n=3):
    for r in bcommon.make_requests(cfg, n, np.random.default_rng(seed)):
        eng.add_request(_port_request(r))
    eng.run()
    return eng


def test_quant_payload_round_trip_and_capacity(port_model):
    """block_payload -> restore_block round-trips a packed and a filling
    block; a packed payload ships no staging, and restoring it rebuilds the
    staging from the codes. At block size 32 the quantized store holds
    >= 1.8x the tokens of fp16 pages."""
    cfg, _, _ = bcommon.small_model(ARCH)
    eng = _drive(_port_engine(port_model, block_size=32), cfg, 41)
    st = eng.store
    ratio = st.kv_fp16_bytes_per_block() / st.kv_bytes_per_block()
    assert ratio >= 1.8, ratio
    packed = int(np.flatnonzero(st.block_quantized)[0])
    filling = int(np.flatnonzero(~st.block_quantized[1:])[0]) + 1
    for src, dst in ((packed, 60), (filling, 61)):
        payload = st.block_payload(src)
        assert payload[-1] is bool(st.block_quantized[src])
        assert all(len(e) == (3 if payload[-1] else 4) for e in payload[:-1])
        version = st.version
        st.restore_block(dst, payload)
        assert st.version > version and dst in st.dirty_blocks
        after = st.block_payload(dst)
        assert after[-1] == payload[-1]
        for a, b in zip(after[:-1], payload[:-1]):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    for idx in st.qplanes:
        codes, scale, zero = (st.stores[idx][:, 60], st.qplanes[idx]["scale"][:, 60],
                              st.qplanes[idx]["zero"][:, 60])
        want = (codes.float() * scale.float() + zero.float()).to(st.qdtype[idx])
        assert torch.equal(st.qstage[idx][:, 60], want)


def test_quant_configs_without_a_paged_layout_raise(port_model):
    """The twin of ``tests/test_executor.py::test_kv_quant_routing``: KIVI
    pages keep the paged runner; a GEAR residual or non-KIVI axes get no
    paged runner and serve on the gathered backend (their quantize-
    dequantize round trip); demanding the paged backend for them raises."""
    eng = _port_engine(port_model)
    assert eng.paged_runner is not None and eng.store.quantized
    for qc in (QuantConfig(bits=8, residual_rank=2),
               QuantConfig(bits=8, key_axis="token"),
               QuantConfig(bits=8, value_axis="channel")):
        eng = _port_engine(port_model, kv_quant=qc)
        assert eng.paged_runner is None and not eng.store.quantized
        assert eng.runner.name == "gathered"
    with pytest.raises(ValueError, match="no paged decode path"):
        _port_engine(port_model, execution_backend="paged",
                     kv_quant=QuantConfig(bits=8, residual_rank=2))


def test_serve_entry_point_quantized_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--kv-quant-bits", "8"])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke on cpu: 2 requests" in out
    assert "kv_quant=8bit (1.73x capacity vs fp16)" in out
    assert "host_copy=0.0MB" in out
