"""State-mixer stacks in the port vs the JAX package, on the CPU:
jamba-v0.1-52b (Mamba + MoE + GQA attention) and xlstm-1.3b (mLSTM +
sLSTM), served on the gathered backend with per-sequence state slots.

The configs equal the reference's field by field, and ``param_counts``
equals the reference roofline's, smoke and published (the Jamba block the
card serves: 13 295 050 752 parameters; all of xlstm-1.3b: 3 605 471 232).
At smoke width, with JAX's init converted: ``Model.extend`` from empty
states, then a continuation chunk and a one-token decode from the returned
ones, matches JAX's logits and every state leaf (``ATOL``, f32). Served
(6 requests over several prompt chunks), greedy streams EQUAL JAX's
engine's, with exact-chunk grouping on and prefix reuse off on both, and
``host_copy_bytes`` equal; Jamba with ``QuantConfig(bits=8)`` holds KIVI
attention pages beside its state slots (``store.quantized`` as in JAX)
with equal streams; a Jamba sequence migrated through
``DisaggregatedServer`` moves its pages and its slot with equal streams
and transfer bytes. Backend selection and the LoRA refusal follow JAX.

Two reference faults the port does not copy, each shown against JAX: a
state slot is never reset when handed out, so a recycled slot (after a
finish) or a re-allocated one (after a preemption) starts from its
previous owner's final state there; the port resets every slot it hands
out, so its streams equal a fresh engine's. And the reference's store
decides a leaf's kind by its shape: a leaf whose second axis equals
``max_model_len`` counts as pages, so at the xlstm smoke width (d_model
256) and ``max_model_len`` 256 the sLSTM's states are gathered as windows.
The parity traces therefore use ``max_model_len`` 128 (ROADMAP C).
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
from repro.core.disagg import DisaggregatedServer as JDisaggregatedServer  # noqa: E402
from repro.core.executor.state import PagedModelState as JPagedModelState  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig,  # noqa: E402
                              SchedulerConfig)
from repro_torch.core.disagg import DisaggregatedServer  # noqa: E402
from repro_torch.core.executor import make_runners  # noqa: E402
from repro_torch.core.lora import LoRAConfig  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.models.model import paged_decode_supported  # noqa: E402
from test_torch_gathered import _port_request  # noqa: E402

JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-1.3b"
ARCHS = [JAMBA, XLSTM]
ATOL = 1e-4  # f32 logits over 2 layers, XLA vs PyTorch summation order
# max_model_len 128, not the smoke width 256 (module docstring)
ENGINE = dict(block_size=8, num_blocks=512, max_model_len=128)
SCHED = dict(max_batch_slots=8, max_batched_tokens=64, prefill_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread: on a shared machine
    a contended thread pool makes each small op take milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg, jm, values = bcommon.small_model(arch)
        tm = build_model(tconfigs.smoke_config(arch), device="cpu")
        _MODELS[arch] = (jcfg, jm, values, tm, convert_params(tm.cfg, values))
    return _MODELS[arch]


def _jengine(arch, **kw):
    return bcommon.make_engine(arch, **dict(ENGINE, **kw))


def _tengine(arch, **kw):
    _, _, _, tm, params = _models(arch)
    return LLMEngine(tm, params, EngineConfig(**dict(
        ENGINE, device="cpu", scheduler=SchedulerConfig(**SCHED), **kw)))


def _streams(eng):
    return {rid: list(s.generated) for rid, s in eng.seqs.items()}


def _serve(eng, reqs, port):
    for r in reqs:
        eng.add_request(_port_request(r) if port else dataclasses.replace(r))
    eng.run()
    return _streams(eng)


def _record_slots(eng):
    """Every slot the engine's block manager hands out, in order."""
    got, alloc = [], eng.bm.allocate_state_slot

    def record():
        got.append(alloc())
        return got[-1]
    eng.bm.allocate_state_slot = record
    return got


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert dataclasses.asdict(getattr(tconfigs, get)(arch)) == want


@pytest.mark.parametrize("get", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch, get):
    assert troofline.param_counts(getattr(tconfigs, get)(arch)) == \
        jroofline.param_counts(getattr(jconfigs, get)(arch))


def test_published_param_counts():
    """One Jamba block (7 Mamba + 1 attention layer, 4 MoE feed-forwards),
    the depth the card serves, and the whole of xlstm-1.3b."""
    cfg = tconfigs.get_config(JAMBA)
    block = dataclasses.replace(cfg, stages=((cfg.stages[0][0], 1),))
    assert troofline.param_counts(block)["total"] == 13_295_050_752
    assert troofline.param_counts(tconfigs.get_config(XLSTM))["total"] == 3_605_471_232


# ---------------------------------------------------------------------------
# Model.extend
# ---------------------------------------------------------------------------

def _jcache_to_port(jc):
    return [{n: torch.tensor(np.asarray(a)[0]) for n, a in layer.items()}
            for layer in jc["stages"][0].values()]


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_matches_jax(arch):
    """Fresh rows (C = 8) from empty states, a continuation chunk (C = 8)
    and a one-token decode from the returned states: logits and every
    cache leaf (attention windows at the written slots, states whole)."""
    jcfg, jm, values, tm, params = _models(arch)
    B, W = 2, 32
    jext = jax.jit(jm.extend)
    jc = jm.init_cache(B, W)
    tc = _jcache_to_port(jc)
    assert [set(layer) for layer in tc] == [set(layer) for layer in tm.init_cache(B, W)]
    rng = np.random.default_rng(7)
    start = 0
    for C in (8, 8, 1):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, C)).astype(np.int32)
        cl = np.full(B, start, np.int32)
        jl, jc = jext(values, jnp.asarray(tok), jc, jnp.asarray(cl))
        tl, tc = tm.extend(params, torch.from_numpy(tok), tc, torch.from_numpy(cl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        start += C
        for layer, jlayer in zip(tc, _jcache_to_port(jc)):
            for n, want in jlayer.items():
                got = layer[n][:, :start] if n in ("k", "v") else layer[n]
                want = want[:, :start] if n in ("k", "v") else want
                np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                           err_msg=n)
    fresh = 2 if arch == JAMBA else 0  # the first call's rows, in the attention layer
    assert tm.route_rows["flash_prefill"] >= fresh


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

_SERVED = {}


def _served(arch):
    """One trace on both engines: 6 requests, prompts of 10-60 tokens over
    16-token chunks, every slot handed out once."""
    if arch not in _SERVED:
        reqs = bcommon.make_requests(_models(arch)[0], 6, np.random.default_rng(2))
        jeng, teng = _jengine(arch), _tengine(arch)
        jslots, tslots = _record_slots(jeng), _record_slots(teng)
        _SERVED[arch] = (jeng, teng, _serve(jeng, reqs, False), _serve(teng, reqs, True),
                         jslots, tslots)
    return _SERVED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_streams_equal_jax(arch):
    jeng, teng, jout, tout, jslots, tslots = _served(arch)
    assert len(tout) == 6 and all(len(t) > 0 for t in tout.values())
    assert tout == jout
    # no slot recycled in the trace: the reference's reuse fault stays out
    assert len(set(jslots)) == len(jslots) == 6 and sorted(tslots) == sorted(jslots)
    assert teng.paged_runner is None and jeng.paged_runner is None
    # exact chunks: one dispatch per chunk length, several a step
    n = "engine.dispatch.gathered"
    assert teng.steps == jeng.steps
    assert teng.metrics_snapshot()[n] == jeng.metrics_snapshot()[n] == teng.runner.steps \
        > teng.steps
    for eng in (jeng, teng):
        assert eng.scheduler.cfg.exact_chunks and eng.prefix_cache is None
    assert teng.bm.free_state_slots == 32  # every slot back


@pytest.mark.parametrize("arch", ARCHS)
def test_host_copy_bytes_equal_jax(arch):
    jeng, teng = _served(arch)[:2]
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    st = teng.store
    per_slot = {JAMBA: 3 * 512 * 4 + 512 * 16 * 4,  # conv (3, 512) + ssm (512, 16)
                XLSTM: (3 * 512 + 4 * 128 * 128 + 4 * 128 + 4 + 3 * 256 + 4) * 4}[arch]
    assert st.state_bytes_per_slot() == per_slot
    assert len(st.state_leaves) == {JAMBA: 2, XLSTM: 8}[arch]


def test_reference_reads_slstm_state_as_pages_at_max_model_len_256():
    """The reference's store tells pages from states by shape: at the xlstm
    smoke width (d_model 256) a max_model_len of 256 makes the sLSTM's c, n
    and h leaves "paged"; at 128 every leaf is a state, as in the port."""
    jm = _models(XLSTM)[1]
    kinds = {W: JPagedModelState(jm, JEngineConfig(block_size=8, num_blocks=16,
                                                   max_model_len=W)).kinds
             for W in (128, 256)}
    assert kinds[128] == ["state"] * 8
    assert kinds[256].count("paged") == 3
    assert len(_tengine(XLSTM, max_model_len=256).store.state_leaves) == 8


def test_fresh_slot_holds_the_init_state():
    """A slot handed out holds the empty history: zeros, and the xLSTM
    stabilizers at -1e30 (``init_mlstm_cache`` / ``init_slstm_cache``).
    The reference's slab starts at zeros, ``m`` included, and is never
    reset; the parity traces' streams agree all the same
    (``test_streams_equal_jax``)."""
    jeng, teng = _jengine(XLSTM), _tengine(XLSTM)
    m = [i for i, (_, name) in enumerate(teng.store.state_leaves) if name == "m"]
    assert len(m) == 2
    jm = [i for i, s in enumerate(jeng.store.stores) if s.shape[2:] == (4,)]
    assert len(jm) == 2 and all((jeng.store.stores[i] == 0).all() for i in jm)
    teng.store.state_stores[m[0]][5] = 7.0  # a previous owner's leftovers
    teng.store.reset_state(5)
    for i, store in enumerate(teng.store.state_stores):
        want = -1e30 if i in m else 0.0
        assert (store[5] == want).all()


def test_jamba_kivi_streams_equal_jax():
    """8-bit KIVI attention pages beside the Mamba layer's state slots: the
    store is quantized on both sides (JAX's leaf kinds: 2 state, 2 paged)."""
    reqs = bcommon.make_requests(_models(JAMBA)[0], 4, np.random.default_rng(5))
    jeng = _jengine(JAMBA, kv_quant=JQuantConfig(bits=8))
    teng = _tengine(JAMBA, kv_quant=QuantConfig(bits=8))
    assert jeng.store.quantized and teng.store.quantized
    assert jeng.store.kinds == ["state", "state", "paged", "paged"]
    assert len(teng.store.state_leaves) == 2 and len(teng.store.attn_kv_leaves()) == 2
    assert _serve(teng, reqs, True) == _serve(jeng, reqs, False)
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes
    assert teng.paged_runner is None


def test_jamba_disagg_equals_jax():
    """Prefill on one engine, decode on another: pages and the state slot
    migrate; streams and transfer bytes equal JAX's, and the streams equal
    the port's colocated engine's."""
    jcfg, jm, values, tm, params = _models(JAMBA)
    reqs = bcommon.make_requests(jcfg, 4, np.random.default_rng(11))
    jkw = dict(ENGINE, num_state_slots=32, scheduler=JSchedulerConfig(**SCHED))
    tkw = dict(ENGINE, device="cpu", scheduler=SchedulerConfig(**SCHED))
    jsrv = JDisaggregatedServer(jm, values, prefill_cfg=JEngineConfig(**jkw),
                                decode_cfg=JEngineConfig(**jkw))
    tsrv = DisaggregatedServer(tm, params, prefill_cfg=EngineConfig(**tkw),
                               decode_cfg=EngineConfig(**tkw))
    tout = _serve(tsrv, reqs, True)
    assert tout == _serve(jsrv, reqs, False)
    assert tsrv.stats.migrated == jsrv.stats.migrated == 4
    assert tsrv.stats.transfer_bytes == jsrv.stats.transfer_bytes > 0
    assert tout == _serve(_tengine(JAMBA), reqs, True)
    dec = tsrv.decode_engine
    assert dec.bm.free_state_slots == 32 and not tsrv.prefill_engine.seqs


def test_xlstm_export_import_round_trip_keeps_streams():
    """An xLSTM sequence (no pages, only its slot) leaves engine A mid-decode
    for engine B: the import restores the slot's bytes, and every stream
    equals an unmigrated engine's."""
    reqs = bcommon.make_requests(_models(XLSTM)[0], 3, np.random.default_rng(8))
    ref, a, b = _tengine(XLSTM), _tengine(XLSTM), _tengine(XLSTM)
    want = _serve(ref, reqs, True)
    for r in reqs:
        a.add_request(_port_request(r))
    while len(a.seqs["r0"].generated) < 3:
        a.step()
    payload = a.export_seq("r0")
    assert len(payload["state"]) == 8 and a.bm.free_state_slots == 32 - 2
    b.import_seq(payload)
    assert b.last_import_bytes == a.store.state_bytes_per_slot()
    a.run()
    b.run()
    assert dict(_streams(a), **_streams(b)) == want
    with pytest.raises(ValueError, match="has no state slot but this engine's model"):
        b.import_seq(dict(payload, state=None))


@pytest.mark.parametrize("arch", [JAMBA, XLSTM, "starcoder2-3b", "deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
def test_backend_fallbacks(arch):
    """The twin of ``tests/test_executor.py::test_backend_fallbacks`` (the
    port builds no whisper-base): no paged family, no paged runner, and
    ``execution_backend="paged"`` refused."""
    cfg = tconfigs.smoke_config(arch)
    assert not paged_decode_supported(cfg)
    tm = build_model(cfg, device="cpu")
    assert tm.decode_paged is None
    if arch in (JAMBA, XLSTM):
        teng = _tengine(arch)
        assert make_runners(tm, teng.params, teng.cfg, teng.store)[1] is None
        with pytest.raises(ValueError, match="no paged decode path"):
            _tengine(arch, execution_backend="paged")


def test_lora_refused_as_jax_refuses():
    with pytest.raises(ValueError, match="pure global-attention stack"):
        _jengine(JAMBA, lora=JLoRAConfig(rank=4))
    with pytest.raises(ValueError, match="pure global-attention stack"):
        _tengine(JAMBA, lora=LoRAConfig(rank=4))


# ---------------------------------------------------------------------------
# the reference's dirty slots
# ---------------------------------------------------------------------------

def test_recycled_slot_starts_empty():
    """r0 finishes, then r1 runs in the same engine (4 slots: r1 gets r0's
    freed slot back). The port's r1 equals a fresh engine's; the
    reference's starts from r0's final state and diverges."""
    reqs = bcommon.make_requests(_models(JAMBA)[0], 2, np.random.default_rng(3),
                                 gen_lo=6, gen_hi=7)
    out = {}
    for side, mk, port in (("jax", _jengine, False), ("port", _tengine, True)):
        fresh = mk(JAMBA, num_state_slots=4)
        after = mk(JAMBA, num_state_slots=4)
        slots = _record_slots(after)
        _serve(after, reqs[:1], port)
        out[side] = (_serve(fresh, reqs[1:], port)["r1"],
                     _serve(after, reqs[1:], port)["r1"])
        assert slots[0] == slots[1]  # the same slot, handed out twice
    assert out["port"][0] == out["port"][1] == out["jax"][0]
    assert out["jax"][1] != out["jax"][0]
    # the numbers this trace gives (jamba smoke, JAX's init at key 0)
    assert out["jax"] == ([273, 11, 159, 28, 194, 283], [273, 11, 13, 137, 33, 330])


def test_preempted_slot_restarts_empty():
    """4 requests into 14 blocks preempt 8 times on both engines. A
    preempted sequence recomputes from scratch: the port's streams equal a
    roomy engine's; the reference's resume on their own dirty slots and
    two of four diverge."""
    reqs = bcommon.make_requests(_models(JAMBA)[0], 4, np.random.default_rng(3),
                                 gen_lo=6, gen_hi=7)
    out = {}
    for side, mk, port in (("jax", _jengine, False), ("port", _tengine, True)):
        tight = mk(JAMBA, num_blocks=14, num_state_slots=4)
        out[side] = (_serve(mk(JAMBA, num_state_slots=4), reqs, port),
                     _serve(tight, reqs, port),
                     tight.metrics_snapshot()["engine.preemptions"])
    assert out["port"][2] == out["jax"][2] == 8
    assert out["port"][0] == out["port"][1] == out["jax"][0]
    assert sorted(r for r in out["jax"][0] if out["jax"][1][r] != out["jax"][0][r]) == \
        ["r1", "r3"]


def test_serve_entry_point_on_cpu(capsys):
    from repro_torch.launch import serve

    for arch, rows in ((JAMBA, "rows flash_prefill=2"), (XLSTM, "flash_prefill=0 "
                                                               "flash_attention=0")):
        serve.main(["--device", "cpu", "--arch", arch, "--requests", "2"])
        out = capsys.readouterr().out
        assert f"{arch}-smoke on cpu: 2 requests" in out and "(0 paged)" in out
        assert rows in out
