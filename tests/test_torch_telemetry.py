"""The port's telemetry vs the JAX package's, on the CPU: the engine cases of
``tests/test_telemetry.py``.

``EngineConfig.telemetry`` builds the step tracer. Tracing must never
change what the engine computes: greedy streams and the step and dispatch
counters are equal with tracing on and off, and equal to JAX's engine, on
the gathered, paged and speculative backends. The port's trace covers every
(track, name) pair JAX's records on the same run (the port's extra spans
are listed in ``PORT_ONLY``), exports as Chrome trace-event JSON that
``tools/trace_summary.py`` digests, and annotates every paged decode
dispatch with the SXM H100 bound of ``launch/roofline.py``.
"""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
import tools.trace_summary as trace_summary  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import LLMEngine as JLLMEngine  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core import SpeculativeConfig as JSpeculativeConfig  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.core.telemetry import TelemetryConfig as JTelemetryConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig, SpeculativeConfig,
                              TelemetryConfig, chrome_trace, write_chrome_trace)
from repro_torch.core.telemetry import NULL_TRACER  # noqa: E402
from repro_torch.launch.roofline import H100_SXM, card_for, decode_step_bound  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ARCH = "olmo-1b"
BACKENDS = ["gathered", "paged", "speculative"]
# spans the port records and JAX's engine does not: the gathered runner's
# window copies, and the paged runner's O(tokens) K/V writeback to the host
# store (the reference writes its device-resident pages in place)
PORT_ONLY = {("executor", "gather"), ("executor", "window_upload"),
             ("executor", "scatter"), ("executor", "writeback")}


@pytest.fixture(scope="module")
def olmo():
    jcfg, jm, values = bcommon.small_model(ARCH)
    tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    return jcfg, jm, values, tm, convert_params(tm.cfg, values)


def _cfg(jax_side, backend, telemetry):
    """``tests/test_telemetry.py::_engine_cfg``."""
    sched = (JSchedulerConfig if jax_side else SchedulerConfig)(
        max_batch_slots=4, max_batched_tokens=48, prefill_chunk=16)
    kw = dict(block_size=8, num_blocks=128, max_model_len=128, scheduler=sched,
              execution_backend=backend)
    if backend == "speculative":
        kw["speculative"] = (JSpeculativeConfig if jax_side
                             else SpeculativeConfig)(num_draft_tokens=3)
    if telemetry:
        kw["telemetry"] = (JTelemetryConfig if jax_side else TelemetryConfig)()
    if jax_side:
        return JEngineConfig(num_state_slots=16, **kw)
    return EngineConfig(device="cpu", **kw)


def _prompts(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, cfg.vocab_size, size=int(rng.integers(10, 30)))))
            for _ in range(n)]


def _run(olmo, jax_side, backend, telemetry, prompts):
    _, jm, values, tm, params = olmo
    if jax_side:
        eng = JLLMEngine(jm, values, _cfg(True, backend, telemetry))
        req_cls, sp_cls = JRequest, JSamplingParams
    else:
        eng = LLMEngine(tm, params, _cfg(False, backend, telemetry))
        req_cls, sp_cls = Request, SamplingParams
    for i, p in enumerate(prompts):
        eng.add_request(req_cls(request_id=f"r{i}", prompt=p,
                                sampling=sp_cls(max_new_tokens=8)))
    eng.run()
    return eng, {rid: list(s.generated) for rid, s in eng.seqs.items()}


@pytest.fixture(scope="module")
def runs(olmo):
    """backend -> (JAX traced, port untraced, port traced), each (engine,
    streams), over the same four prompts."""
    prompts = _prompts(olmo[0])
    return {b: (_run(olmo, True, b, True, prompts), _run(olmo, False, b, False, prompts),
                _run(olmo, False, b, True, prompts)) for b in BACKENDS}


def _counters(eng):
    snap = eng.metrics_snapshot()
    return {k: v for k, v in snap.items()
            if k == "engine.steps" or k.startswith("engine.dispatch.")}


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracing_preserves_greedy_outputs(runs, backend):
    (jeng, jout), (off, off_out), (on, on_out) = runs[backend]
    assert on_out == off_out == jout
    assert off.trace is NULL_TRACER and not off.trace.events
    assert on.trace.enabled and len(on.trace.events) > 0
    names = {ev.name for ev in on.trace.events}
    assert {"schedule", "marshal", "dispatch", "postprocess", "step"} <= names
    if backend == "speculative":
        assert "spec_propose" in names and "spec_verify" in names
    assert _counters(on) == _counters(off) == _counters(jeng)
    assert _counters(on)[f"engine.dispatch.{backend}"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_trace_covers_jax_track_names(runs, backend):
    (jeng, _), _, (on, _) = runs[backend]
    jpairs = {(ev.track, ev.name) for ev in jeng.trace.events}
    tpairs = {(ev.track, ev.name) for ev in on.trace.events}
    assert jpairs <= tpairs, jpairs - tpairs
    assert tpairs - jpairs <= PORT_ONLY, tpairs - jpairs
    # per-row chunk spans under every dispatch, as JAX's
    rows = sorted(p for p in tpairs if p[0].startswith("batch.row"))
    assert rows == sorted(p for p in jpairs if p[0].startswith("batch.row")) and rows


def test_chrome_trace_schema(runs, tmp_path):
    _, _, (eng, _) = runs["paged"]
    doc = chrome_trace(eng.trace.events, metadata={"test": "schema"})
    doc = json.loads(json.dumps(doc))  # everything must serialize
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms" and doc["otherData"] == {"test": "schema"}
    named_tids = set()
    for ev in doc["traceEvents"]:
        assert ev["pid"] == 1 and isinstance(ev["tid"], int)
        if ev["ph"] == "M":
            assert ev["name"] == "thread_name"
            named_tids.add(ev["tid"])
            continue
        assert ev["ph"] in ("X", "i")
        assert ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        else:
            assert ev["s"] == "t"
    used_tids = {ev["tid"] for ev in doc["traceEvents"] if ev["ph"] != "M"}
    assert used_tids <= named_tids  # every track carries a thread_name
    path = write_chrome_trace(str(tmp_path / "t.json"), eng.trace)
    with open(path) as f:
        assert json.load(f)["traceEvents"] == doc["traceEvents"]
    assert trace_summary.main([path]) == 0
    fr = trace_summary.roofline_fractions(trace_summary.load_events(path)[0])
    assert fr and all(live > 0 and bound > 0 for live, bound in fr)


@pytest.mark.parametrize("backend", ["paged", "speculative"])
def test_decode_dispatches_carry_roofline_bound(runs, backend):
    """Every paged decode dispatch carries the SXM H100 bound of its batch
    at the power-of-two bucket of its longest row; speculative dispatches
    carry none (they emit up to k + 1 tokens a row), as in JAX's engine."""
    _, _, (eng, _) = runs[backend]
    decode = [ev for ev in eng.trace.events
              if ev.name == "dispatch" and ev.args["phase"] == "decode"]
    paged = [ev for ev in decode if ev.args["backend"] == "paged"]
    assert decode and (paged or backend == "speculative")
    card = card_for(H100_SXM)
    for ev in paged:
        assert ev.args["bound_tokens_per_s"] > 0
        assert any(ev.args["bound_tokens_per_s"] == decode_step_bound(
            eng.model.cfg, batch=ev.args["batch"], seq_len=s, card=card)["tokens_per_s"]
            for s in (16, 32, 64, 128))
    for ev in decode:
        if ev.args["backend"] == "speculative":
            assert "bound_tokens_per_s" not in ev.args and ev.args["k"] == 3
    assert all(key[1] in (16, 32, 64, 128) for key in eng._bound_cache)


def test_engine_without_telemetry_uses_null_tracer(olmo):
    tm, params = olmo[3], olmo[4]
    eng = LLMEngine(tm, params, _cfg(False, "paged", False))
    assert eng.trace is NULL_TRACER
    assert all(r.trace is NULL_TRACER for r in (eng.runner, eng.paged_runner))
    assert not hasattr(eng, "set_tracer")
    eng2 = LLMEngine(tm, params, EngineConfig(
        device="cpu", block_size=8, num_blocks=64, max_model_len=128,
        telemetry=TelemetryConfig(trace=False)))
    assert eng2.trace is NULL_TRACER
    eng3 = LLMEngine(tm, params, _cfg(False, "speculative", True))
    assert eng3.trace.enabled and eng3.trace.capacity == 65536
    assert all(part.trace is eng3.trace
               for part in (eng3.runner, eng3.paged_runner, eng3.spec_runner))


def test_roofline_off_leaves_no_bound(olmo):
    tm, params = olmo[3], olmo[4]
    eng = LLMEngine(tm, params, EngineConfig(
        device="cpu", block_size=8, num_blocks=64, max_model_len=128,
        telemetry=TelemetryConfig(roofline=False, chunk_spans=False)))
    eng.add_request(Request(request_id="r0", prompt=list(range(2, 14)),
                            sampling=SamplingParams(max_new_tokens=4)))
    eng.run()
    names = {(ev.track, ev.name) for ev in eng.trace.events}
    assert ("executor", "dispatch") in names
    assert not any(t.startswith("batch.row") for t, _ in names)
    assert not any("bound_tokens_per_s" in (ev.args or {}) for ev in eng.trace.events)


def test_telemetry_config_validates():
    with pytest.raises(ValueError, match="trace_capacity"):
        TelemetryConfig(trace_capacity=0)
    assert TelemetryConfig() == TelemetryConfig(trace=True, trace_capacity=65536,
                                                roofline=True, chunk_spans=True)
    import dataclasses

    assert [f.name for f in dataclasses.fields(TelemetryConfig)] == \
        [f.name for f in dataclasses.fields(JTelemetryConfig)]


def test_serve_trace_out_summarizes(tmp_path, capsys):
    from repro_torch.launch import serve

    path = str(tmp_path / "t.json")
    serve.main(["--device", "cpu", "--requests", "2", "--trace-out", path])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke on cpu: 2 requests" in out and f"-> {path}" in out
    with open(path) as f:
        doc = json.load(f)
    assert doc["otherData"] == {"arch": "olmo-1b", "backend": "auto", "device": "cpu"}
    assert trace_summary.main([path]) == 0
    assert "decode roofline: " in (o := capsys.readouterr().out) and "annotated steps" in o
