"""PyTorch port's serving engine vs ``repro.core.LLMEngine``, token for token.

Both engines serve the olmo-1b smoke model with the same weights (the JAX
init, converted) and the ``benchmarks/common.py::make_engine`` defaults, on
the CPU. Greedy sampling: the two frameworks' random generators differ, so
only greedy streams are comparable — and they must be EQUAL. Traces: a
plain ``make_requests`` trace, a shared-prefix trace (prefix-cache hits)
and a small pool that forces preemption (recompute recovery).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import EngineConfig, LLMEngine, Request, SamplingParams  # noqa: E402
from repro_torch.core import SchedulerConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ARCH = "olmo-1b"


def _torch_engine(**kw):
    _, _, values = bcommon.small_model(ARCH)
    model = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    params = convert_params(model.cfg, values)
    # the make_engine defaults
    cfg = dict(block_size=8, num_blocks=512, max_model_len=256, device="cpu",
               scheduler=SchedulerConfig(max_batch_slots=8,
                                         max_batched_tokens=64,
                                         prefill_chunk=16))
    cfg.update(kw)
    return LLMEngine(model, params, EngineConfig(**cfg))


def _port_request(r):
    sp = r.sampling
    return Request(request_id=r.request_id, prompt=list(r.prompt),
                   user_id=r.user_id,
                   sampling=SamplingParams(temperature=sp.temperature,
                                           top_k=sp.top_k,
                                           max_new_tokens=sp.max_new_tokens,
                                           stop_token=sp.stop_token))


def _serve_both(seed, n=6, num_blocks=512, first_alone=False, **req_kw):
    """Serve one trace on both engines. ``first_alone``: the first request
    runs to completion before the others arrive (so they can hit its
    published prefix blocks)."""
    cfg, _, _ = bcommon.small_model(ARCH)
    reqs = bcommon.make_requests(cfg, n, np.random.default_rng(seed), **req_kw)
    jeng = bcommon.make_engine(ARCH, num_blocks=num_blocks)
    teng = _torch_engine(num_blocks=num_blocks)
    waves = [reqs[:1], reqs[1:]] if first_alone else [reqs]
    for wave in waves:
        for r in wave:
            teng.add_request(_port_request(r))
            jeng.add_request(dataclasses.replace(r))
        jeng.run()
        teng.run()
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    return jeng, teng, jout, tout


@pytest.fixture(scope="module")
def plain_trace():
    return _serve_both(0)


def test_greedy_streams_equal_jax(plain_trace):
    jeng, teng, jout, tout = plain_trace
    assert len(tout) == 6 and all(len(t) > 0 for t in tout.values())
    assert tout == jout
    assert teng.steps == jeng.steps and teng.paged_steps == teng.steps


def test_paged_path_never_stages_windows(plain_trace):
    _, teng, _, _ = plain_trace
    assert teng.host_copy_bytes == 0
    snap = teng.metrics_snapshot()
    assert snap["engine.host_copy_bytes"] == 0
    assert snap["runner.paged.writeback_bytes"] > 0
    assert snap["engine.dispatch.paged"] == teng.steps


def test_shared_prefix_hits_prefix_cache():
    jeng, teng, jout, tout = _serve_both(1, first_alone=True, shared_prefix=32)
    assert tout == jout
    assert teng.prefix_cache.stats.hit_blocks > 0
    assert teng.prefix_cache.stats.hit_blocks == jeng.prefix_cache.stats.hit_blocks


def test_preemption_recompute_matches_jax():
    jeng, teng, jout, tout = _serve_both(2, num_blocks=24)
    assert tout == jout
    preempts = teng.metrics_snapshot()["engine.preemptions"]
    assert preempts > 0
    assert preempts == jeng.metrics_snapshot()["engine.preemptions"]


def test_unported_backends_raise():
    for backend in ("gathered", "speculative"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _torch_engine(execution_backend=backend)


def test_serve_entry_point_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2"])
    out = capsys.readouterr().out
    assert "olmo-1b-smoke on cpu: 2 requests" in out
    assert "host_copy=0.0MB" in out
