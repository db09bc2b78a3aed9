"""Exact-chunk scheduling in the port's engine vs the JAX package's, on the CPU.

With ``SchedulerConfig(exact_chunks=True)`` both engines cut a prompt into
power-of-two chunks and run one dispatch per chunk length each step. On a
ragged trace (prompts of 10-60 tokens, ``prefill_chunk`` 16) the port's
greedy streams equal the reference's, and so do the ``engine.dispatch.*``
counters after every step: olmo-1b on the paged backend, starcoder2-3b on
the gathered one (its only backend).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

SCHED = dict(max_batch_slots=8, max_batched_tokens=64, prefill_chunk=16,
             exact_chunks=True)
DISPATCH = ("engine.dispatch.gathered", "engine.dispatch.paged")


def _port_request(r):
    sp = r.sampling
    return Request(request_id=r.request_id, prompt=list(r.prompt), user_id=r.user_id,
                   sampling=SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                                           max_new_tokens=sp.max_new_tokens,
                                           stop_token=sp.stop_token))


def _dispatches(engine):
    snap = engine.metrics_snapshot()
    return tuple(snap[k] for k in DISPATCH)


@pytest.mark.parametrize("arch,backend", [("olmo-1b", "paged"),
                                          ("starcoder2-3b", "gathered")])
def test_exact_chunks_match_jax(arch, backend):
    jcfg, _, values = bcommon.small_model(arch)
    jeng = bcommon.make_engine(arch, execution_backend=backend,
                               scheduler=JSchedulerConfig(**SCHED))
    model = build_model(tconfigs.smoke_config(arch), device="cpu")
    teng = LLMEngine(model, convert_params(model.cfg, values), EngineConfig(
        block_size=8, num_blocks=512, max_model_len=256, device="cpu",
        execution_backend=backend, scheduler=SchedulerConfig(**SCHED)))
    assert teng.scheduler.cfg.exact_chunks and jeng.exact_chunks
    reqs = bcommon.make_requests(jcfg, 6, np.random.default_rng(21))
    assert len({len(r.prompt) for r in reqs}) > 1
    for r in reqs:
        jeng.add_request(dataclasses.replace(r))
        teng.add_request(_port_request(r))

    per_step = []
    while jeng.scheduler.has_work() or teng.scheduler.has_work():
        jt, tt = jeng.step(), teng.step()
        assert tt == jt
        per_step.append(_dispatches(teng))
        assert per_step[-1] == _dispatches(jeng), f"step {len(per_step)}"
    jout = {rid: s.generated for rid, s in jeng.seqs.items()}
    tout = {rid: s.generated for rid, s in teng.seqs.items()}
    assert len(tout) == 6 and all(tout.values()) and tout == jout
    assert teng.steps == jeng.steps == len(per_step)
    # grouping by length: some step made more than one dispatch
    counts = [sum(d) for d in per_step]
    assert any(b - a > 1 for a, b in zip([0] + counts, counts)), counts
    backend_counter = DISPATCH.index(f"engine.dispatch.{backend}")
    assert per_step[-1][backend_counter] == counts[-1] > teng.steps
