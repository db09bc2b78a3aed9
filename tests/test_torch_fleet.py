"""The port's ``ServingFleet`` (Llumnix-style instances with live migration)
vs JAX's ``repro.core.fleet.ServingFleet``, on the CPU.

The twins of ``tests/test_fleet.py`` (outputs match the naive loop, a
rebalance mid-decode keeps every token, rebalancing shrinks the load gap)
and of ``tests/test_lora.py::test_fleet_migration_keeps_adapter_binding``.
Both fleets serve the olmo-1b smoke model (JAX's init, converted) over the
same trace and are driven the same way; each test holds the instance every
request was routed to and finished on, the migrations and the migrated
bytes EQUAL to JAX's fleet, and the greedy streams equal to JAX's.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core.fleet import ServingFleet as JServingFleet  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.core.fleet import ServingFleet  # noqa: E402
from repro_torch.core.lora import LoRAConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

from tests.test_engine import naive_generate  # noqa: E402

ARCH = "olmo-1b"
LORA = dict(rank=4, alpha=8.0, max_loaded_adapters=4)


@pytest.fixture(scope="module")
def olmo():
    jcfg, jm, values = bcommon.small_model(ARCH)
    tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    adapters = {f"a{j}": jmake_adapter(jcfg, JLoRAConfig(**LORA), seed=j + 1)
                for j in range(2)}
    return jcfg, jm, values, tm, convert_params(tm.cfg, values), adapters


def _cfg(jax_side, lora=False, **kw):
    """``tests/test_fleet.py::_cfg`` (with LoRA: ``tests/test_lora.py::_cfg``
    at 64 blocks)."""
    sched = (JSchedulerConfig if jax_side else SchedulerConfig)(
        max_batch_slots=4, max_batched_tokens=48, prefill_chunk=16)
    base = dict(block_size=8, num_blocks=64, max_model_len=128,
                enable_prefix_cache=False, scheduler=sched,
                lora=(JLoRAConfig if jax_side else LoRAConfig)(**LORA) if lora else None)
    base.update(kw)
    if jax_side:
        return JEngineConfig(num_state_slots=16, **base)
    return EngineConfig(device="cpu", **base)


def _fleets(olmo, *, lora=False, **fleet_kw):
    jcfg, jm, values, tm, params, adapters = olmo
    jf = JServingFleet(jm, values, instances=2, engine_cfg=_cfg(True, lora), **fleet_kw)
    tf = ServingFleet(tm, params, instances=2, engine_cfg=_cfg(False, lora), **fleet_kw)
    if lora:
        for aid, w in adapters.items():
            jf.register_adapter(aid, w)
            tf.register_adapter(aid, w)
    return jf, tf


def _add(fleets, prompts, max_new, aids=None, skew=False):
    """Add the trace to both fleets (``skew``: every request to instance 0,
    else through ``route``); returns each fleet's routing, request ->
    instance index."""
    routes = []
    for f in fleets:
        jax_side = isinstance(f, JServingFleet)
        req_cls, sp_cls = (JRequest, JSamplingParams) if jax_side else (Request, SamplingParams)
        route = {}
        for i, p in enumerate(prompts):
            req = req_cls(request_id=f"r{i}", prompt=list(p),
                          adapter_id=aids[i] if aids else None,
                          sampling=sp_cls(max_new_tokens=max_new))
            eng = f.engines[0] if skew else f.route(req)
            eng.add_request(req)
            route[req.request_id] = f.engines.index(eng)
        routes.append(route)
    return routes


def _placement(f):
    return {rid: i for i, e in enumerate(f.engines) for rid in e.seqs}


def _hold_equal(jf, tf, routes):
    jout = {rid: list(s.generated) for rid, s in jf.seqs.items()}
    tout = {rid: list(s.generated) for rid, s in tf.seqs.items()}
    assert routes[0] == routes[1]
    assert tout == jout
    assert _placement(tf) == _placement(jf)
    assert tf.stats.migrations == jf.stats.migrations
    assert tf.stats.migrated_bytes == jf.stats.migrated_bytes
    return tout


def _prompts(cfg, rng, n, lo=10, hi=40):
    return [list(map(int, rng.integers(2, cfg.vocab_size, size=int(rng.integers(lo, hi)))))
            for _ in range(n)]


def test_fleet_outputs_match_naive_and_jax(olmo):
    jcfg, jm, values = olmo[:3]
    jf, tf = _fleets(olmo)
    prompts = _prompts(jcfg, np.random.default_rng(0), 6)
    routes = _add((jf, tf), prompts, 6)
    assert len(tf.run()) == 6 and len(jf.run()) == 6
    tout = _hold_equal(jf, tf, routes)
    for i, p in enumerate(prompts):
        assert tout[f"r{i}"] == naive_generate(jm, values, p, 6)


def test_fleet_migration_preserves_tokens_like_jax(olmo):
    """Load one instance heavily, then rebalance mid-decode: migrated
    sequences finish with the same greedy tokens as JAX's fleet."""
    jcfg = olmo[0]
    jf, tf = _fleets(olmo, rebalance_threshold=0.05)
    prompts = _prompts(jcfg, np.random.default_rng(1), 5, 24, 25)
    routes = _add((jf, tf), prompts, 10, skew=True)
    jf.run()
    tf.run()
    _hold_equal(jf, tf, routes)
    assert tf.stats.migrations >= 1 and tf.stats.migrated_bytes > 0
    assert set(_placement(tf).values()) == {0, 1}


def test_fleet_reduces_load_gap_like_jax(olmo):
    jcfg = olmo[0]
    jf, tf = _fleets(olmo, rebalance_threshold=0.05)
    prompts = _prompts(jcfg, np.random.default_rng(2), 4, 30, 31)
    routes = _add((jf, tf), prompts, 16, skew=True)
    for _ in range(8):
        jf.step()
        tf.step()
    assert tf.has_work() and jf.has_work()
    assert tf.load_gap() == jf.load_gap() < 0.5
    _hold_equal(jf, tf, routes)
    assert tf.stats.migrations >= 1


def test_fleet_migration_keeps_adapter_binding_like_jax(olmo):
    """Live migration of adapter-bound sequences: the destination faults the
    adapter in, and every stream equals JAX's fleet's and a single LoRA
    engine's that never migrates."""
    jcfg, _, _, tm, params, adapters = olmo
    r = np.random.default_rng(23)
    prompts = [list(map(int, r.integers(2, jcfg.vocab_size, size=24))) for _ in range(5)]
    aids = ["a0", "a1", "a0", "a1", "a0"]
    jf, tf = _fleets(olmo, lora=True, rebalance_threshold=0.05)
    routes = _add((jf, tf), prompts, 10, aids=aids, skew=True)
    jf.run()
    tf.run()
    tout = _hold_equal(jf, tf, routes)
    assert tf.stats.migrations >= 1
    dst = tf.engines[1]
    moved = [s for s in dst.seqs.values() if s.request.adapter_id]
    assert moved, "no adapter-bound sequence migrated"
    assert any(dst.adapters.is_loaded(s.request.adapter_id) for s in moved)
    assert dst.adapters.stats.misses >= 1
    assert dst.adapters.stats.misses == jf.engines[1].adapters.stats.misses
    ref = LLMEngine(tm, params, _cfg(False, lora=True))
    for aid, w in adapters.items():
        ref.register_adapter(aid, w)
    for i, (p, a) in enumerate(zip(prompts, aids)):
        ref.add_request(Request(request_id=f"r{i}", prompt=p, adapter_id=a,
                                sampling=SamplingParams(max_new_tokens=10)))
    ref.run()
    assert tout == {rid: list(s.generated) for rid, s in ref.seqs.items()}
