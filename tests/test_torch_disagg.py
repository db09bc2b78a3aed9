"""The port's KV migration and disaggregated prefill/decode server vs the JAX
package, on the CPU.

``DisaggregatedServer`` runs a prefill engine and a decode engine over one
model; a sequence whose prefill is done (first token emitted) moves its
pages from the first engine's store to the second's through
``LLMEngine.export_seq`` / ``import_seq``. The same trace (the olmo-1b
smoke model, JAX's init converted, ``benchmarks/common.py::make_requests``)
goes through JAX's ``repro.core.disagg.DisaggregatedServer`` and the port's,
over fp pages, KIVI pages at 8 and 4 bits, and with LoRA adapters
(registered on both engines; made once by JAX's ``make_adapter``). Greedy
streams, migrations and transfer bytes must be EQUAL to JAX's, and the
streams equal to the port's colocated engine's on the same trace.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core.disagg import DisaggregatedServer as JDisaggregatedServer  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig, TelemetryConfig)
from repro_torch.core.disagg import DisaggregatedServer  # noqa: E402
from repro_torch.core.lora import LoRAConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ARCH = "olmo-1b"
LORA = dict(rank=4, alpha=8.0, max_loaded_adapters=4)
CASES = ["fp", "kivi8", "kivi4", "lora"]
AIDS = ["a0", "a1", None, "a2", "a0"]


@pytest.fixture(scope="module")
def olmo():
    jcfg, jm, values = bcommon.small_model(ARCH)
    tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
    adapters = {f"a{j}": jmake_adapter(jcfg, JLoRAConfig(**LORA), seed=j + 1)
                for j in range(3)}
    return jcfg, jm, values, tm, convert_params(tm.cfg, values), adapters


def _cfg_kw(case, jax_side):
    """The ``make_engine`` defaults, prefix cache off."""
    sched = (JSchedulerConfig if jax_side else SchedulerConfig)(
        max_batch_slots=8, max_batched_tokens=64, prefill_chunk=16)
    quant = JQuantConfig if jax_side else QuantConfig
    lora = JLoRAConfig if jax_side else LoRAConfig
    kw = dict(block_size=8, num_blocks=512, max_model_len=256, scheduler=sched,
              enable_prefix_cache=False,
              kv_quant=quant(bits=int(case[4:])) if case.startswith("kivi") else None,
              lora=lora(**LORA) if case == "lora" else None)
    return dict(kw, num_state_slots=32) if jax_side else dict(kw, device="cpu")


def _requests(jcfg, case):
    reqs = bcommon.make_requests(jcfg, 5, np.random.default_rng(11))
    if case == "lora":
        reqs = [dataclasses.replace(r, adapter_id=a) for r, a in zip(reqs, AIDS)]
    return reqs


def _port_request(r):
    return Request(request_id=r.request_id, prompt=list(r.prompt), user_id=r.user_id,
                   adapter_id=r.adapter_id,
                   sampling=SamplingParams(max_new_tokens=r.sampling.max_new_tokens))


def _engines(srv):
    return (srv.prefill_engine, srv.decode_engine) \
        if isinstance(srv, (DisaggregatedServer, JDisaggregatedServer)) else (srv,)


def _serve(srv, reqs, adapters, port):
    for eng in _engines(srv):
        if eng.adapters is not None:
            for aid in sorted(adapters):
                eng.register_adapter(aid, adapters[aid])
    for r in reqs:
        srv.add_request(_port_request(r) if port else dataclasses.replace(r))
    srv.run()
    return {rid: list(s.generated) for rid, s in srv.seqs.items()}


@pytest.fixture(scope="module")
def served(olmo):
    """case -> (JAX server, port server, JAX streams, port streams, port
    colocated streams)."""
    jcfg, jm, values, tm, params, adapters = olmo
    out = {}
    for case in CASES:
        reqs = _requests(jcfg, case)
        jsrv = JDisaggregatedServer(jm, values,
                                    prefill_cfg=JEngineConfig(**_cfg_kw(case, True)),
                                    decode_cfg=JEngineConfig(**_cfg_kw(case, True)))
        tsrv = DisaggregatedServer(tm, params,
                                   prefill_cfg=EngineConfig(**_cfg_kw(case, False)),
                                   decode_cfg=EngineConfig(**_cfg_kw(case, False)))
        colo = LLMEngine(tm, params, EngineConfig(**_cfg_kw(case, False)))
        out[case] = (jsrv, tsrv, _serve(jsrv, reqs, adapters, False),
                     _serve(tsrv, reqs, adapters, True), _serve(colo, reqs, adapters, True))
    return out


@pytest.mark.parametrize("case", CASES)
def test_disagg_matches_jax(served, case):
    jsrv, tsrv, jout, tout, _ = served[case]
    assert len(tout) == 5 and all(len(t) > 0 for t in tout.values())
    assert tout == jout
    assert tsrv.stats.migrated == jsrv.stats.migrated == 5
    assert tsrv.stats.transfer_bytes == jsrv.stats.transfer_bytes > 0
    if case.startswith("kivi"):
        assert tsrv.decode_engine.store.quantized


@pytest.mark.parametrize("case", CASES)
def test_disagg_matches_colocated(served, case):
    _, tsrv, _, tout, colo = served[case]
    assert tout == colo
    # the split: every sequence left the prefill engine after its first
    # token and finished on the decode engine, which charged no prompt token
    pre, dec = tsrv.prefill_engine, tsrv.decode_engine
    assert not pre.seqs and not pre.finished and len(dec.seqs) == len(dec.finished) == 5
    out_cost = dec.vtc.output_cost
    assert sum(dec.vtc.counters.values()) == out_cost * sum(len(g) - 1 for g in tout.values())


def _payload_bytes(page):
    if isinstance(page, torch.Tensor):
        return page.numpy().tobytes()
    if isinstance(page, (list, tuple)):
        return [_payload_bytes(p) for p in page]
    return page  # the block_quantized flag


@pytest.mark.parametrize("quant", [None, 8])
def test_export_import_round_trip(olmo, quant):
    """One sequence prefilled on one engine moves to another: the restored
    blocks' payloads are byte-equal to the exported ones (fp pages; KIVI
    codes, planes, and the staging page of the block still filling), the
    source's blocks return to its free list, and the bytes counted are the
    payload's."""
    _, _, _, tm, params, _ = olmo
    case = "kivi8" if quant else "fp"
    src = LLMEngine(tm, params, EngineConfig(**_cfg_kw(case, False),
                                             telemetry=TelemetryConfig()))
    dst = LLMEngine(tm, params, EngineConfig(**_cfg_kw(case, False),
                                             telemetry=TelemetryConfig()))
    free0 = src.bm.free_blocks
    prompt = [int(x) for x in np.random.default_rng(3).integers(2, 500, 37)]
    seq = src.add_request(Request(request_id="m", prompt=prompt,
                                  sampling=SamplingParams(max_new_tokens=8)))
    while not seq.generated:
        src.step()
    payload = src.export_seq("m")
    assert "m" not in src.seqs and seq not in src.scheduler.running
    assert src.bm.free_blocks == free0
    assert payload["state"] is None and len(payload["blocks"]) == 5  # 38 slots of 8
    if quant:  # blocks 0-3 packed, block 4 (slots 32-37) still filling
        assert [p[-1] for p in payload["blocks"]] == [True] * 4 + [False]
        assert all(len(p[0]) == 3 for p in payload["blocks"][:4])
        assert len(payload["blocks"][4][0]) == 4
    moved = dst.import_seq(payload)
    assert moved.generated == seq.generated and moved.num_computed == seq.num_computed
    for b, page in zip(moved.block_table, payload["blocks"]):
        assert _payload_bytes(dst.store.block_payload(b)) == _payload_bytes(page)
    want = sum(t.numel() * t.element_size() for page in payload["blocks"]
               for leaf in page if not isinstance(leaf, bool)
               for t in (leaf if isinstance(leaf, tuple) else (leaf,)))
    assert dst.last_import_bytes == want > 0
    assert dst.store.dirty_blocks >= set(moved.block_table)
    out = [e for e in src.trace.events if e.name == "migrate_out"]
    inn = [e for e in dst.trace.events if e.name == "migrate_in"]
    assert [e.args for e in out] == [{"seq": "m", "blocks": 5}]
    assert [e.args for e in inn] == [{"seq": "m", "bytes": want, "blocks": 5}]
    dst.run()
    assert len(moved.generated) == 8


def test_import_refuses_adapter_bound_without_lora(olmo):
    _, _, _, tm, params, adapters = olmo
    src = LLMEngine(tm, params, EngineConfig(**_cfg_kw("lora", False)))
    src.register_adapter("a0", adapters["a0"])
    dst = LLMEngine(tm, params, EngineConfig(**_cfg_kw("fp", False)))
    seq = src.add_request(Request(request_id="m", prompt=list(range(2, 22)),
                                  adapter_id="a0",
                                  sampling=SamplingParams(max_new_tokens=4)))
    while not seq.generated:
        src.step()
    payload = src.export_seq("m")
    with pytest.raises(ValueError, match="bound to adapter 'a0' but this engine "
                                         "has no EngineConfig.lora"):
        dst.import_seq(payload)
    # a state payload into an engine whose model has no state leaves
    with pytest.raises(ValueError, match="carries state slot but this engine's "
                                         "model .* has no state leaves"):
        dst.import_seq(dict(payload, state=[np.zeros(1)],
                            request=dataclasses.replace(payload["request"],
                                                        adapter_id=None)))
