"""The port's disaggregated server across tensor-parallel layouts vs the JAX
package, on the CPU.

The reference keeps its sharded runner's host store global, so its
``export_seq`` / ``import_seq`` carry every KV head and its
``DisaggregatedServer(model, params, prefill_cfg=..., decode_cfg=...)``
runs prefill and decode at different model axes (DistServe's per-phase
parallelism, survey §IV.B). The port's ranks store their own KV heads; a
payload holds the global pages all the same: a sharded engine gathers
them over its model group on export (one all-gather per sequence) and
keeps its rank's contiguous cut on import.

Two worlds of gloo ranks (``launch/mesh.py::spawn_ranks``, one intra-op
thread each; rank-side work in ``tests/_torch_disagg_ranks.py``, which
imports no JAX) run while this process runs JAX's single-device
``DisaggregatedServer`` on the same weights (JAX's init, converted) and
traffic (prompts of 20, 33, 9 and 41 tokens, 6 greedy tokens, block 8).
2 ranks: olmo-1b fp at 1 -> 2, 2 -> 1 and 2 -> 2 (rank slices handed
over), qwen2.5-32b KIVI 8-bit at 1 -> 2 (codes, planes and staging cut),
gemma-2b at 1 -> 2 (MQA: the KV head replicated, nothing cut), olmo-1b
mixed LoRA at 2 -> 1; a sharded export against a whole engine's, a
payload of a foreign head count, the host tier's demotion under pressure.
4 ranks: olmo-1b fp at (data 2, model 2) -> (data 1, model 4). Every
rank's streams and ``transfer_bytes`` must equal JAX's.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_disagg_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core.disagg import DisaggregatedServer as JDisaggregatedServer  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import LLMEngine  # noqa: E402
from repro_torch.core.disagg import DisaggregatedServer  # noqa: E402
from repro_torch.core.executor.sharded import shard_params, tp_layout  # noqa: E402
from repro_torch.core.executor.state import map_page, page_tensors  # noqa: E402
from repro_torch.launch.mesh import make_virtual_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CASES = {**ranks.CASES2, **ranks.CASES4}
ARCHS = ("olmo-1b", "qwen2.5-32b", "gemma-2b")


def _jax_values(arch):
    model = jbuild(jconfigs.smoke_config(arch))
    values, _ = split_params(model.init(jax.random.PRNGKey(0), max_seq=256))
    return model, jax.tree.map(np.asarray, jax.device_get(values))


def _jax_disagg(model, values, bits, lora, adapters):
    """JAX's single-device ``DisaggregatedServer`` on the ranks' traffic:
    (streams, migrated, transfer_bytes)."""
    def cfg():
        return JEngineConfig(block_size=8, num_blocks=128, num_state_slots=16,
                             max_model_len=128, enable_prefix_cache=False,
                             kv_quant=JQuantConfig(bits=bits) if bits else None,
                             lora=JLoRAConfig(**ranks.LORA) if lora else None,
                             scheduler=JSchedulerConfig(max_batch_slots=4,
                                                        max_batched_tokens=48,
                                                        prefill_chunk=16))
    srv = JDisaggregatedServer(model, values, prefill_cfg=cfg(), decode_cfg=cfg())
    for eng in (srv.prefill_engine, srv.decode_engine):
        if lora:
            for aid in sorted(adapters):
                eng.register_adapter(aid, adapters[aid])
    for i, pr in enumerate(ranks.prompts(model.cfg.vocab_size)):
        srv.add_request(JRequest(request_id=f"r{i}", prompt=pr,
                                 adapter_id=ranks.AIDS[i] if lora else None,
                                 sampling=JSamplingParams(max_new_tokens=ranks.MAX_NEW)))
    srv.run()
    return ({rid: list(s.generated) for rid, s in srv.seqs.items()},
            srv.stats.migrated, srv.stats.transfer_bytes)


@pytest.fixture(scope="module")
def served():
    """(JAX's results by (arch, bits, lora), the 2 ranks' results, the 4
    ranks' results). JAX's inits and servers run in threads of this
    process (each engine its own; XLA compiles outside the interpreter
    lock) while the ranks run."""
    adapters = {f"a{j}": jmake_adapter(jconfigs.smoke_config("olmo-1b"),
                                       JLoRAConfig(**ranks.LORA), seed=j + 1)
                for j in range(2)}
    keys = list(dict.fromkeys((arch, bits, lora) for arch, bits, lora, *_ in CASES.values()))
    with ThreadPoolExecutor(len(keys) + 2) as ex:
        drawn = dict(zip(ARCHS, ex.map(_jax_values, ARCHS)))
        values = {arch: v for arch, (_, v) in drawn.items()}
        w2 = ex.submit(spawn_ranks, ranks.disagg_cases, 2, 2, values, adapters,
                       timeout=300)
        w4 = ex.submit(spawn_ranks, ranks.disagg_cases, 4, 4,
                       {"olmo-1b": values["olmo-1b"]}, adapters, timeout=300)
        ref = dict(zip(keys, ex.map(lambda k: _jax_disagg(*drawn[k[0]], k[1], k[2], adapters),
                                    keys)))
        return ref, w2.result(), w4.result()


def _results(served, label):
    ref, r2, r4 = served
    arch, bits, lora, *_ = CASES[label]
    return ref[arch, bits, lora], [r[label] for r in (r2 if label in ranks.CASES2 else r4)]


@pytest.mark.parametrize("label", list(CASES))
def test_streams_equal_jax_on_every_rank(served, label):
    """Each rank's streams equal JAX's single-device server's, token for
    token, and every sequence migrated."""
    (streams, migrated, _), per_rank = _results(served, label)
    assert migrated == len(ranks.PROMPT_LENS)
    assert all(len(s) == ranks.MAX_NEW for s in streams.values())
    for rank, res in enumerate(per_rank):
        assert res["streams"] == streams, (label, rank)
        assert res["migrated"] == migrated, (label, rank)


@pytest.mark.parametrize("label", list(CASES))
def test_transfer_bytes_equal_jax(served, label):
    """``transfer_bytes`` counts the global pages at every layout, as the
    reference's global host store does."""
    (_, _, transfer), per_rank = _results(served, label)
    assert transfer > 0
    for rank, res in enumerate(per_rank):
        assert res["transfer_bytes"] == transfer, (label, rank)


@pytest.mark.parametrize("label", list(CASES))
def test_one_all_gather_per_migration(served, label):
    """A prefill engine whose KV heads are cut issues one all-gather per
    migrated sequence over its model group, of the payload's bytes; an
    import issues none, nor does an engine whose store holds every KV head
    (one device, gemma-2b's replicated MQA head at model axis 2)."""
    arch, _, _, pre, dec, _ = CASES[label]
    _, per_rank = _results(served, label)
    kv = tconfigs.smoke_config(arch).num_kv_heads
    for res in per_rank:
        assert res["kv_cut"] == [lay is not None and kv % lay[1] == 0 for lay in (pre, dec)]
        if res["kv_cut"][0]:
            assert res["pre_gathers"] == (res["migrated"], res["transfer_bytes"]), label
        else:
            assert res["pre_gathers"] == (0, 0), label
        if dec != pre:  # the groups differ, so the decode engine's is its own
            assert res["dec_gathers"] == (0, 0), label


@pytest.mark.parametrize("kind", ["fp", "KIVI-8"])
def test_sharded_export_equals_whole(served, kind):
    """olmo-1b fp and qwen2.5-32b KIVI 8-bit (codes, planes, staging and
    packed flags) at model axis 2. A sequence prefilled on a whole engine
    and moved into the sharded one: the rank's store holds its contiguous
    cut of each page, and the sharded engine's export (one all-gather of
    the global pages) is byte-equal to the whole engine's. The sharded
    engine's own prefill of the same prompt: its export on each rank is
    byte-equal to the two ranks' stores side by side, in rank order."""
    ranks_ = [res["exports"][kind] for res in served[1]]
    kv = tconfigs.smoke_config("olmo-1b" if kind == "fp" else "qwen2.5-32b").num_kv_heads
    for e in ranks_:
        assert e["cut"] and e["round_trip"] and e["gathers"] == 1, e
        for own, *local in zip(e["own"], *(r["local"] for r in ranks_)):
            assert [f for f in own if isinstance(f, bool)] == \
                [f for f in local[0] if isinstance(f, bool)]
            for x, *parts in zip(page_tensors(own), *map(page_tensors, local)):
                assert x.shape[0] == kv and x.dtype == parts[0].dtype
                assert np.array_equal(x, np.concatenate(parts))


def test_mismatched_payload_raises_on_a_rank(served):
    """Pages of 3 KV heads into a rank of model axis 2 of olmo-1b (4 KV
    heads, 2 a rank) raise, naming both counts."""
    for res in served[1]:
        assert res["exports"]["mismatch"] == (
            "migrated request 'm' carries pages of 3 KV heads: neither the model's 4 "
            "nor the 2 this engine's store holds")


def test_mismatched_payload_raises_on_one_device():
    """A whole engine refuses a rank's cut of the pages, before it
    allocates a block."""
    cfg = tconfigs.smoke_config("olmo-1b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    src = LLMEngine(model, params, ranks.engine_cfg())
    dst = LLMEngine(model, params, ranks.engine_cfg())
    payload = ranks.exported(src, list(range(2, 22)))
    payload["blocks"] = [map_page(p, lambda t: t[:2]) for p in payload["blocks"]]
    free = dst.bm.free_blocks
    with pytest.raises(ValueError, match=r"carries pages of 2 KV heads: neither the "
                                         r"model's 4 nor the 4 this engine's store holds"):
        dst.import_seq(payload)
    assert dst.bm.free_blocks == free and not dst.seqs


def test_host_tier_demotion_issues_no_collective(served):
    """The prefix cache's host tier demotes a sharded engine's blocks
    rank-local: blocks demoted, no all-gather on the model group."""
    for res in served[1]:
        d = res["demotion"]
        assert d["demoted"] > 0 and d["gathers"] == 0 and d["reduces"] > 0, d


def test_whole_engine_refuses_rank_slices():
    """``DisaggregatedServer`` hands a whole engine the tree itself: rank
    slices there raise with both head counts, before any rank is needed."""
    cfg = tconfigs.smoke_config("olmo-1b")
    model = build_model(cfg, device="cpu")
    slices = shard_params(model.init(0), cfg, make_virtual_mesh({"data": 1, "model": 2},
                                                                device="cpu"))
    assert slices["layers"][0]["mixer"]["wq"]["w"].shape[1] == \
        tp_layout(cfg, 2).local_cfg.num_heads
    with pytest.raises(ValueError, match=r"the parameters hold 2 query heads a layer: an "
                                         r"engine at model axis 1 takes 4"):
        DisaggregatedServer(model, slices, prefill_cfg=ranks.engine_cfg(),
                            decode_cfg=ranks.engine_cfg((1, 2)))
