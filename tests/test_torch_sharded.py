"""The port's tensor-parallel paged serving vs the JAX package, on the CPU.

The twin of ``tests/test_executor.py::_SHARDED_SCRIPT``: the reference runs
its ``ShardedPagedRunner`` on 8 forced host devices of one process; the
port runs one process per rank, here 4 ranks over gloo on the CPU with one
intra-op thread each (``repro_torch.launch.mesh.spawn_ranks``). JAX's
single-device ``LLMEngine`` serves five greedy traces on olmo-1b's smoke
config (its weights and adapters drawn by JAX and converted): fp pages,
KIVI 8-bit pages, mixed LoRA (a0, a1, None), speculative k = 3, and the
6-head / 3-KV-head config whose KV heads a model axis of 2 cannot split
(the permuted replicated-KV fallback). The port's single-device engine
and every rank of its sharded engines (model axis 4; the fallback at data
2 x model 2 over the same 4 ranks) must give JAX's streams token for
token. The ranks run while this process runs JAX's engines.
"""
import concurrent.futures
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_sharded_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import LLMEngine as JLLMEngine  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core import SpeculativeConfig as JSpeculativeConfig  # noqa: E402
from repro.core.kv_quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.lora import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.core.lora import make_adapter as jmake_adapter  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import LLMEngine, PagedModelState, SpeculativeConfig  # noqa: E402
from repro_torch.core.executor.sharded import ShardedPagedRunner, tp_layout  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

WORLD = 4
TRACES = ("fp", "kivi8", "lora", "spec", "fallback")


def _jax_values(cfg):
    model = jbuild(cfg)
    values, _ = split_params(model.init(jax.random.PRNGKey(0), max_seq=256))
    return model, jax.tree.map(np.asarray, jax.device_get(values))


def _jax_streams(model, values, prompts, max_new=6, adapters=None, aids=None, **kw):
    base = dict(block_size=8, num_blocks=128, num_state_slots=16, max_model_len=128,
                scheduler=JSchedulerConfig(max_batch_slots=4, max_batched_tokens=48,
                                           prefill_chunk=16))
    base.update(kw)
    eng = JLLMEngine(model, values, JEngineConfig(**base))
    for aid, w in (adapters or {}).items():
        eng.register_adapter(aid, w)
    for i, pr in enumerate(prompts):
        eng.add_request(JRequest(request_id=f"r{i}", prompt=list(pr),
                                 adapter_id=aids[i] if aids else None,
                                 sampling=JSamplingParams(max_new_tokens=max_new)))
    eng.run()
    return {rid: list(s.generated) for rid, s in eng.seqs.items()}


@pytest.fixture(scope="module")
def served():
    jcfg = jconfigs.smoke_config("olmo-1b")
    jfb = dataclasses.replace(jcfg, num_heads=6, num_kv_heads=3)
    jmodel, values = _jax_values(jcfg)
    jfb_model, fb_values = _jax_values(jfb)
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(2, jcfg.vocab_size, size=int(rng.integers(10, 40)))))
               for _ in range(3)]
    jlc = JLoRAConfig(**ranks.LORA)
    adapters = {f"a{j}": jmake_adapter(jcfg, jlc, seed=j + 1) for j in range(3)}

    # the port on one device: streams, and the store bytes the ranks' mirrors
    # are held against
    cfg, fb_cfg = tconfigs.smoke_config("olmo-1b"), ranks.fallback_config()
    one, engines = ranks.scenarios(cfg, convert_params(cfg, values), fb_cfg,
                                   convert_params(fb_cfg, fb_values), prompts, adapters, {})
    kv_bytes_1 = {name: eng.store.kv_bytes_per_block() for name, eng in engines.items()}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranked = pool.submit(spawn_ranks, ranks.serve_sharded, WORLD, values, fb_values,
                             prompts, adapters, kv_bytes_1, timeout=300)
        jax_streams = {
            "fp": _jax_streams(jmodel, values, prompts),
            "kivi8": _jax_streams(jmodel, values, prompts, kv_quant=JQuantConfig(bits=8)),
            "lora": _jax_streams(jmodel, values, prompts, adapters=adapters,
                                 aids=["a0", "a1", None], lora=jlc),
            "spec": _jax_streams(jmodel, values, prompts, speculative=JSpeculativeConfig(
                num_draft_tokens=ranks.SPEC_K)),
            "fallback": _jax_streams(jfb_model, fb_values, [p[:16] for p in prompts],
                                     max_new=4),
        }
        per_rank = ranked.result()
    return jax_streams, one, per_rank


@pytest.mark.parametrize("trace", TRACES)
def test_streams_equal_jax_on_every_rank(served, trace):
    """JAX's single-device engine == the port's single-device engine == each
    of the port's 4 ranks, token for token."""
    jax_streams, one, per_rank = served
    assert one[trace] == jax_streams[trace], trace
    for rank, (streams, _) in enumerate(per_rank):
        assert streams[trace] == jax_streams[trace], (trace, rank)


def test_sharded_runner_layout(served):
    """Model axis 4 on the MHA smoke config shards KV heads and the GLU
    hidden units; 6 heads over 3 KV heads at model axis 2 keep KV
    replicated and permute the q-side heads."""
    for _, info in served[2]:
        fp, fb = info["fp"], info["fallback"]
        assert fp["runner"] == fb["runner"] == "ShardedPagedRunner"
        assert fp["kv_sharded"] and fp["ff_sharded"] and not fp["permuted"]
        assert not fb["kv_sharded"] and fb["permuted"]


def test_sharded_engine_holds_the_rank_slices(served):
    """A sharded engine holds the rank's slices of the weights (its query
    heads, and its KV heads where they shard) and builds no gathered
    runner, so no rank keeps the whole tree."""
    cfg, fb = tconfigs.smoke_config("olmo-1b"), ranks.fallback_config()
    for _, info in served[2]:
        assert not info["fp"]["gathered"] and not info["fallback"]["gathered"]
        assert info["fp"]["heads"] == (cfg.num_heads // 4, cfg.num_kv_heads // 4)
        assert info["fallback"]["heads"] == (fb.num_heads // 2, fb.num_kv_heads)


def test_rank_params_are_slices_of_the_whole_init(served):
    """``rank_params`` (each layer cut as it is drawn) gives the very
    tensors ``shard_params`` cuts from the whole init: olmo at model axis
    4 (the GLU order), the 6-head fallback and qwen's smoke config (qkv
    biases) at data 2 x model 2."""
    for _, info in served[2]:
        assert len(info["rank_params"]) == 3 and all(info["rank_params"].values()), \
            info["rank_params"]


def test_ranks_form_the_mesh(served):
    """Rank r sits at (data r // model, model r % model): one model group of
    4, then two of 2."""
    for rank, (_, info) in enumerate(served[2]):
        assert info["model_group"]["model=4"] == (0, 1, 2, 3)
        assert info["model_group"]["data=2 model=2"] == ((0, 1) if rank < 2 else (2, 3))


def test_capacity_and_no_host_copy(served):
    """The paged path stages no window (host_copy_bytes == 0), and a rank's
    mirror holds a quarter of a block's bytes at model axis 4 (>= 3.5x the
    single-device store, as the reference's bench_sharded asserts); the
    replicated-KV fallback holds all of them."""
    for _, info in served[2]:
        assert info["fp"]["host_copy_bytes"] == info["fallback"]["host_copy_bytes"] == 0
        assert info["fp"]["capacity"] >= 3.5
        assert info["fallback"]["capacity"] == 1.0


def test_all_reduces_per_step(served):
    """Two all-reduces per layer and paged step (after wo, after w2 with the
    hidden axis sharded) and no other collective."""
    for _, info in served[2]:
        for name in ("fp", "fallback"):
            e = info[name]
            assert e["all_reduces"] == 2 * e["layers"] * e["paged_steps"], (name, e)


def test_qwen_smoke_at_model_axis_4_raises():
    """qwen2.5-32b's smoke config (4 heads over 2 KV heads) cannot replicate
    KV at model axis 4: the reference's error, before any rank is needed."""
    cfg = tconfigs.smoke_config("qwen2.5-32b")
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"replicated-KV fallback needs the GQA group "
                                         r"count \(2\) divisible by the model axis \(4\)"):
        LLMEngine(model, model.init(0), ranks.engine_cfg(mp=4))


@pytest.mark.parametrize("arch,backend", [("starcoder2-3b", "auto"),
                                          ("olmo-1b", "gathered")])
def test_gathered_only_raises(arch, backend):
    """Sharding needs the paged backend: a sliding-window stack, or any
    stack asked to serve gathered, raises the reference's error."""
    model = build_model(tconfigs.smoke_config(arch), device="cpu")
    with pytest.raises(ValueError, match="EngineConfig.sharding needs the paged backend"):
        LLMEngine(model, model.init(0), ranks.engine_cfg(mp=2, execution_backend=backend))


def test_sharded_runner_refuses_a_global_store():
    """A sharded runner over a store of every KV head (not the rank's)
    raises before it reaches a mesh."""
    cfg = tconfigs.smoke_config("olmo-1b")
    model = build_model(cfg, device="cpu")
    eng_cfg = ranks.engine_cfg(mp=4)
    store = PagedModelState(cfg, eng_cfg, device="cpu")
    with pytest.raises(ValueError, match="KV heads per rank"):
        ShardedPagedRunner(model, model.init(0), eng_cfg, store)


def test_sharded_runner_refuses_whole_params():
    """A sharded runner over the rank's store but given the whole tree (not
    the rank's slices) raises before it reaches a mesh."""
    cfg = tconfigs.smoke_config("olmo-1b")
    model = build_model(cfg, device="cpu")
    eng_cfg = ranks.engine_cfg(mp=4)
    store = PagedModelState(tp_layout(cfg, 4).local_cfg, eng_cfg, device="cpu")
    with pytest.raises(ValueError, match="pass the rank's slices"):
        ShardedPagedRunner(model, model.init(0), eng_cfg, store)


@pytest.mark.parametrize("backend", ["auto", "speculative"])
def test_sharded_speculation_needs_its_whole_draft(backend):
    """Self-speculation on a sharded engine without a draft raises: the
    engine holds only its rank's slices of the target."""
    model = build_model(tconfigs.smoke_config("olmo-1b"), device="cpu")
    spec = SpeculativeConfig(num_draft_tokens=3) if backend == "auto" else None
    with pytest.raises(ValueError, match="give speculation its whole draft"):
        LLMEngine(model, model.init(0), ranks.engine_cfg(
            mp=2, execution_backend=backend, speculative=spec))
