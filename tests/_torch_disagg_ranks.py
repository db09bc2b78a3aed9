"""Rank-side work of the port's mixed-layout disaggregation tests, run by
``repro_torch.launch.mesh.spawn_ranks`` on the CPU over gloo (one intra-op
thread per rank). Imports neither JAX nor ``repro``: the test process
draws the weights and adapters with JAX and hands them over as numpy
trees, and holds the ranks' results against JAX's single-device
``DisaggregatedServer`` itself.

Every rank builds the reference's call, ``DisaggregatedServer(model,
whole_params, prefill_cfg=..., decode_cfg=...)``, with a ``ShardingConfig``
on one or both configs; a sharded engine cuts its rank's slices from the
whole tree."""
import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import (EngineConfig, LLMEngine, LoRAConfig, QuantConfig, Request,
                              SamplingParams, SchedulerConfig)
from repro_torch.core.disagg import DisaggregatedServer
from repro_torch.core.executor.sharded import shard_params
from repro_torch.core.executor.state import map_page, page_tensors
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import convert_params
from repro_torch.sharding import ShardingConfig

LORA = dict(rank=4, alpha=8.0, max_loaded_adapters=4)
PROMPT_LENS = (20, 33, 9, 41)
MAX_NEW = 6
AIDS = ("a0", "a1", None, "a0")
# label -> (arch, KIVI bits, LoRA, prefill (data, model), decode (data, model),
# whole tree handed over); None = one device
CASES2 = {
    "olmo-1b fp 1->2": ("olmo-1b", None, False, None, (1, 2), True),
    "olmo-1b fp 2->1": ("olmo-1b", None, False, (1, 2), None, True),
    "qwen2.5-32b KIVI-8 1->2": ("qwen2.5-32b", 8, False, None, (1, 2), True),
    "gemma-2b fp 1->2": ("gemma-2b", None, False, None, (1, 2), True),
    "olmo-1b LoRA 2->1": ("olmo-1b", None, True, (1, 2), None, True),
    "olmo-1b fp 2->2, rank slices": ("olmo-1b", None, False, (1, 2), (1, 2), False),
}
CASES4 = {
    "olmo-1b fp (2,2)->(1,4)": ("olmo-1b", None, False, (2, 2), (1, 4), True),
}


def prompts(vocab: int):
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(2, vocab, n)] for n in PROMPT_LENS]


def engine_cfg(layout=None, bits=None, lora=False, **kw):
    """The reference's ``_SHARDED_SCRIPT`` engine settings, prefix cache off,
    on the CPU; ``layout`` (data, model) or None."""
    base = dict(block_size=8, num_blocks=128, max_model_len=128, device="cpu",
                enable_prefix_cache=False,
                sharding=ShardingConfig(data_axis=layout[0], model_axis=layout[1])
                if layout else None,
                kv_quant=QuantConfig(bits=bits) if bits else None,
                lora=LoRAConfig(**LORA) if lora else None,
                scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=48,
                                          prefill_chunk=16))
    base.update(kw)
    return EngineConfig(**base)


def _group(eng):
    return eng.paged_runner.tp if eng.paged_runner is not None else None


def serve_case(model, params, case, adapters):
    """One case through ``DisaggregatedServer``; every model group's
    collective counts set to 0 just before. Returns the streams, the stats
    and each engine's all-gathers (count, bytes) on its model group."""
    _, bits, lora, pre, dec, whole = case
    if not whole:
        mesh = make_serving_mesh(*pre, device="cpu")
        params = shard_params(params, model.cfg, mesh)
    srv = DisaggregatedServer(model, params, prefill_cfg=engine_cfg(pre, bits, lora),
                              decode_cfg=engine_cfg(dec, bits, lora))
    for eng in (srv.prefill_engine, srv.decode_engine):
        if eng.adapters is not None:
            for aid in sorted(adapters):
                eng.register_adapter(aid, adapters[aid])
        if _group(eng) is not None:
            _group(eng).reset_counts()
    for i, pr in enumerate(prompts(model.cfg.vocab_size)):
        srv.add_request(Request(request_id=f"r{i}", prompt=pr,
                                adapter_id=AIDS[i] if lora else None,
                                sampling=SamplingParams(max_new_tokens=MAX_NEW)))
    srv.run()

    def gathers(eng):
        g = _group(eng)
        return (g.all_gathers, g.all_gather_bytes) if g is not None else (0, 0)
    return dict(streams={rid: list(s.generated) for rid, s in srv.seqs.items()},
                migrated=srv.stats.migrated, transfer_bytes=srv.stats.transfer_bytes,
                pre_gathers=gathers(srv.prefill_engine),
                dec_gathers=gathers(srv.decode_engine),
                kv_cut=[eng.kv_group is not None
                        for eng in (srv.prefill_engine, srv.decode_engine)])


def _prefilled(eng, prompt):
    """Request "m" of ``prompt`` on ``eng``, stepped to its first token."""
    seq = eng.add_request(Request(request_id="m", prompt=prompt,
                                  sampling=SamplingParams(max_new_tokens=4)))
    while not seq.generated:
        eng.step()
    return seq


def exported(eng, prompt):
    """``prompt`` prefilled on ``eng`` to its first token, then exported."""
    _prefilled(eng, prompt)
    return eng.export_seq("m")


def same_pages(a, b) -> bool:
    """Two payloads' pages byte-equal: dtypes, shapes, bytes and flags."""
    return len(a) == len(b) and all(
        [e for e in p if isinstance(e, bool)] == [e for e in q if isinstance(e, bool)]
        and len(page_tensors(p)) == len(page_tensors(q))
        and all(x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(page_tensors(p), page_tensors(q)))
        for p, q in zip(a, b))


def export_cases(models, params):
    """A sharded engine's export against a whole engine's (model axis 2):
    a sequence prefilled on the whole engine and moved into the sharded
    one (the rank's store then holds its contiguous cut of each global
    page) is exported again, the gathered payload against the first; the
    sharded engine's own prefill of it gives this rank's pages (``local``)
    and their export (``own``), as numpy, which the test holds against the
    ranks' pages side by side. A payload of neither head count raises."""
    out = {}
    for label, arch, bits in (("fp", "olmo-1b", None), ("KIVI-8", "qwen2.5-32b", 8)):
        model = models[arch]
        pr = prompts(model.cfg.vocab_size)[3]
        whole = exported(LLMEngine(model, params[arch], engine_cfg(None, bits)), pr)
        sharded = LLMEngine(model, shard_params(params[arch], model.cfg,
                                                make_serving_mesh(1, 2, device="cpu")),
                            engine_cfg((1, 2), bits))
        seq = sharded.import_seq(whole)
        g = sharded.kv_group
        cut_ok = all(same_pages([sharded.store.block_payload(b)],
                                [map_page(p, lambda t: t.narrow(0, g.index * t.shape[0] // 2,
                                                                t.shape[0] // 2))])
                     for b, p in zip(seq.block_table, whole["blocks"]))
        g.reset_counts()
        again = sharded.export_seq("m")
        gathers = g.all_gathers
        seq = _prefilled(sharded, pr)
        local = [sharded.store.block_payload(b) for b in seq.block_table]
        own = sharded.export_seq("m")["blocks"]
        out[label] = dict(round_trip=same_pages(again["blocks"], whole["blocks"]),
                          cut=cut_ok, gathers=gathers,
                          local=[map_page(p, torch.Tensor.numpy) for p in local],
                          own=[map_page(p, torch.Tensor.numpy) for p in own])
        if label == "fp":
            bad = dict(whole, blocks=[map_page(p, lambda t: t[:3]) for p in whole["blocks"]])
            try:
                sharded.import_seq(bad)
                out["mismatch"] = None
            except ValueError as e:
                out["mismatch"] = str(e)
    return out


def demotion_gathers(model, params):
    """A sharded engine (model axis 2) with the prefix cache's host tier
    under pressure: two waves of requests over 16 blocks, the second
    evicting and demoting the first's cached blocks. Returns the demoted
    blocks and the model group's all-gathers across the run (the host
    tier's payloads stay rank-local)."""
    mesh = make_serving_mesh(1, 2, device="cpu")
    eng = LLMEngine(model, shard_params(params, model.cfg, mesh),
                    engine_cfg((1, 2), num_blocks=16, host_cache_blocks=16,
                               enable_prefix_cache=True))
    mesh.model.reset_counts()
    rng = np.random.default_rng(5)
    for wave in range(2):
        for i in range(3):
            eng.add_request(Request(
                request_id=f"w{wave}r{i}",
                prompt=[int(t) for t in rng.integers(2, model.cfg.vocab_size, 30)],
                sampling=SamplingParams(max_new_tokens=4)))
        eng.run()
    return dict(demoted=eng.prefix_cache.stats.demoted_blocks,
                gathers=mesh.model.all_gathers, reduces=mesh.model.all_reduces)


def disagg_cases(world, values, adapters):
    """One rank: every case of ``CASES2`` (``world`` 2) or ``CASES4`` (4),
    with the export checks and the demotion on 2 ranks. ``values``: arch ->
    JAX's numpy value tree."""
    torch.set_num_threads(1)
    if world == 2:
        make_serving_mesh(1, 2, backend="gloo", device="cpu")
        cases = CASES2
    else:
        make_serving_mesh(2, 2, backend="gloo", device="cpu")
        make_serving_mesh(1, 4, device="cpu")
        cases = CASES4
    models, params = {}, {}
    for arch in sorted({c[0] for c in cases.values()}):
        cfg = configs.smoke_config(arch)
        models[arch] = build_model(cfg, device="cpu")
        params[arch] = convert_params(cfg, values[arch])
    out = {label: serve_case(models[c[0]], params[c[0]], c, adapters)
           for label, c in cases.items()}
    if world == 2:
        out["exports"] = export_cases(models, params)
        out["demotion"] = demotion_gathers(models["olmo-1b"], params["olmo-1b"])
    return out
