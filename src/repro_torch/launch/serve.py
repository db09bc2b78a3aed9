"""Serving entry point of the PyTorch port: the engine loop over one architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --no-debug --requests 8          # full published width, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2                     # smoke width on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --kv-quant-bits 8   # KIVI-quantized pages
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 4 --num-adapters 2    # multi-tenant LoRA
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch starcoder2-3b --requests 2   # sliding window: gathered backend
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama4-scout-17b-a16e --requests 2   # MoE, chunked: gathered
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --backend gathered  # olmo-1b on the gathered backend
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-v3-671b --requests 2   # MLA latents: gathered
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch jamba-v0.1-52b --requests 2   # Mamba + MoE + attention: gathered
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch xlstm-1.3b --requests 2       # mLSTM + sLSTM: gathered
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch starcoder2-3b --requests 2 --kv-quant-bits 8   # KIVI, gathered
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --backend gathered --kv-quant-bits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --backend speculative --spec-k 3   # draft–verify decode
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --trace-out build/t.json   # then:
    python tools/trace_summary.py build/t.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2 --tp 2 --dist-backend gloo   # 2 tensor-parallel ranks
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 \
        --dist-backend gloo   # 2 ranks sharing one card

``--debug`` (the default) serves the reduced smoke config, ``--no-debug``
the published one. ``--device`` defaults to ``cuda``; there is no CPU
fallback. Weights are random, drawn from a seeded ``torch.Generator``.
The report gives the steps, the paged ones among them, ``host_copy`` (the
gathered backend's window traffic, 0 on the paged path), where the
gathered backend ran, the batch rows of each attention route, the KIVI
capacity where the store holds quantized pages (``--kv-quant-bits`` on an
MLA stack stores the latents' quantize–dequantize round trip in fp pages
instead, as the reference does, and prints no capacity) and, where
speculation ran, its acceptance rate, tokens per speculative step and
speculative steps. Any ``--spec-*`` flag turns speculation on under
``--backend auto``; without ``--spec-draft-seed`` the target drafts for
itself. ``--trace-out`` turns step tracing on and writes a Chrome
trace-event JSON (``otherData``: arch, backend, device name) that
``tools/trace_summary.py`` summarizes, decode roofline fraction included.
``build_engine`` is the construction path ``chip_smoke.py`` drives too.

``--tp N`` / ``--dp M`` serve on a ``(data=M, model=N)`` mesh of N * M
ranks (tensor-parallel paged serving, ``core/executor/sharded.py``): the
command spawns its own ranks (``launch/mesh.spawn_ranks``), each one
process running the same engine on the same requests over
``--dist-backend``: ``nccl`` (the default) puts each rank on a card of
its own and refuses more ranks than cards; ``gloo`` lets ranks share a
card (or run on the CPU with ``--device cpu``), staging each all-reduce
through the host. The data axis replicates: each of the M model groups
serves the whole batch and computes the same streams, M times the cards
for no added throughput. Rank 0 prints the report, with ``mesh=(data=…,
model=…) kv_sharded=… dev_kv_bytes/block=…`` (one rank's device bytes of
a KV block) and the per-rank all-reduce count, and writes the trace; the
command exits 0 only when every rank generated the same streams.

State-mixer stacks (jamba-v0.1-52b, xlstm-1.3b) hold one state slot per
sequence in host memory, 64 slots as the reference serves them. At
published width xLSTM's state is 706 511 616 bytes a sequence (the 42
mLSTM layers' f32 matrix memories, 16.8 MB each), so 64 slots are 45.2 GB
of host memory, and every step moves each scheduled sequence's state to
the device and back; Jamba's is 4 014 080 bytes a sequence per 8 layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import (EngineConfig, LLMEngine, QuantConfig, Request,
                              SamplingParams, SchedulerConfig, SpeculativeConfig,
                              TelemetryConfig, write_chrome_trace)
from repro_torch.core.executor.sharded import rank_params
from repro_torch.core.lora import LoRAConfig, make_adapter
from repro_torch.launch.mesh import BACKENDS, make_serving_mesh, spawn_ranks
from repro_torch.models import build_model
from repro_torch.sharding import ShardingConfig


def build_engine(arch: str, *, debug: bool = True, device: str = "cuda",
                 backend: str = "auto", policy: str = "fcfs", seed: int = 0,
                 kv_quant: Optional[QuantConfig] = None,
                 lora: Optional[LoRAConfig] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 draft_seed: Optional[int] = None,
                 telemetry: Optional[TelemetryConfig] = None,
                 **engine_kw) -> LLMEngine:
    """Model (smoke or published config) + random weights + engine.
    ``kv_quant`` stores KIVI-quantized pages; ``lora`` turns on multi-tenant
    LoRA (adapters are registered by the caller); ``speculative`` turns on
    draft–verify decode, with the same model at weights from ``draft_seed``
    as the draft when one is given (else the config's own draft, or the
    target itself); ``telemetry`` turns on step tracing; ``engine_kw``
    overrides the serving defaults below (EngineConfig fields, e.g.
    ``max_model_len`` or a ``scheduler``). Under a ``sharding`` of more
    than one rank the engine gets the rank's slices of the weights, drawn
    layer by layer (``rank_params``), and a speculative draft is the whole
    model, drawn apart and replicated on every rank."""
    cfg = configs.smoke_config(arch) if debug else configs.get_config(arch)
    model = build_model(cfg, device=device)
    sh = engine_kw.get("sharding")
    if sh is not None and sh.num_devices > 1:
        mesh = make_serving_mesh(sh.data_axis, sh.model_axis, device=device)
        params = rank_params(model, seed, mesh=mesh)
        if (speculative is not None or backend == "speculative") and draft_seed is None:
            draft_seed = seed  # self-speculation: the whole target as the draft
        if backend == "speculative" and speculative is None:
            speculative = SpeculativeConfig()
    else:
        params = model.init(seed)
    if speculative is not None and draft_seed is not None:
        speculative = dataclasses.replace(speculative, draft_model=model,
                                          draft_params=model.init(draft_seed))
    kw = dict(block_size=16, num_blocks=512, num_state_slots=64, max_model_len=256,
              execution_backend=backend, device=device, seed=seed,
              kv_quant=kv_quant, lora=lora, speculative=speculative,
              telemetry=telemetry,
              scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=128,
                                        prefill_chunk=32, policy=policy))
    kw.update(engine_kw)
    return LLMEngine(model, params, EngineConfig(**kw))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "vtc", "qoe"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "gathered", "paged", "speculative"],
                    help="execution backend")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens per speculative step (any --spec-* "
                         "flag turns speculation on under --backend auto)")
    ap.add_argument("--spec-draft-seed", type=int, default=None,
                    help="draft = the same config at weights from this seed "
                         "(default: self-speculation, draft == target)")
    ap.add_argument("--spec-min-acceptance", type=float, default=0.0,
                    help="turn speculation off below this windowed "
                         "acceptance rate (0 = never)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and kernels run on")
    ap.add_argument("--kv-quant-bits", type=int, default=0,
                    help="KIVI-quantize KV pages at rest at this many bits "
                         "(2, 4 or 8; keys per channel, values per token; "
                         "on an MLA stack, the latents' round trip); "
                         "0 = fp pages")
    ap.add_argument("--num-adapters", type=int, default=0,
                    help="serve this many synthetic LoRA tenants (requests "
                         "round-robin across them; 0 = multi-LoRA off)")
    ap.add_argument("--lora-rank", type=int, default=8,
                    help="LoRA adapter rank (with --num-adapters)")
    ap.add_argument("--adapter-pool-pages", type=int, default=0,
                    help="cap on KV-pool pages the adapter store may rent "
                         "(0 = share the pool freely)")
    ap.add_argument("--trace-out", default=None,
                    help="enable step tracing and write a Perfetto-loadable "
                         "Chrome trace-event JSON here (inspect with "
                         "tools/trace_summary.py)")
    ap.add_argument("--debug", action=argparse.BooleanOptionalAction,
                    default=True, help="smoke config (--no-debug: published)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size of the serving mesh: shard the "
                         "attention heads (and KV heads and MLP hidden units "
                         "where they divide) over this many ranks")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-axis size of the serving mesh: model groups that "
                         "each serve the whole batch, so every group computes the "
                         "same streams (the reference's replicated data axis): M "
                         "times the cards for no added throughput or capacity")
    ap.add_argument("--dist-backend", default="nccl", choices=list(BACKENDS),
                    help="torch.distributed backend of the ranks (with --tp/--dp): "
                         "nccl needs a card per rank; gloo lets ranks share a "
                         "card or run on the CPU")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, device=None, sharding=None):
    """Build the engine, serve ``args.requests`` requests, write the trace
    (rank 0 only under ``sharding``); returns (report line, streams)."""
    device = args.device if device is None else device
    kv_quant = QuantConfig(bits=args.kv_quant_bits) if args.kv_quant_bits else None
    lora = LoRAConfig(rank=args.lora_rank, pool_pages=args.adapter_pool_pages) \
        if args.num_adapters else None
    speculative = None
    if (args.backend == "speculative" or args.spec_k is not None
            or args.spec_draft_seed is not None or args.spec_min_acceptance > 0):
        speculative = SpeculativeConfig(
            num_draft_tokens=args.spec_k if args.spec_k is not None else 4,
            min_acceptance=args.spec_min_acceptance)
    engine = build_engine(args.arch, debug=args.debug, device=device,
                          backend=args.backend, policy=args.policy,
                          kv_quant=kv_quant, lora=lora, speculative=speculative,
                          draft_seed=args.spec_draft_seed,
                          telemetry=TelemetryConfig() if args.trace_out else None,
                          sharding=sharding)
    cfg = engine.model.cfg
    for a in range(args.num_adapters):
        engine.register_adapter(f"a{a}", make_adapter(cfg, lora, seed=a + 1))
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        engine.add_request(Request(
            request_id=f"r{i}",
            prompt=list(map(int, rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(8, 64))))),
            user_id=f"u{i % 2}",
            adapter_id=f"a{i % args.num_adapters}" if args.num_adapters else None,
            sampling=SamplingParams(temperature=0.7, top_k=50,
                                    max_new_tokens=16)))
    metrics = engine.run()
    dt = time.time() - t0
    gen = sum(m.num_generated for m in metrics)
    snap = engine.metrics_snapshot()
    quant = ""
    if kv_quant is not None and engine.store.quantized:
        st = engine.store
        quant = (f", kv_quant={kv_quant.bits}bit "
                 f"({st.kv_fp16_bytes_per_block() / st.kv_bytes_per_block():.2f}x "
                 "capacity vs fp16)")
    mlora = ""
    if engine.adapters is not None:
        st = engine.adapters.stats
        mlora = (f", lora={args.num_adapters} adapters r{lora.rank} "
                 f"(hits={st.hits} misses={st.misses} evicts={st.evictions}, "
                 f"{engine.adapters.rented_pages} pages rented)")
    spec = ""
    if engine.spec_stats.steps:
        st = engine.spec_stats
        spec = (f", spec: acceptance={st.acceptance_rate:.2f} "
                f"tokens/step={st.tokens_per_step:.2f} steps={st.steps}"
                + (f" disabled@{st.disabled_at_step}"
                   if st.disabled_at_step is not None else ""))
    routes = ""
    if engine.runner is not None and engine.runner.steps:
        rr = engine.model.route_rows
        routes = (f", rows flash_prefill={rr['flash_prefill']} "
                  f"flash_attention={rr['flash_attention']}")
    tp = ""
    if sharding is not None:
        r = engine.paged_runner
        tp = (f", mesh=(data={args.dp}, model={args.tp}) "
              f"kv_sharded={r.kv_sharded} "
              f"dev_kv_bytes/block={r.device_kv_bytes_per_block()} "
              f"all_reduces/rank={r.mesh.model.all_reduces if r.tp else 0}")
    report = (f"{cfg.name} on {engine.device}: {len(metrics)} requests, {gen} tokens, "
              f"{gen/dt:.1f} tok/s, {engine.steps} steps "
              f"({engine.paged_steps} paged), "
              f"host_copy={snap['engine.host_copy_bytes']/1e6:.1f}MB, "
              f"kv_util_peak={snap['block_manager.peak_used']/snap['block_manager.num_blocks']:.2f}, "
              f"preempts={snap['engine.preemptions']}, "
              f"TTFT p50={np.median([m.ttft for m in metrics])*1e3:.0f}ms{routes}{quant}"
              f"{mlora}{spec}{tp}")
    streams = {rid: list(s.generated) for rid, s in engine.seqs.items()}
    if args.trace_out and (sharding is None or engine.paged_runner.mesh.rank == 0):
        device = torch.cuda.get_device_name(engine.device) \
            if engine.device.type == "cuda" else "cpu"
        path = write_chrome_trace(args.trace_out, engine.trace, metadata={
            "arch": args.arch, "backend": args.backend, "device": device})
        report += (f"\ntrace: {len(engine.trace.events)} events -> {path} "
                   f"(summarize with tools/trace_summary.py)")
    return report, streams


def serve_rank(args: argparse.Namespace):
    """One rank of ``--tp`` / ``--dp``: its mesh (the backend asked for, the
    rank's card or ``--device cpu``), then ``serve`` on it."""
    mesh = make_serving_mesh(args.dp, args.tp, backend=args.dist_backend,
                             device=None if args.device == "cuda" else args.device)
    if mesh.device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (args.tp * args.dp)))
    return serve(args, device=mesh.device,
                 sharding=ShardingConfig(model_axis=args.tp, data_axis=args.dp))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.tp * args.dp == 1:
        print(serve(args)[0])
        return
    ranks = spawn_ranks(serve_rank, args.tp * args.dp, args)
    differ = [r for r, (_, streams) in enumerate(ranks) if streams != ranks[0][1]]
    print(ranks[0][0])
    if differ:
        raise SystemExit(f"ranks {differ} generated other streams than rank 0")
    print(f"{len(ranks)} ranks over {args.dist_backend}: every rank's streams equal")


if __name__ == "__main__":
    main()
