"""Serving entry point of the PyTorch port: the engine loop over one architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --no-debug --requests 8          # full published width, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 2                     # smoke width on the CPU

``--debug`` (the default) serves the reduced smoke config, ``--no-debug``
the published one. ``--device`` defaults to ``cuda``; there is no CPU
fallback. Weights are random, drawn from a seeded ``torch.Generator``.
``build_engine`` is the construction path ``chip_smoke.py`` drives too.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.core import (EngineConfig, LLMEngine, Request, SamplingParams,
                              SchedulerConfig)
from repro_torch.models import build_model


def build_engine(arch: str, *, debug: bool = True, device: str = "cuda",
                 backend: str = "auto", policy: str = "fcfs", seed: int = 0,
                 **engine_kw) -> LLMEngine:
    """Model (smoke or published config) + random weights + engine.
    ``engine_kw`` overrides the serving defaults below (EngineConfig
    fields, e.g. ``max_model_len`` or a ``scheduler``)."""
    cfg = configs.smoke_config(arch) if debug else configs.get_config(arch)
    model = build_model(cfg, device=device)
    params = model.init(seed)
    kw = dict(block_size=16, num_blocks=512, max_model_len=256,
              execution_backend=backend, device=device, seed=seed,
              scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=128,
                                        prefill_chunk=32, policy=policy))
    kw.update(engine_kw)
    return LLMEngine(model, params, EngineConfig(**kw))


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "vtc", "qoe"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "gathered", "paged", "speculative"],
                    help="execution backend (only auto/paged are ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and kernels run on")
    ap.add_argument("--debug", action=argparse.BooleanOptionalAction,
                    default=True, help="smoke config (--no-debug: published)")
    args = ap.parse_args(argv)

    engine = build_engine(args.arch, debug=args.debug, device=args.device,
                          backend=args.backend, policy=args.policy)
    cfg = engine.model.cfg
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        engine.add_request(Request(
            request_id=f"r{i}",
            prompt=list(map(int, rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(8, 64))))),
            user_id=f"u{i % 2}",
            sampling=SamplingParams(temperature=0.7, top_k=50,
                                    max_new_tokens=16)))
    metrics = engine.run()
    dt = time.time() - t0
    gen = sum(m.num_generated for m in metrics)
    snap = engine.metrics_snapshot()
    print(f"{cfg.name} on {engine.device}: {len(metrics)} requests, {gen} tokens, "
          f"{gen/dt:.1f} tok/s, {engine.steps} steps "
          f"({engine.paged_steps} paged), "
          f"host_copy={snap['engine.host_copy_bytes']/1e6:.1f}MB, "
          f"kv_util_peak={snap['block_manager.peak_used']/snap['block_manager.num_blocks']:.2f}, "
          f"preempts={snap['engine.preemptions']}, "
          f"TTFT p50={np.median([m.ttft for m in metrics])*1e3:.0f}ms")


if __name__ == "__main__":
    main()
