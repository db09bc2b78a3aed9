"""MoE serving on the PyTorch port (survey §VI.B): serve a DeepSeek-V3-family
model (MLA + shared/routed experts) and report router/expert statistics.
The twin of ``examples/moe_serving.py``: the same seeds, engine settings,
traffic and report, plus ``--device`` (``cuda`` by default; raises where
CUDA is absent, ``--device cpu`` runs on the CPU).

    python examples/moe_serving_torch.py [--device cpu]

``run(cfg, device)`` holds the body, so a caller can pass a config at its
published width where the command line takes the reduced one.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402


def run(cfg, device) -> dict:
    model = build_model(cfg, device=device)
    params = model.init(0, max_seq=256)
    print(f"{cfg.name}: {cfg.num_experts} experts top-{cfg.top_k} "
          f"+ {cfg.num_shared_experts} shared, MLA rank={cfg.kv_lora_rank}")

    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=128, num_state_slots=8, max_model_len=128,
        device=device,
        scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=64,
                                  prefill_chunk=16)))
    rng = np.random.default_rng(0)
    for i in range(6):
        engine.add_request(Request(
            request_id=f"r{i}",
            prompt=list(map(int, rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(10, 40))))),
            sampling=SamplingParams(max_new_tokens=8)))
    engine.run()
    print(f"served {len(engine.finished)} requests in {engine.steps} steps")

    # router statistics on a probe batch (load balance — the §VI.B concern):
    # the last MoE layer's router (the port keeps one dict per layer)
    moe_params = [layer["ff"] for layer in params["layers"]
                  if "router" in layer.get("ff", {})][-1]
    probe = torch.as_tensor(rng.normal(size=(512, cfg.d_model)), dtype=model.dtype,
                            device=model.device)
    _, experts, aux = moe_mod.route(moe_params, cfg, probe)
    counts = torch.bincount(experts.reshape(-1).long(), minlength=cfg.num_experts)
    print(f"router load (tokens per expert over 512 probes x top{cfg.top_k}): "
          f"{counts.tolist()}")
    print(f"balance aux loss: {float(aux):.3f} (1.0 = perfectly balanced)")
    latent = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    expanded = cfg.num_heads * (cfg.head_dim + 32)
    print("MLA KV cache per token:",
          f"{latent} floats (latent) vs",
          f"{expanded} floats expanded "
          f"(~{expanded // latent}x saving)")
    return dict(name=cfg.name, experts=cfg.num_experts, top_k=cfg.top_k,
                shared=cfg.num_shared_experts, kv_lora_rank=cfg.kv_lora_rank,
                served=len(engine.finished), steps=engine.steps,
                router_load=counts.tolist(), aux=float(aux), mla_latent=latent,
                mla_expanded=expanded, mla_saving=expanded // latent,
                streams={rid: list(s.generated) for rid, s in engine.seqs.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(configs.smoke_config("deepseek-v3-671b"), args.device)


if __name__ == "__main__":
    main()
