"""End-to-end serving on the PyTorch port: batched requests through the full
stack — continuous batching, chunked prefill, paged KV with prefix cache,
fairness accounting, QoE metrics, token-level state commit for preemption
recovery. The twin of ``examples/serve_batch.py``: the same flags, seeds,
engine settings, traffic and report, plus ``--device`` (``cuda`` by
default; raises where CUDA is absent, ``--device cpu`` runs on the CPU).

    python examples/serve_batch_torch.py --arch qwen2.5-32b --requests 16 [--device cpu]

``run(cfg, device, ...)`` holds the body, so a caller can pass a config at
its published width where the command line takes the reduced one.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import ServingStateLog  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.models import build_model  # noqa: E402

# a log of its own: the JAX example writes /tmp/repro_serving_state.jsonl
STATE_LOG = os.path.join(tempfile.gettempdir(), "repro_torch_serving_state.jsonl")


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type.upper()


def run(cfg, device, requests=16, policy="fcfs", state_log=STATE_LOG) -> dict:
    model = build_model(cfg, device=device)
    params = model.init(0, max_seq=512)
    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=512, num_state_slots=64, max_model_len=256,
        device=device,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=128,
                                  prefill_chunk=32, policy=policy)))
    log = ServingStateLog(state_log)

    rng = np.random.default_rng(0)
    system_prompt = list(map(int, rng.integers(2, cfg.vocab_size, size=48)))
    t0 = time.time()
    for i in range(requests):
        user_part = list(map(int, rng.integers(
            2, cfg.vocab_size, size=int(rng.integers(8, 48)))))
        engine.add_request(Request(
            request_id=f"req-{i}",
            prompt=system_prompt + user_part,  # shared prefix -> cache hits
            user_id=f"user-{i % 3}",
            sampling=SamplingParams(temperature=0.7, top_k=50,
                                    max_new_tokens=int(rng.integers(8, 24)))))

    tokens = 0
    while engine.scheduler.has_work():
        tokens += engine.step()
        for seq in engine.seqs.values():
            if seq.generated:
                log.commit(seq.request_id, seq.request.prompt, seq.generated)
    dt = time.time() - t0

    ms = engine.finished
    gen = sum(m.num_generated for m in ms)
    out = dict(requests=requests, tokens=gen, seconds=dt, tok_s=gen / dt,
               steps=engine.steps, policy=policy,
               ttft_p50=float(np.median([m.ttft for m in ms])),
               ttft_p99=float(np.percentile([m.ttft for m in ms], 99)),
               tpot_p50=float(np.median([m.tpot for m in ms])),
               qoe_mean=float(np.mean([m.qoe for m in ms])))
    print(f"\n=== {requests} requests, {gen} tokens in {dt:.1f}s "
          f"({gen/dt:.1f} tok/s on {device_name(model.device)}, {engine.steps} engine steps) ===")
    print(f"policy={policy}")
    print(f"TTFT   p50={out['ttft_p50']*1e3:.0f}ms p99={out['ttft_p99']*1e3:.0f}ms")
    print(f"TPOT   p50={out['tpot_p50']*1e3:.0f}ms")
    print(f"QoE    mean={out['qoe_mean']:.2f}")
    if engine.prefix_cache:
        st = engine.prefix_cache.stats
        out.update(hit_rate=st.hit_rate, hit_tokens=sum(m.prefix_hit_tokens for m in ms))
        print(f"prefix cache: hit_rate={st.hit_rate:.2f} "
              f"hit_tokens={out['hit_tokens']}")
    out.update(peak=engine.bm.stats.peak_used, num_blocks=engine.bm.num_blocks,
               cow=engine.bm.stats.cow_copies, fairness_gap=engine.vtc.fairness_gap(),
               recoverable=len(log.restore()))
    print(f"blocks: peak={out['peak']}/{out['num_blocks']} cow={out['cow']}")
    print(f"fairness gap (VTC tokens): {out['fairness_gap']:.0f}")
    print(f"state log: {state_log} ({out['recoverable']} recoverable)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b", choices=list(configs.ARCHS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--policy", default="fcfs", choices=["fcfs", "vtc", "qoe"])
    ap.add_argument("--state-log", default=STATE_LOG)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(configs.smoke_config(args.arch), args.device, requests=args.requests,
               policy=args.policy, state_log=args.state_log)


if __name__ == "__main__":
    main()
