"""Disaggregated prefill/decode on the PyTorch port (survey §IV.B): two
engine instances with explicit KV migration. The twin of
``examples/disagg_demo.py``: the same seeds, engine settings, traffic and
report, plus ``--device`` (``cuda`` by default; raises where CUDA is
absent, ``--device cpu`` runs on the CPU).

    python examples/disagg_demo_torch.py [--device cpu]

``run(cfg, device)`` holds the body, so a caller can pass a config at its
published width where the command line takes the reduced one.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import (EngineConfig, Request, SamplingParams,  # noqa: E402
                              SchedulerConfig)
from repro_torch.core.disagg import DisaggregatedServer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def run(cfg, device) -> dict:
    model = build_model(cfg, device=device)
    params = model.init(0, max_seq=512)
    mk = lambda: EngineConfig(  # noqa: E731
        block_size=16, num_blocks=256, num_state_slots=16, max_model_len=256,
        enable_prefix_cache=False, device=device,
        scheduler=SchedulerConfig(max_batch_slots=4, max_batched_tokens=96,
                                  prefill_chunk=48))
    srv = DisaggregatedServer(model, params, prefill_cfg=mk(), decode_cfg=mk())
    rng = np.random.default_rng(0)
    for i in range(8):
        srv.add_request(Request(
            request_id=f"r{i}",
            prompt=list(map(int, rng.integers(2, cfg.vocab_size,
                                              size=int(rng.integers(40, 120))))),
            sampling=SamplingParams(max_new_tokens=12)))
    metrics = srv.run()
    print(f"finished={len(metrics)} migrated={srv.stats.migrated} "
          f"kv_transfer={srv.stats.transfer_bytes/2**20:.1f} MiB")
    print(f"prefill-instance steps: {srv.prefill_engine.steps}, "
          f"decode-instance steps: {srv.decode_engine.steps}")
    ttfts = sorted(m.ttft for m in metrics)
    print(f"TTFT p50={ttfts[len(ttfts)//2]*1e3:.0f}ms (prefill instance is "
          f"never blocked behind decode batches)")
    return dict(finished=len(metrics), migrated=srv.stats.migrated,
                transfer_bytes=srv.stats.transfer_bytes,
                prefill_steps=srv.prefill_engine.steps,
                decode_steps=srv.decode_engine.steps, ttft_p50=ttfts[len(ttfts) // 2],
                streams={rid: list(s.generated) for rid, s in srv.seqs.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(configs.smoke_config("starcoder2-3b"), args.device)


if __name__ == "__main__":
    main()
