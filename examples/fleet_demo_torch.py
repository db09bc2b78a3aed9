"""Multi-instance serving fleet with live migration on the PyTorch port
(survey §V.A, Llumnix). The twin of ``examples/fleet_demo.py``: the same
seeds, engine settings, traffic and report, plus ``--device`` (``cuda`` by
default; raises where CUDA is absent, ``--device cpu`` runs on the CPU).

    python examples/fleet_demo_torch.py [--device cpu]

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
from repro_torch.core.fleet import ServingFleet  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def run(cfg, device) -> dict:
    model = build_model(cfg, device=device)
    params = model.init(0, max_seq=256)
    fleet = ServingFleet(model, params, instances=2,
                         engine_cfg=EngineConfig(
                             block_size=8, num_blocks=96, num_state_slots=16,
                             max_model_len=128, enable_prefix_cache=False,
                             device=device,
                             scheduler=SchedulerConfig(max_batch_slots=4,
                                                       max_batched_tokens=64,
                                                       prefill_chunk=16)),
                         rebalance_threshold=0.1)
    rng = np.random.default_rng(0)
    # adversarial arrival: everything lands on instance 0 (a hot shard)
    for i in range(8):
        prompt = list(map(int, rng.integers(2, cfg.vocab_size,
                                            size=int(rng.integers(16, 48)))))
        fleet.engines[0].add_request(Request(
            request_id=f"r{i}", prompt=prompt,
            sampling=SamplingParams(max_new_tokens=12)))
    loads = [round(fleet._load(e), 2) for e in fleet.engines]
    print(f"before: loads = {loads}")
    metrics = fleet.run()
    print(f"served {len(metrics)} requests")
    print(f"migrations: {fleet.stats.migrations} "
          f"({fleet.stats.migrated_bytes/2**20:.2f} MiB KV moved live)")
    per_engine = [len(e.finished) for e in fleet.engines]
    print(f"requests finished per instance: {per_engine} "
          f"(rebalancer spread the hot shard)")
    return dict(loads_before=loads, served=len(metrics), migrations=fleet.stats.migrations,
                migrated_bytes=fleet.stats.migrated_bytes, per_instance=per_engine,
                streams={rid: list(s.generated) for rid, s in fleet.seqs.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(configs.smoke_config("olmo-1b"), args.device)


if __name__ == "__main__":
    main()
