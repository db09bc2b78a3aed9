"""Quickstart on the PyTorch port: build a model, generate text through the
serving engine. The twin of ``examples/quickstart.py``: the same flags,
seeds, engine settings and report, plus ``--device`` (``cuda`` by default;
raises where CUDA is absent, ``--device cpu`` runs on the CPU).

    python examples/quickstart_torch.py [--arch gemma-2b] [--device cpu]

``run(cfg, device, ...)`` holds the body, so a caller can pass a config at
its published width (``configs.get_config``) where the command line takes
the reduced one.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core import (EngineConfig, LLMEngine, Request,  # noqa: E402
                              SamplingParams, SchedulerConfig)
from repro_torch.data import ByteTokenizer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def run(cfg, device, prompt="the quick brown fox", max_new_tokens=16) -> dict:
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"family={cfg.family}")
    model = build_model(cfg, device=device)
    params = model.init(0, max_seq=256)

    tok = ByteTokenizer()
    prompt_ids = [t % cfg.vocab_size for t in tok.encode(prompt)]

    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=128, num_state_slots=8, max_model_len=256,
        device=device,
        scheduler=SchedulerConfig(max_batch_slots=2, max_batched_tokens=64,
                                  prefill_chunk=32)))
    engine.add_request(Request(
        request_id="demo", prompt=prompt_ids,
        sampling=SamplingParams(temperature=0.8, top_k=40,
                                max_new_tokens=max_new_tokens)))
    metrics = engine.run()
    seq = engine.seqs["demo"]
    print("prompt tokens:", prompt_ids)
    print("generated tokens:", seq.generated)
    print("decoded (untrained model -> noise):",
          repr(tok.decode(seq.generated)))
    m = metrics[0]
    print(f"ttft={m.ttft*1e3:.1f}ms tpot={m.tpot*1e3:.1f}ms qoe={m.qoe:.2f}")
    return dict(arch=cfg.name, layers=cfg.num_layers, d=cfg.d_model, family=cfg.family,
                prompt_tokens=prompt_ids, generated=list(seq.generated),
                ttft=m.ttft, tpot=m.tpot, qoe=m.qoe)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list(configs.ARCHS))
    ap.add_argument("--prompt", default="the quick brown fox")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the reduced config of the chosen architecture family
    return run(configs.smoke_config(args.arch), args.device, prompt=args.prompt,
               max_new_tokens=args.max_new_tokens)


if __name__ == "__main__":
    main()
