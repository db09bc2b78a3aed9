#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  — CUDA present, card name and power limit, TF32 off;
  2. build   — nvcc builds the paged-attention kernel from csrc/;
  3. kernel  — the CUDA kernel vs its plain PyTorch version on the card:
               shape cases, poisoned slots, the olmo-1b decode shape, the
               extend fold, a zero-length row;
  4. timing  — the kernel at the olmo-1b decode shape beside its HBM
               bound, the plain version and SDPA over the same K/V;
  5. model   — olmo-1b at its published width, one decode_paged and one
               ragged extend_paged step, kernel vs plain attention logits;
  6. serve   — the serving engine (launch/serve.py's build_engine) at full
               width: 8 requests, greedy, kernel launch count checked.
Prints one ``{"kernels": [...]}`` line, then as the very last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import Request, SamplingParams, SchedulerConfig  # noqa: E402
from repro_torch.core.telemetry import StepTracer  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as kmod  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_chunked_ref, paged_attention_ref)
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# the kernel's wrapper and its launch count, held here so that phase 5's
# plain-attention patch of the module attribute does not hide them
KERNEL = kmod.paged_attention

# data-sheet HBM bandwidth and non-tensor-core fp32 rate, by card name
# (NVIDIA data sheets; the first matching substring wins)
CARDS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]
CASES = [  # B, KV, G, D, P, NB, NP — tests/test_kernels_paged.py:20-26
    (1, 1, 8, 64, 16, 8, 4), (2, 2, 4, 64, 16, 16, 4),
    (3, 4, 1, 32, 8, 16, 8), (2, 2, 5, 128, 32, 8, 2)]
# f32: summation order only. bf16: fp32 inside, one output rounding apart.
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# full-width logits, kernel vs plain attention, both bf16 end to end. The two
# sum in another order, so an attention output may round to the neighbouring
# bf16 value (2^-8 relative); every later bf16 rounding in 16 layers then
# diverges too. The logits are ~N(0, 1) (random weights, normalized final
# state against a d^-1/2-scaled tied embedding), so a relative drift of the
# final state of ~2% shows as ~0.1 at the largest of the B*C*V logits: the
# first run on the card measured 0.11 and 0.13. A wrong kernel (a dropped or
# extra position) moves logits by O(1).
MODEL_ATOL = 0.25
# olmo-1b decode shape timed in phase 4
OLMO = dict(B=8, KV=16, G=1, D=128, P=16, L=1024)
# torch.cuda._sleep cycles that hold the stream while timed calls are
# queued: ~0.2 s at the H100's clock
HOLD_CYCLES = 400_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def plain_attention():
    """Route the ops' kernel call to the plain version (CUDA tensors too),
    for the phase-5 yardstick only; the port itself has no such switch."""
    def plain(q, k, v, tables, lengths, *, scale):
        return paged_attention_ref(q, k, v, tables, lengths, scale=scale)
    return mock.patch.object(kmod, "paged_attention", plain)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device milliseconds of one ``fn`` call over ``reps`` calls,
    with CUDA events around each. A spin kernel holds the stream while the
    host queues all the calls, so the events time the device's work, not
    the host's launch overhead; the run fails if the host fell behind."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps + 1)]
    ev[0][0].record()
    torch.cuda._sleep(HOLD_CYCLES)
    ev[0][1].record()
    t0 = time.perf_counter()
    for a, b in ev[1:]:
        a.record()
        fn()
        b.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    hold_ms = ev[0][0].elapsed_time(ev[0][1])
    if queued_ms >= hold_ms:
        raise RuntimeError(f"timing: queueing {reps} calls took {queued_ms:.1f} ms, "
                           f"longer than the {hold_ms:.1f} ms hold")
    return statistics.median(a.elapsed_time(b) for a, b in ev[1:])


def inputs(seed, B, KV, G, D, P, NB, NP, dtype, lengths=None):
    """Random q/pages, per-row tables drawn without replacement, lengths."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.normal(size=(B, KV, G, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(KV, NB, P, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(KV, NB, P, D)).astype(np.float32))
    tables = np.stack([rng.choice(NB, size=NP, replace=False) for _ in range(B)])
    if lengths is None:
        lengths = rng.integers(1, NP * P + 1, size=(B,))
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.tensor(tables, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def check(name, got, want, atol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    ok = math.isfinite(err) and err <= atol
    log(f"  {name}: max_abs_err={err:.3g} (atol {atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def device_profile(label, fn) -> None:
    """Where one call's time goes: its wall time (host clock around a
    synchronized call, median of 3, profiler off), then one call under
    torch.profiler for the kernels' time by name on the device clock. The
    device's busy share is their sum over that wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_us = statistics.median(walls) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            launches += 1
    busy = sum(by_name.values())
    if not busy:
        log(f"  {label}: wall {wall_us / 1e3:.3f} ms; device time not measured "
            "(the profiler recorded no kernel)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {label}: wall {wall_us / 1e3:.3f} ms, {launches} device kernels, "
        f"busy {busy / 1e3:.3f} ms = {busy / wall_us:.1%} of wall; top: "
        + "; ".join(f"{n[:48]} {t / 1e3:.3f} ms" for n, t in top))


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    card = next((c for c in CARDS if c[0] in name), None)
    if card is None:
        raise RuntimeError(f"no data-sheet rates for {name!r}")
    log("[1 device] nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); rates of {card[0]}: "
        f"{card[1] / 1e12:g} TB/s HBM, {card[2] / 1e12:g} TFLOP/s fp32")
    return name, card


def phase_build():
    t0 = time.perf_counter()
    path, report = kmod.build()
    kmod._load()
    log(f"[2 build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernel():
    log("[3 kernel vs plain version on the card]")
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, t, ln = inputs(1, *case, dtype)
            D = case[3]
            check(f"case {case} {str(dtype)[6:]}",
                  KERNEL(q, k, v, t, ln, scale=D ** -0.5),
                  paged_attention_ref(q, k, v, t, ln, scale=D ** -0.5), ATOL[dtype])
    # poisoned slots: positions >= length hold +-1e6 and +-inf
    q, k, v, _, _ = inputs(2, 1, 2, 2, 32, 8, 8, 4, torch.float32)
    t = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32, device="cuda")
    ln = torch.tensor([13], dtype=torch.int32, device="cuda")
    clean = KERNEL(q, k, v, t, ln, scale=0.2)
    k2, v2 = k.clone(), v.clone()
    k2[:, 1, 5:], v2[:, 1, 5:] = 1e6, -1e6
    k2[:, 2:], v2[:, 2:] = float("inf"), float("-inf")
    check("poisoned slots", KERNEL(q, k2, v2, t, ln, scale=0.2),
          clean, 1e-6)
    check("poisoned vs plain", clean,
          paged_attention_ref(q, k, v, t, ln, scale=0.2), 1e-5)
    zero = KERNEL(q, k, v, t, torch.zeros_like(ln), scale=0.2)
    check("zero-length row", zero, torch.zeros_like(zero), 0.0)
    # the olmo-1b decode shape
    c = OLMO
    NP = c["L"] // c["P"]
    q, k, v, t, ln = inputs(3, c["B"], c["KV"], c["G"], c["D"], c["P"],
                            c["B"] * NP, NP, torch.bfloat16)
    check("olmo-1b decode shape bf16",
          KERNEL(q, k, v, t, ln, scale=c["D"] ** -0.5),
          paged_attention_ref(q, k, v, t, ln, scale=c["D"] ** -0.5),
          ATOL[torch.bfloat16])
    # the extend fold (prefill) vs the chunked oracle
    for dtype in (torch.float32, torch.bfloat16):
        B, C, KV, G, D, P, NB, NP = 3, 8, 2, 4, 64, 16, 32, 4
        q, k, v, t, _ = inputs(4, B, KV, G, D, P, NB, NP, dtype)
        qc = torch.randn(B, C, KV * G, D, generator=torch.Generator(
            device="cuda").manual_seed(4), device="cuda").to(dtype)
        ln = torch.tensor([0, P - 1, 2 * P], dtype=torch.int32, device="cuda")
        check(f"extend fold C={C} {str(dtype)[6:]}",
              ops.paged_attend_extend(qc, k, v, t, ln, scale=0.125),
              paged_attention_chunked_ref(qc.reshape(B, C, KV, G, D), k, v, t, ln,
                                          scale=0.125).reshape(B, C, KV * G, D),
              ATOL[dtype])
    torch.cuda.synchronize()


def phase_timing(card):
    c = OLMO
    B, KV, G, D, P, L = c["B"], c["KV"], c["G"], c["D"], c["P"], c["L"]
    NP = L // P
    q, k, v, t, ln = inputs(5, B, KV, G, D, P, B * NP, NP, torch.bfloat16,
                            lengths=[L] * B)
    scale = D ** -0.5
    out = KERNEL(q, k, v, t, ln, scale=scale)
    err = check("timed shape vs plain", out,
                paged_attention_ref(q, k, v, t, ln, scale=scale), ATOL[torch.bfloat16])
    ms = cuda_ms(lambda: KERNEL(q, k, v, t, ln, scale=scale))
    plain_ms = cuda_ms(lambda: paged_attention_ref(q, k, v, t, ln, scale=scale))
    # library yardstick: SDPA over the same K/V gathered to (B, H, L, D)
    kg = k[:, t.long()].transpose(0, 1).reshape(B, KV, L, D)
    vg = v[:, t.long()].transpose(0, 1).reshape(B, KV, L, D)
    qs = q.reshape(B, KV * G, 1, D)
    check("SDPA vs kernel", F.scaled_dot_product_attention(qs, kg, vg, scale=scale),
          out.reshape(B, KV * G, 1, D), ATOL[torch.bfloat16])
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, scale=scale))
    isz = q.element_size()
    kv_bytes = B * KV * math.ceil(L / P) * P * D * 2 * isz
    nbytes = kv_bytes + 2 * q.numel() * isz + t.numel() * 4 + ln.numel() * 4
    flops = 4 * B * KV * G * L * D  # q.k and p.v, fp32 on the CUDA cores
    bytes_ms, ops_ms = nbytes / card[1] * 1e3, flops / card[2] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[4 timing] paged_attention B={B} KV={KV} G={G} D={D} P={P} L={L} bf16: "
        f"kernel {ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
        f"({kv_bytes / 1e6:.1f} MB K/V / {card[1] / 1e12:g} TB/s; ops {ops_ms * 1e3:.2f} us), "
        f"plain {plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us; "
        f"{bound_ms / ms:.1%} of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                max_abs_err=err)


def phase_model():
    """Full published width; one decode and one ragged extend step, kernel
    vs plain attention on the same inputs and the same page pools."""
    cfg = configs.get_config("olmo-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[5 model] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{nparam / 1e9:.2f} B params bf16, built in {time.perf_counter() - t0:.1f} s")
    P, NP, B = 16, 64, 4
    rng = np.random.default_rng(6)
    NB = B * NP + 1  # block 0 is the scratch page
    pages = model.init_pages(NB, P)
    g = torch.Generator(device="cuda").manual_seed(6)
    for pg in pages:
        for x in pg.values():
            x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
    tables = torch.tensor(rng.permutation(np.arange(1, NB))[: B * NP].reshape(B, NP),
                          dtype=torch.int64, device="cuda")

    def run(step, *args):
        fresh = [{n: x.clone() for n, x in pg.items()} for pg in pages]
        before = KERNEL.launches
        logits = step(params, args[0], fresh, tables, *args[1:])[0]
        torch.cuda.synchronize()
        return logits.float(), KERNEL.launches - before

    tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, 1)), device="cuda")
    lengths = torch.tensor([100, 300, 517, 1000], dtype=torch.int32, device="cuda")
    lk, n = run(model.decode_paged, tok, lengths)
    assert n == cfg.num_layers, n
    with plain_attention():
        lp, _ = run(model.decode_paged, tok, lengths)
    assert lk.shape == (B, 1, cfg.vocab_size) and torch.isfinite(lk).all()
    check("decode_paged logits, kernel vs plain", lk, lp, MODEL_ATOL)
    C = 64
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, C)), device="cuda")
    lengths = torch.tensor([0, 100, 513, 300], dtype=torch.int32, device="cuda")
    chunk_lens = torch.tensor([64, 17, 1, 40], dtype=torch.int32, device="cuda")
    lk, n = run(model.extend_paged, tok, lengths, chunk_lens, 0)
    assert n == cfg.num_layers, n
    with plain_attention():
        lp, _ = run(model.extend_paged, tok, lengths, chunk_lens, 0)
    real = torch.arange(C, device="cuda")[None, :] < chunk_lens[:, None]
    assert torch.isfinite(lk[real]).all()
    check("ragged extend_paged logits, kernel vs plain", lk[real], lp[real],
          MODEL_ATOL)
    # where a full-width step's time goes (the kernel path; writes land in
    # the same slots on every call)
    tok1 = tok[:, :1].contiguous()
    lengths1 = torch.tensor([100, 300, 517, 1000], dtype=torch.int32, device="cuda")
    device_profile(f"decode_paged B={B}", lambda: model.decode_paged(
        params, tok1, pages, tables, lengths1))
    device_profile(f"extend_paged B={B} C={C}", lambda: model.extend_paged(
        params, tok, pages, tables, lengths, chunk_lens, 0))
    del model, params, pages
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def phase_serve():
    engine = build_engine(
        "olmo-1b", debug=False, device="cuda", max_model_len=1024,
        num_blocks=640, block_size=16,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=256,
                                  prefill_chunk=64))
    cfg = engine.model.cfg
    rng = np.random.default_rng(7)
    for i in range(8):
        n = int(rng.integers(128, 513))
        engine.add_request(Request(
            request_id=f"r{i}", prompt=[int(x) for x in rng.integers(2, cfg.vocab_size, n)],
            sampling=SamplingParams(temperature=0.0, max_new_tokens=32)))
    KERNEL.launches = 0  # the main path's count starts here
    t0 = time.perf_counter()
    metrics = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = KERNEL.launches
    gen = sum(m.num_generated for m in metrics)
    assert len(metrics) == 8 and all(m.num_generated == 32 for m in metrics), \
        [m.num_generated for m in metrics]
    assert all(0 <= tok < cfg.vocab_size for s in engine.seqs.values()
               for tok in s.generated)
    assert engine.host_copy_bytes == 0, engine.host_copy_bytes
    assert engine.paged_steps == engine.steps > 0
    assert launches == cfg.num_layers * engine.paged_steps, \
        (launches, engine.paged_steps)
    ttft = statistics.median(m.ttft for m in metrics)
    prompt = sum(m.num_prompt for m in metrics)
    log(f"[6 serve] {cfg.name} full width: 8 requests, {prompt} prompt + {gen} "
        f"generated tokens in {dt:.2f} s = {gen / dt:.1f} generated tok/s, "
        f"TTFT p50 {ttft * 1e3:.0f} ms, {engine.steps} steps "
        f"({engine.paged_steps} paged), {launches} kernel launches "
        f"(= {cfg.num_layers} x steps), host_copy_bytes 0")
    # the same traffic again (fresh prompts), traced: host-clock spans per
    # engine layer; the run above, untraced, gives the end-to-end numbers
    tracer = StepTracer()
    engine.trace = engine.paged_runner.trace = tracer
    for i in range(8):
        n = int(rng.integers(128, 513))
        engine.add_request(Request(
            request_id=f"t{i}", prompt=[int(x) for x in rng.integers(2, cfg.vocab_size, n)],
            sampling=SamplingParams(temperature=0.0, max_new_tokens=32)))
    steps0, t0 = engine.steps, time.perf_counter()
    traced = engine.run()[8:]
    dt_traced = time.perf_counter() - t0
    spans = {}
    for e in tracer.events:
        if e.dur is not None:
            key = e.name if e.name != "dispatch" else f"dispatch[{e.args['phase']}]"
            n_, us = spans.get(key, (0, 0.0))
            spans[key] = (n_ + 1, us + e.dur)
    log(f"  traced rerun: {sum(m.num_generated for m in traced)} generated tokens in "
        f"{dt_traced:.2f} s over {engine.steps - steps0} steps; host-clock spans: "
        + ", ".join(f"{k} {n_}x {us / 1e3:.0f} ms"
                    for k, (n_, us) in sorted(spans.items(), key=lambda kv: -kv[1][1])))
    return launches


def main() -> None:
    name, card = phase_device()
    phase_build()
    phase_kernel()
    timing = phase_timing(card)
    phase_model()
    launches = phase_serve()
    src = os.path.relpath(kmod.SOURCE, ROOT)
    kernels = [dict(name="paged_attention", route="cuda", source=src,
                    replaces="src/repro/kernels/paged_attention/paged_attention.py:73",
                    launches=launches, max_abs_err=timing["max_abs_err"],
                    ms=timing["ms"], plain_ms=timing["plain_ms"],
                    bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
                    library_ms=timing["library_ms"])]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
