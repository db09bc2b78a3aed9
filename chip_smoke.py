#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device  — CUDA present, card name and power limit, TF32 off;
  2. build   — nvcc builds the five kernel libraries from csrc/, one nvcc
               per source, all at once; ptxas registers and spills of the
               paged attention mma kernels (fp and KIVI pages), their split-K
               merges and the wgmma flash prefill, and of every KIVI pack and
               unpack instance (a spill fails the run); the KIVI mma kernel's
               dynamic shared memory;
  3. kernel  — every CUDA kernel vs its plain PyTorch version on the card:
               paged attention over fp pages (fp32 and bf16 shape cases,
               poisoned slots, the olmo-1b decode shape, chunked extend by
               the fold (fp32) and natively (bf16), a zero-length row; the
               bf16 / f16 mma kernel at forced splits 1, 2, 7 and the
               planned split over the shape cases, G 5 and 8 at D 256,
               native extend with ragged chunks and rows past the table,
               the olmo-1b extend layer, +-inf / 1e6 in dead slots for
               decode and extend, zero-length rows), over KIVI pages
               (shape cases x bits x dtypes, poisoned slots, tail-only and
               pages-only rows, extend, the olmo-1b decode shape; the bf16 /
               f16 mma route at forced splits 1, 2, 7 and the planned split,
               native chunked extend with ragged chunk starts against the
               chunked oracle, poisoned dead slots bit-equal to the clean
               run, a row with nothing valid), the pack / unpack
               (byte-equal: f32 / bf16 / f16 pages x C 32-256 and 48 x
               axis, f32 and f16 planes, P 4-32, NP 1-4097, .5 ties and
               extreme ranges that reach the division; every unpack
               instance), the gathered backend's KIVI window at
               starcoder2-3b's heads (packed and still-filling blocks,
               dequantized by the unpack kernel: bit-equal to the plain
               version and to the store's host dequantization),
               the LoRA bgmv (shape cases, ranks 4-64, ragged Din / Dout,
               olmo-1b's three adapter sites; null-slot rows exactly 0;
               the fused q/k/v launch at olmo-1b's, qwen2.5-32b's and
               gemma-2b's widths, C = 1, 3, 17, 64, with and without bases:
               the epilogue bit-equal to PyTorch's base + the kernel's
               delta, null-slot rows bit-equal to base + 0), and the causal
               flash prefill (shape cases x f32 / bf16 / f16,
               starcoder2-3b's heads with and without a binding window,
               ragged S, group sizes 1-12, llama4-scout's and
               jamba-v0.1-52b's fresh chunks, causality, strided
               model-layout inputs); the speculative verify's chunks (C = 2,
               4, 5) through the model-layout ops at olmo-1b's, qwen2.5-32b's
               and gemma-2b's decode heads, over fp pages (native chunked
               path) and over 8-bit KIVI pages with T = P + C tails;
  4. timing  — each kernel at the olmo-1b serving shape beside its bound,
               its plain version and, where one exists, the PyTorch calls
               computing the same function: paged_attention also at
               qwen2.5-32b's and gemma-2b's decode heads and the olmo-1b
               ragged extend layer, with a sweep of forced split counts;
               paged_attention_quant at the same four shapes over 8-bit
               pages (the KIVI extend layer's tail_start = starts // 16 *
               16), beside the CUDA-core kernel that served them before
               and a sweep of forced split counts; the KIVI pack at the
               serve's pack shapes (f32 pages, and the serve's bf16 pages
               with f16 planes) and the unpack into bf16 and f32 (beside
               torch.addcmul), from HBM, by CUDA events and by the
               profiler's device clock; bgmv at olmo-1b's w1
               site and its fused q/k/v launch (bases read and written),
               decode and prefill;
               flash_prefill at starcoder2-3b's S=2048, S=8192 under its
               4096 window, and the serve's fresh B=2, S=512 chunk;
  5. model   — olmo-1b at its published width, decode_paged and ragged
               extend_paged over fp pages and over KIVI pages, kernel vs
               plain attention logits, each step profiled (the paged mma
               kernels' and the merges' share of busy time), and one
               verify_paged over C = 5 against 5 decode_paged steps, both
               on the kernel, over fp and KIVI pages; then with LoRA
               adapters (kernel vs
               plain bgmv, the null-slot row equal to the LoRA-free step);
               starcoder2-3b at its published width, gathered extend steps
               (a fresh batch, a mixed fresh/continuation batch), kernel vs
               plain flash_prefill logits, profiled; llama4-scout at its
               published width cut to one interleave block (3 chunked + 1
               global NoPE layer, 16 experts top-1 + a shared one), the
               same two kinds of gathered step over 8448-slot windows (a
               continuation row across the 8192-token chunk boundary),
               kernel vs plain flash_prefill logits gated in f32, profiled
               with the MoE's share; a chunked layer's queries past the
               boundary bit-equal under noise in the earlier chunk;
               moe_apply vs its dense oracle moe_dense_ref in f32, and one
               MoE layer timed at decode (T=8) and prefill (T=512) beside
               its bytes bound and moe_dense_ref's time; deepseek-v3 at its
               published width cut to one dense and one MoE MLA layer (256
               experts top-8 + a shared one), three gathered steps over
               1024-slot latent windows (fresh B=2 C=256, mixed, decode
               B=8), finite logits, profiled with the MoE's and the MLA
               attention's shares; mla_decode vs mla_extend and moe_apply
               vs moe_dense_ref (T=8) in f32; jamba-v0.1-52b at its
               published width cut to one block (7 Mamba + 1 attention
               layer, 4 MoE feed-forwards of 16 experts top-2), a fresh
               B=2 C=256 and a decode B=8 step, profiled with the Mamba
               layers' and the MoE's shares, flash_prefill once per fresh
               step; one Mamba layer in f32 fed in chunks (37 + 91 + 1)
               against whole; xlstm-1.3b whole (48 layers), C=256
               (chunkwise mLSTM), C=200 (recurrence) and decode B=4 steps;
               one mLSTM layer in f32, chunkwise against the recurrence;
  6. serve   — the serving engine (launch/serve.py's build_engine) at full
               width: 8 requests, greedy, kernel launch counts checked;
               then the same traffic with KIVI 8-bit pages (the quantized
               kernel's launches split into decode and extend steps, the
               pack's round trip bytes held to their formula, the traced
               rerun's writeback span), and
               with 4 LoRA adapters over a 2-slot store (faults and
               evictions; bgmv launches = 4 x 16 x steps);
               then speculative decoding at k = 4 on the same traffic:
               self-speculation over fp pages (traced rerun: draft_catchup,
               spec_propose, spec_verify spans), a hostile draft (olmo-1b
               at another seed) that trips auto-disable, self-speculation
               over KIVI 8-bit pages and with 4 LoRA adapters over 2 slots,
               each kernel's launches held to a formula over the dispatch
               counts, speculative steps and draft catch-up calls;
               then starcoder2-3b on the gathered backend (flash_prefill
               launches = 30 x the steps holding a fresh row), then the
               llama4-scout block on it (flash_prefill launches = 4 x the
               steps holding a fresh row), then starcoder2-3b with KIVI
               8-bit pages on it (dequantize_pages = 2 x steps: the window
               dequantized on the card; quantize_pages = 2 x the rows
               whose chunk fills a page; the upload against the fp
               window; traced rerun), the deepseek block on it (no kernel,
               every row plain, host_copy_bytes = its formula) and again
               with kv_quant (the latents' round trip), the Jamba block
               (8 state slots; flash_prefill = the dispatches holding a
               fresh row; host_copy_bytes = windows, written tokens and
               each row's state slot both ways) and again with KIVI 8-bit
               attention pages (dequantize_pages = 2 per dispatch,
               quantize_pages = 2 per filling row), xlstm-1.3b (4 slots:
               host_copy_bytes = 2 x 706 511 616 B a row), and the f32
               smoke twins (deepseek; starcoder2-3b with KIVI pages; jamba
               with fp and KIVI pages; xlstm): the card's greedy streams
               equal the CPU's; a recycled state slot's stream equals a
               fresh engine's. Each traced rerun runs a second
               engine built with ``TelemetryConfig()`` on the same model,
               writes its Chrome trace under build/ and prints
               tools/trace_summary.py's decode roofline fraction (live
               tokens/s against launch/roofline.py's bound on this card);
  7. disagg  — olmo-1b at full width, two engines on one model: the 8-request
               traffic through a DisaggregatedServer over fp pages (7a) and
               KIVI 8-bit pages (7c): 8 migrations and their bytes, no decode
               chunk on the prefill engine and no chunk longer than 1 on the
               decode engine, launches = 16 x both engines' paged steps, the
               migrated blocks byte-equal in the decode engine's device
               mirror after its next sync; bench_disagg.py's interference
               traffic colocated and disaggregated (7b: no foreground token
               from a step holding another sequence's prefill chunk when
               disaggregated); the f32 model's disaggregated streams equal
               to a colocated engine's (7d);
  8. fleet   — a 2-instance ServingFleet on one olmo-1b, LoRA rank 8 x 4
               adapters over 2 slots, all 8 requests on instance 0:
               rebalancing migrations and their bytes, an adapter-bound
               sequence served on its destination with the adapter faulted
               in, bgmv launches = 4 x 16 x both instances' paged steps; in
               f32 the streams equal one LoRA engine's that never migrates;
  9. modality — run after phase 6's last serve: whisper-base whole on the
               gathered backend (8 requests with 1500 random audio frames
               each, prompts of 16-64 tokens, 32 greedy tokens; the encoder
               on each first chunk, 18.4 MB of cross K/V a state slot
               through the host every dispatch; flash_prefill = 6 x the
               dispatches holding a fresh row, at D = 64) and internvl2-2b
               at published width on auto (8 requests with 256 random image
               rows ahead of 128-512 tokens, 32 greedy tokens: the image
               chunks gathered in groups of their own, flash_prefill = 24 x
               those, every other dispatch paged, paged_attention = 24 x
               those at G = 2, no prefix-cache lookup); flash_prefill and
               paged_attention held against their plain versions at every
               shape the serves gave them, the serves' most common fresh
               shapes timed, a decode step of each profiled; the f32 smoke
               twins of both families with extras (card streams equal the
               CPU's).
Prints one ``{"kernels": [...]}`` line, then as the very last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
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
from repro_torch.core import (BlockManager, EngineConfig, LLMEngine,  # noqa: E402
                              QuantConfig, Request, SamplingParams, SchedulerConfig,
                              SpeculativeConfig, TelemetryConfig, write_chrome_trace)
from repro_torch.core.disagg import DisaggregatedServer  # noqa: E402
from repro_torch.core.fleet import ServingFleet  # noqa: E402
from repro_torch.core.lora import LoRAConfig, PagedAdapterStore, make_adapter  # noqa: E402
from repro_torch.core.executor import state as state_mod  # noqa: E402
from repro_torch.core.executor.gathered import dequantize_window  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fmod  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_prefill_ref  # noqa: E402
from repro_torch.kernels.kv_quant import kv_quant as kvmod  # noqa: E402
from repro_torch.kernels.kv_quant.ref import (  # noqa: E402
    dequantize_pages_ref, quantize_pages_ref)
from repro_torch.kernels.lora import bgmv as bgmod  # noqa: E402
from repro_torch.kernels.lora.ref import bgmv_add_ref, bgmv_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as kmod  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_quant as qmod  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_chunked_quant_ref, paged_attention_chunked_ref,
    paged_attention_quant_ref, paged_attention_ref)
from repro_torch.launch.roofline import card_for  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.model import cache_leaf_shapes  # noqa: E402

# the kernels' wrappers and their launch counts, held here so that phase
# 5's plain-attention patches of the module attributes do not hide them
KERNEL = kmod.paged_attention
QKERNEL = qmod.paged_attention_quant
PACK = kvmod.quantize_pages
UNPACK = kvmod.dequantize_pages
BGMV = bgmod.bgmv
BGMV_ADD = bgmod.bgmv_add  # holds bgmv's launch count: launches, not sites
FLASH = fmod.flash_prefill
SOURCES = [kmod.SOURCE, qmod.SOURCE, kvmod.SOURCE, bgmod.SOURCE, fmod.SOURCE]

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
# the same comparison in f32 (phase 5's LoRA twin): the kernel and the plain
# bgmv differ by f32 summation order (~1e-6 relative); 16 layers may amplify
# that a few hundred times, still far below the O(1) a wrong row or slot gives
MODEL_ATOL_F32 = 1e-2
# olmo-1b decode shape timed in phase 4
OLMO = dict(B=8, KV=16, G=1, D=128, P=16, L=1024)
# the olmo-1b ragged extend step (phase 5): chunk starts and real chunk lengths
OLMO_EXTEND_LENGTHS, OLMO_CHUNK_LENS = [0, 100, 513, 300], [64, 17, 1, 40]
# speculative decoding (phases 3, 5, 6): k draft tokens, verify chunks of C =
# k + 1 (2, 4, 5 for k = 1, 3, 4) at the decode heads of olmo-1b (G = 1),
# qwen2.5-32b (G = 5) and gemma-2b (G = 8, D = 256): name, KV, G, D; chunk
# starts of the four rows, none of whose C = 5 chunks crosses a 16-slot page
# (phase 5's decode steps keep one KIVI tail layout across their steps)
SPEC_K = 4
VERIFY_C = (2, 4, 5)
VERIFY_HEADS = [("olmo-1b", 16, 1, 128), ("qwen2.5-32b", 8, 5, 128),
                ("gemma-2b", 1, 8, 256)]
VERIFY_STARTS = [100, 290, 517, 1000]
# phase 3's chunk starts: rows 0 and 1 cross a page at C = 5, row 3 ends on
# the table's last slot (64 pages of 16)
VERIFY_KERNEL_STARTS = [15, 300, 517, 1019]
# the draft's catch-up: one sequence (B = 1) at a time, power-of-two chunks
# up to 32 over prompts of 128-512 tokens, at olmo-1b's heads. Starts per
# C: 0 (nothing before it), 480 (page-aligned, 30 pages before it) and
# 319 - C // 2 (crosses the page at 320 for every C > 1)
CATCHUP_C = (1, 2, 4, 8, 16, 32)
# the paged attention kernels' names in a profile: the mma kernel and the
# split-K merge
PAGED_FOCUS = ("paged_attention_mma_kernel", "paged_attention_merge_kernel")
# the same for the quantized kernels: the mma kernel, its merge, and the
# CUDA-core kernel (fp32 or a deq_dtype other than q's)
QUANT_FOCUS = ("paged_attention_quant_mma_kernel", "paged_attention_quant_merge_kernel",
               "paged_attention_quant_kernel")
# torch.cuda._sleep cycles that hold the stream while timed calls are
# queued: ~0.2 s at the H100's clock
HOLD_CYCLES = 400_000_000
# the H100's L2 cache: timed inputs rotate over copies that exceed it
L2_BYTES = 50e6


def log(msg: str) -> None:
    print(msg, flush=True)


def plain_attention():
    """Route the ops' kernel call to the plain version (CUDA tensors too),
    for the phase-5 yardstick only; the port itself has no such switch."""
    def plain(q, k, v, tables, lengths, *, scale, rows_per_seq=None, splits=None):
        if rows_per_seq is None:
            return paged_attention_ref(q, k, v, tables, lengths, scale=scale)
        return paged_attention_chunked_ref(q, k, v, tables, lengths, scale=scale)
    return mock.patch.object(kmod, "paged_attention", plain)


def plain_quant_attention():
    """``plain_attention`` for the quantized kernel (phase 5 only)."""
    return mock.patch.object(qmod, "paged_attention_quant", paged_attention_quant_ref)


def plain_bgmv():
    """``plain_attention`` for the LoRA kernel, both entries (phase 5 only)."""
    return mock.patch.multiple(bgmod, bgmv=bgmv_ref, bgmv_add=bgmv_add_ref)


def plain_flash():
    """``plain_attention`` for the flash prefill kernel (phase 5 only)."""
    return mock.patch.object(fmod, "flash_prefill", flash_prefill_ref)


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


def quant_inputs(seed, B, KV, G, D, P, NB, NP, T, bits, dtype, tail_start=None,
                 lengths=None, tables=None):
    """q, KIVI pages packed on the card by the plain pack (planes f16, as the
    engine stores them), fp tails, per-row tables, tail_start and lengths:
    the argument tuple of ``paged_attention_quant``."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.normal(size=(B, KV, G, D)).astype(np.float32))
    leaves = []
    for axis in ("channel", "token"):
        fp = torch.from_numpy(rng.normal(size=(KV * NB, P, D)).astype(np.float32))
        c, s_, z = quantize_pages_ref(fp.to(dev), bits=bits, axis=axis)
        leaves += [t.reshape((KV, NB) + t.shape[1:]) for t in (c, s_.half(), z.half())]
    tails = [torch.from_numpy(rng.normal(size=(B, T, KV, D)).astype(np.float32))
             .to(dev, dtype) for _ in range(2)]
    if tables is None:
        tables = np.stack([rng.choice(NB, size=NP, replace=False) for _ in range(B)])
    if tail_start is None:
        tail_start = rng.integers(0, NP * P + 1, size=(B,))
    if lengths is None:
        lengths = np.asarray(tail_start) + rng.integers(0, T + 1, size=(B,))
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)  # noqa: E731
    return (q.to(dev, dtype), *leaves, *tails, i32(tables), i32(lengths),
            i32(tail_start))


def pack_pages(seed, NP, P, C):
    """Random f32 pages on the card, page 0 constant (scale 0 -> 1), page 1
    seven repeated values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NP, P, C)).astype(np.float32) * 3
    x[0] = -0.75
    x[1:2] = ((np.arange(P)[:, None] + np.arange(C)[None, :]) % 7 + 0.5) / 7
    return torch.from_numpy(x).cuda()


def edge_pages(bits, axis, P, C, dtype):
    """Four pages in ``dtype``: every group of page 0 spans [0, qmax] with
    every other value on an exact .5 tie (bf16 holds the ties up to 127.5);
    page 1 spans +-1e38 (+-6e4 in f16), page 2 +-1e-39 (subnormal; 0 in f16),
    so the pack's reciprocal estimate gives way to the division; page 3 is
    random."""
    rng = np.random.default_rng(bits)
    qmax = 2 ** bits - 1
    t, c = np.meshgrid(np.arange(P), np.arange(C), indexing="ij")
    ties = ((t + c) % qmax + 0.5).astype(np.float32)
    if axis == "channel":
        ties[0], ties[1] = 0, qmax
    else:
        ties[:, 0], ties[:, 1] = 0, qmax
    big = 6e4 if dtype == torch.float16 else 1e38
    x = np.stack([ties, rng.uniform(-big, big, (P, C)), rng.uniform(-1e-39, 1e-39, (P, C)),
                  rng.normal(size=(P, C))]).astype(np.float32)
    return torch.from_numpy(x).cuda().to(dtype)


def check_equal(name, got, want) -> None:
    ok = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    log(f"  {name}: {'byte-equal' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel bytes differ from the plain version's")


def check(name, got, want, atol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    ok = math.isfinite(err) and err <= atol
    log(f"  {name}: max_abs_err={err:.3g} (atol {atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def device_profile(label, fn, focus=()) -> None:
    """Where one call's time goes: its wall time (host clock around a
    synchronized call, median of 3, profiler off), then one call under
    torch.profiler for the kernels' time by name on the device clock. The
    device's busy share is their sum over that wall time. ``focus``:
    substrings of kernel names whose launches and share of the busy time are
    reported too, one line each. Returns the busy microseconds (None when
    the profiler recorded no kernel)."""
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
    if isinstance(focus, str):
        focus = (focus,)
    by_name, launches, focused = {}, 0, {f: [0, 0.0] for f in focus}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            launches += 1
            for f in focus:
                if f in e.name:
                    focused[f][0] += 1
                    focused[f][1] += e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        log(f"  {label}: wall {wall_us / 1e3:.3f} ms; device time not measured "
            "(the profiler recorded no kernel)")
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {label}: wall {wall_us / 1e3:.3f} ms, {launches} device kernels, "
        f"busy {busy / 1e3:.3f} ms = {busy / wall_us:.1%} of wall; top: "
        + "; ".join(f"{n[:48]} {t / 1e3:.3f} ms" for n, t in top))
    for f, (n, us) in focused.items():
        log(f"    {f}: {n} launches, {us / 1e3:.3f} ms = {us / busy:.1%} of busy")
    return busy


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
    card = card_for(name)  # launch/roofline.py's data-sheet rates (card[1:4])
    log("[1 device] nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); rates of {card[0]}: "
        f"{card[1] / 1e12:g} TB/s HBM, {card[2] / 1e12:g} TFLOP/s fp32, "
        f"{card[3] / 1e12:g} TFLOP/s bf16 tensor cores")
    return name, card


def ptxas_entries(report, name):
    """(instance, registers, spill line) of each instance of the kernel
    template ``name`` (over T, and over D where it has one) in a ``ptxas
    -v`` report: ptxas prints an entry's spill line and then its register
    line after the entry's name."""
    lines = report.splitlines()
    for n, line in enumerate(lines):
        hit = re.search(name + r"I\d+(\w+?)(?:Li(\d+)E)?E", line)
        if "Compiling entry" not in line or hit is None:
            continue
        rest = lines[n + 1:]
        spill = next(x for x in rest if "spill" in x).strip()
        regs = next(x for x in rest if "registers" in x).split(":")[-1].strip()
        ty, D = hit.groups()
        yield (f"{name}<{'bf16' if 'bfloat16' in ty else 'f16'}"
               f"{'' if D is None else f', D={D}'}>", regs, spill)


def bgmv_ptxas(report) -> None:
    """bgmv's instances (dtype x rank x rows of C) in one line: registers,
    stack and spills; any spill or stack frame fails the run. An empty
    report (the library was already built) prints nothing."""
    entries = []
    lines = report.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry" not in line or "bgmv_kernel" not in line:
            continue
        rest = lines[n + 1:]
        frame = next(x for x in rest if "spill" in x)
        regs = int(re.search(r"Used (\d+) registers", next(
            x for x in rest if "registers" in x)).group(1))
        nums = [int(v) for v in re.findall(r"(\d+) bytes", frame)]
        mangled = re.search(r"bgmv_kernel\w*", line).group(0)
        entries.append((mangled, regs, sum(nums)))
    if not entries:
        return
    worst = max(entries, key=lambda e: e[1])
    rank8 = [(re.search(r"Li8ELi(\d+)E", e[0]).group(1), e[1]) for e in entries
             if "bfloat16Li8E" in e[0]]
    log(f"  bgmv_kernel: {len(entries)} instances, registers "
        f"{min(e[1] for e in entries)}-{worst[1]} (most: {worst[0]}), "
        f"stack + spills {sum(e[2] for e in entries)} bytes in all; bf16 rank 8 "
        "registers by rows of C: " + ", ".join(f"{r}: {n}" for r, n in rank8))
    bad = [e for e in entries if e[2]]
    if bad:
        raise AssertionError(f"bgmv_kernel instances with stack or spills: {bad}")


def kv_quant_ptxas(report) -> None:
    """Every kv_quant kernel instance (pack: a warp per page over input type
    x C x axis, generic over input type; unpack: vector over output type x axis,
    scalar over output type), one line each: registers, stack and spills;
    a spill fails the run. An empty report (the library was already built)
    prints nothing."""
    lines = report.splitlines()
    spilled = []
    for n, line in enumerate(lines):
        hit = re.search(r"(?:de)?quantize_pages_\w*?kernel", line)
        if "Compiling entry" not in line or hit is None:
            continue
        rest = lines[n + 1:]
        frame = next(x for x in rest if "spill" in x).strip()
        regs = re.search(r"Used (\d+) registers", next(
            x for x in rest if "registers" in x)).group(1)
        args = line[hit.end():]
        ty = "bf16" if "bfloat16" in args else "f16" if "__half" in args else "f32"
        C = re.search(r"Li(\d+)E", args)
        per_channel = re.search(r"Lb([01])E", args)
        label = ", ".join([ty] + ([f"C={C.group(1)}"] if C else []) + (
            [("channel" if per_channel.group(1) == "1" else "token")] if per_channel else []))
        log(f"  {hit.group(0)}<{label}>: {regs} registers; {frame}")
        if any(int(v) for v in re.findall(r"(\d+) bytes spill", frame)):
            spilled.append(f"{hit.group(0)}<{label}>")
    if spilled:
        raise AssertionError(f"kv_quant instances that spill: {spilled}")


def phase_build():
    t0 = time.perf_counter()
    built = _build.build_many(SOURCES)  # one nvcc per source, all at once
    kmod._load()
    _build.load(qmod.SOURCE, qmod.SIGNATURES)
    _build.load(kvmod.SOURCE, kvmod.SIGNATURES)
    _build.load(bgmod.SOURCE, bgmod.SIGNATURES)
    _build.load(fmod.SOURCE, fmod.SIGNATURES)
    log(f"[2 build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s")
    bgmv_lib = _build.library_path(bgmod.SOURCE)
    kv_lib = _build.library_path(kvmod.SOURCE)
    for path, report in built:
        log(f"  {os.path.relpath(path, ROOT)}")
        if path in (bgmv_lib, kv_lib):  # their instances are reported below
            continue
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    bgmv_ptxas(dict(built)[bgmv_lib])
    kv_quant_ptxas(dict(built)[kv_lib])
    # the paged attention mma kernels' instances and their split-K merges
    reports = dict(built)
    for source, names in ((kmod.SOURCE, ("paged_attention_mma_kernel",
                                         "paged_attention_merge_kernel")),
                          (qmod.SOURCE, ("paged_attention_quant_mma_kernel",
                                         "paged_attention_quant_merge_kernel"))):
        for name in names:
            for instance, regs, spill in ptxas_entries(
                    reports[_build.library_path(source)], name):
                log(f"  {instance}: {regs}; {spill}")
    log("  paged_attention_quant_mma_kernel dynamic shared memory: " + ", ".join(
        f"D={D} {qmod._load().paged_attention_quant_smem_bytes(qmod.ROUTES['mma'], 1, D)}"
        f" bytes" for D in (32, 64, 128, 256)))
    # the wgmma flash_prefill kernel's own report
    lines = dict(built)[_build.library_path(fmod.SOURCE)].splitlines()
    smem = _build.load(fmod.SOURCE, fmod.SIGNATURES).flash_prefill_smem_bytes
    for n, line in enumerate(lines):
        if "flash_prefill_wgmma_kernel" in line and "Compiling entry" in line:
            rest = lines[n + 1:]
            spill = next(x for x in rest if "spill" in x).strip()
            regs = next(x for x in rest if "registers" in x).split(":")[-1].strip()
            D = 128 if "Li128E" in line else 64
            log(f"  flash_prefill_wgmma_kernel<{'bf16' if 'bfloat16' in line else 'f16'}, "
                f"D={D}>: {regs}; {spill}; dynamic shared memory "
                f"{smem(fmod.ROUTES['wgmma'], D)} bytes")


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
    # chunked extend vs the chunked oracle (fp32: the batch-axis fold; bf16:
    # the native chunked path)
    for dtype in (torch.float32, torch.bfloat16):
        B, C, KV, G, D, P, NB, NP = 3, 8, 2, 4, 64, 16, 32, 4
        q, k, v, t, _ = inputs(4, B, KV, G, D, P, NB, NP, dtype)
        qc = torch.randn(B, C, KV * G, D, generator=torch.Generator(
            device="cuda").manual_seed(4), device="cuda").to(dtype)
        ln = torch.tensor([0, P - 1, 2 * P], dtype=torch.int32, device="cuda")
        check(f"extend C={C} {str(dtype)[6:]} "
              f"({'fold' if kmod.kernel_route(dtype, D) == 'cuda_core' else 'native'})",
              ops.paged_attend_extend(qc, k, v, t, ln, scale=0.125),
              paged_attention_chunked_ref(qc.reshape(B, C, KV, G, D), k, v, t, ln,
                                          scale=0.125).reshape(B, C, KV * G, D),
              ATOL[dtype])
    phase_kernel_mma()
    torch.cuda.synchronize()


# B, KV, G, D, P, NB, NP: CASES, the largest head_dim, then qwen2.5-32b's and
# gemma-2b's groups (5 and 8) at D = 256
MMA_CASES = CASES + [(2, 2, 2, 256, 8, 8, 3), (3, 1, 5, 256, 16, 12, 4),
                     (2, 1, 8, 256, 16, 8, 4)]
MMA_SPLITS = (1, 2, 7, None)  # forced, and None = the wrapper's plan
# B, C, KV, G, D, P, NB, NP, lengths: ragged chunks with GQA, rows running
# past the table (lengths + C > NP * P), a row tile of 64 and more
EXTEND_CASES = [
    (3, 8, 2, 4, 64, 16, 32, 4, [0, 15, 32]),
    (2, 5, 2, 5, 128, 8, 16, 4, [29, 3]),
    (2, 24, 1, 8, 256, 16, 8, 3, [40, 0]),
    (2, 70, 2, 1, 32, 32, 8, 3, [10, 50]),
]


def extend_inputs(seed, B, C, KV, G, D, P, NB, NP, lengths, dtype):
    q, k, v, t, _ = inputs(seed, B, KV, G, D, P, NB, NP, dtype)
    rng = np.random.default_rng(seed + 1)
    qc = torch.from_numpy(rng.normal(size=(B, C, KV, G, D)).astype(np.float32)).to(
        "cuda", dtype)
    return qc, k, v, t, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def phase_kernel_mma():
    """The bf16 / f16 tensor-core kernel: decode at forced and planned splits,
    native chunked extend, poisoned dead slots, rows with nothing valid."""
    for case in MMA_CASES:
        D = case[3]
        for dtype in (torch.bfloat16, torch.float16):
            q, k, v, t, ln = inputs(11, *case, dtype)
            want = paged_attention_ref(q, k, v, t, ln, scale=D ** -0.5)
            for sp in MMA_SPLITS:
                check(f"mma case {case} {str(dtype)[6:]} splits={sp or 'planned'}",
                      KERNEL(q, k, v, t, ln, scale=D ** -0.5, splits=sp), want,
                      ATOL[torch.bfloat16])
    for case in EXTEND_CASES:
        *shape, lens = case
        B, C, KV, G, D, P, NB, NP = shape
        for dtype in (torch.bfloat16, torch.float16):
            qc, k, v, t, ln = extend_inputs(12, *shape, lens, dtype)
            want = paged_attention_chunked_ref(qc, k, v, t, ln, scale=D ** -0.5)
            for sp in MMA_SPLITS:
                check(f"native extend {tuple(shape)} lengths {lens} {str(dtype)[6:]} "
                      f"splits={sp or 'planned'}",
                      KERNEL(qc, k, v, t, ln, scale=D ** -0.5, rows_per_seq=C, splits=sp),
                      want, ATOL[torch.bfloat16])
    # the olmo-1b ragged extend layer through the model-layout op
    B, C, KV, G, D, P, NP = 4, 64, 16, 1, 128, 16, 64
    qc, k, v, t, ln = extend_inputs(13, B, C, KV, G, D, P, B * NP, NP,
                                    OLMO_EXTEND_LENGTHS, torch.bfloat16)
    check(f"native extend olmo-1b layer B={B} C={C} bf16",
          ops.paged_attend_extend(qc.reshape(B, C, KV * G, D), k, v, t, ln,
                                  scale=D ** -0.5),
          paged_attention_chunked_ref(qc, k, v, t, ln, scale=D ** -0.5).reshape(
              B, C, KV * G, D), ATOL[torch.bfloat16])
    # dead slots of the last partial page (and whole pages past it) hold
    # +-inf and +-1e6: decode rows see 13 positions, extend rows at most
    # 13 + C; a row of length 0 writes 0
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, _, _ = inputs(14, 2, 2, 4, 64, 8, 8, 4, dtype)
        t = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32, device="cuda")
        qc = torch.randn(2, 3, 2, 4, 64, generator=torch.Generator(
            device="cuda").manual_seed(14), device="cuda").to(dtype)
        for label, qq, ln, rows, dead_from in (
                ("decode", q, [13, 0], None, 13), ("extend", qc, [10, 7], 3, 13)):
            ln = torch.tensor(ln, dtype=torch.int32, device="cuda")
            k2, v2 = k.clone(), v.clone()
            for b in range(2):
                blk = t[b].long()
                for pos in range(dead_from if b == 0 else ln[b].item() + (rows or 0), 32):
                    val = float("inf") if pos % 2 else 1e6
                    k2[:, blk[pos // 8], pos % 8] = val
                    v2[:, blk[pos // 8], pos % 8] = -val
            want = (paged_attention_ref if rows is None else paged_attention_chunked_ref)(
                qq, k, v, t, ln, scale=0.2)
            for sp in MMA_SPLITS:
                kw = dict(scale=0.2, rows_per_seq=rows, splits=sp)
                clean = KERNEL(qq, k, v, t, ln, **kw)
                check(f"{label} {str(dtype)[6:]} splits={sp or 'planned'} vs plain",
                      clean, want, ATOL[torch.bfloat16])
                check(f"{label} {str(dtype)[6:]} splits={sp or 'planned'} poisoned slots",
                      KERNEL(qq, k2, v2, t, ln, **kw), clean, 0.0)
                if rows is None:
                    check(f"decode {str(dtype)[6:]} splits={sp or 'planned'} zero-length row",
                          clean[1], torch.zeros_like(clean[1]), 0.0)


QCASES = CASES + [(2, 2, 2, 256, 4, 16, 3)]  # the largest head_dim, P = 4


def phase_kernel_quant():
    log("[3 kernel vs plain version on the card: KIVI pages, pack, unpack]")
    for case in QCASES:
        for bits in (4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                args = quant_inputs(1, *case, 17, bits, dtype)
                D = case[3]
                check(f"quant case {case} T=17 {bits}-bit {str(dtype)[6:]}",
                      QKERNEL(*args, scale=D ** -0.5, deq_dtype=dtype),
                      paged_attention_quant_ref(*args, scale=D ** -0.5, deq_dtype=dtype),
                      ATOL[dtype])
    # rows: tail only (tail_start 0), pages only (lengths == tail_start),
    # nothing valid, a mid-page split; then every slot the rows must not
    # read poisoned (codes 255, planes +-inf, tail +-inf)
    B, KV, G, D, P, NB, NP, T = 4, 2, 2, 64, 8, 20, 4, 5
    ts, ln = [0, 16, 0, 13], [4, 16, 0, 17]
    tables = np.arange(B * NP).reshape(B, NP)  # disjoint rows
    args = quant_inputs(2, B, KV, G, D, P, NB, NP, T, 8, torch.float32,
                        tail_start=ts, lengths=ln, tables=tables)
    clean = QKERNEL(*args, scale=0.2)
    check("quant edge rows vs plain", clean, paged_attention_quant_ref(*args, scale=0.2),
          1e-5)
    check("quant poisoned slots", QKERNEL(*quant_poisoned(args, 1), scale=0.2), clean, 1e-6)
    check("quant row with nothing valid", clean[2], torch.zeros_like(clean[2]), 0.0)
    # the extend fold (prefill) vs the chunked quantized oracle
    for dtype in (torch.float32, torch.bfloat16):
        B, C, KV, G, D, P, NB, NP = 3, 8, 2, 4, 64, 16, 32, 4
        starts = np.asarray([0, P - 1, 2 * P + 3])
        args = quant_inputs(4, B, KV, G, D, P, NB, NP, P + C, 8, dtype,
                            tail_start=starts // P * P, lengths=starts)
        qc = torch.randn(B, C, KV * G, D, generator=torch.Generator(
            device="cuda").manual_seed(4), device="cuda").to(dtype)
        pk = dict(zip(("codes", "scale", "zero"), args[1:4]))
        pv = dict(zip(("codes", "scale", "zero"), args[4:7]))
        route = qmod.kernel_route(dtype, dtype, D)
        check(f"quant extend C={C} {str(dtype)[6:]} "
              f"({'fold' if route == 'cuda_core' else 'native'})",
              ops.paged_attend_extend_quant(qc, pk, pv, *args[7:12], scale=0.125,
                                            deq_dtype=dtype),
              paged_attention_chunked_quant_ref(
                  qc.reshape(B, C, KV, G, D), *args[1:12], scale=0.125,
                  deq_dtype=dtype).reshape(B, C, KV * G, D), ATOL[dtype])
    # the olmo-1b decode shape, random split points
    c = OLMO
    NP = c["L"] // c["P"]
    args = quant_inputs(3, c["B"], c["KV"], c["G"], c["D"], c["P"], c["B"] * NP, NP,
                        c["P"] + 1, 8, torch.bfloat16)
    check("quant olmo-1b decode shape bf16",
          QKERNEL(*args, scale=c["D"] ** -0.5, deq_dtype=torch.bfloat16),
          paged_attention_quant_ref(*args, scale=c["D"] ** -0.5, deq_dtype=torch.bfloat16),
          ATOL[torch.bfloat16])
    phase_kernel_quant_mma()
    torch.cuda.synchronize()


def plain_pack(x, bits, axis, plane_dtype=torch.float32):
    """The plain pack of ``x.float()``, planes cast to ``plane_dtype``: what
    the kernel must write byte for byte."""
    codes, scale, zero = quantize_pages_ref(x.float(), bits=bits, axis=axis)
    return codes, scale.to(plane_dtype), zero.to(plane_dtype)


def phase_kernel_kv_quant():
    """The pack and unpack, byte-equal to the plain versions: every warp
    kernel instance (input f32 / bf16 / f16 x C 32-256 x axis, past one wave
    of pages) and the generic route (C 48, and every C up to one wave), f32
    and f16 planes, bits 2 / 4 / 8, P 4-32, NP 1-4097; every unpack instance
    (out f32 / bf16 / f16 x axis, the vector route at C 128 and 48, the
    scalar one at C 40 and at P 6)."""
    log("[3 kernel vs plain version on the card: KIVI pack and unpack]")
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for C in (32, 64, 128, 256, 48):
            for axis in ("channel", "token"):
                for j, (P, NP, bits) in enumerate(((16, 131, 8), (4, 3, 2), (32, 1057, 4),
                                                   (16, 1061, 8))):
                    x = pack_pages(n, NP, P, C).to(dtype)
                    plane = (torch.float32, torch.float16)[(n + j) % 2]
                    got = PACK(x, bits=bits, axis=axis, plane_dtype=plane)
                    want = plain_pack(x, bits, axis, plane)
                    if not all(g.dtype == w.dtype and torch.equal(g, w)
                               for g, w in zip(got, want)):
                        raise AssertionError(f"pack {str(dtype)[6:]} C={C} {axis} P={P} "
                                             f"NP={NP} {bits}-bit {plane}: bytes differ")
                    n += 1
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for C in (32, 128, 256, 48):
            for axis in ("channel", "token"):
                for bits, extra in ((2, 0), (4, 0), (8, 0), (2, 1057), (4, 1057), (8, 1057)):
                    # alone (the generic route) and ahead of a wave's worth
                    # of pages (the warp kernel)
                    x = edge_pages(bits, axis, 16, C, dtype)
                    if extra:
                        x = torch.cat([x, pack_pages(n, extra, 16, C).to(dtype)])
                    got = PACK(x, bits=bits, axis=axis)
                    if not all(g.dtype == w.dtype and torch.equal(g, w)
                               for g, w in zip(got, plain_pack(x, bits, axis))):
                        raise AssertionError(f"pack of ties / extreme ranges {str(dtype)[6:]} "
                                             f"C={C} {axis} {bits}-bit +{extra} pages: "
                                             "bytes differ")
                    n += 1
    log(f"  pack: {n} launches (input f32/bf16/f16 x C 32/64/128/256/48 x axis x 4 "
        "shapes, f32 and f16 planes; .5 ties and extreme ranges x bits, alone and ahead "
        "of 1057 pages): byte-equal")
    for P, NP, C in ((16, 4097, 128), (16, 1, 256)):
        x = pack_pages(7, NP, P, C).to(torch.bfloat16)
        for axis in ("channel", "token"):
            check_equal(f"pack bf16 ({NP}, {P}, {C}) {axis} f16 planes",
                        PACK(x, bits=8, axis=axis, plane_dtype=torch.float16),
                        plain_pack(x, 8, axis, torch.float16))
    for C, P in ((128, 8), (48, 8), (40, 8), (128, 6)):
        for axis in ("channel", "token"):
            packed = quantize_pages_ref(pack_pages(C, 19, P, C), bits=8, axis=axis)
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                check_equal(f"unpack C={C} P={P} ({kvmod.unpack_plan(19, P, C, 4, 132).route}) "
                            f"{axis} -> {str(dtype)[6:]}",
                            [UNPACK(*packed, out_dtype=dtype)],
                            [dequantize_pages_ref(*packed, out_dtype=dtype)])
    torch.cuda.synchronize()


def phase_kernel_gathered_window():
    """The gathered backend's KIVI window at starcoder2-3b's heads (KV 2, D
    128, P 16, bf16 staging, 8-bit pages; 4 layers, 8 rows of a 1024-slot
    table at ragged lengths): the store packs every filled page through
    the pack kernel, then the window of its packed blocks and of its blocks
    still filling is dequantized by the unpack kernel
    (``gathered.dequantize_window`` on the card) and by the same call on
    the CPU (the plain version): bit-equal, and equal to the store's host
    dequantization."""
    log("[3 kernel vs plain version on the card: the gathered KIVI window]")
    cfg = dataclasses.replace(configs.get_config("starcoder2-3b"),
                              stages=configs.dense_stages(4, "window"))
    P, W, B = 16, 1024, 8
    store = state_mod.PagedModelState(cfg, EngineConfig(
        block_size=P, num_blocks=B * W // P, max_model_len=W, device="cuda",
        kv_quant=QuantConfig(bits=8)), "cuda")
    rng = np.random.default_rng(3)
    lens = [1024, 1000, 777, 512, 300, 129, 16, 5]
    tables = np.arange(B * W // P).reshape(B, W // P)
    blk = np.concatenate([tables[b, np.arange(n) // P] for b, n in enumerate(lens)])
    off = np.concatenate([np.arange(n) % P for n in lens])
    idxs = [i for _, _, i in store.attn_kv_leaves()]
    payloads = [torch.from_numpy(rng.normal(size=(len(blk), cfg.num_kv_heads, cfg.head_dim))
                                 .astype(np.float32)).to(torch.bfloat16) for _ in idxs]
    store._quant_write_group(idxs, torch.from_numpy(blk), torch.from_numpy(off), payloads)
    for b, n in enumerate(lens):  # entries past a row's blocks point at block 0
        tables[b, -(-n // P):] = 0
    packed = store.block_quantized[np.unique(tables)]
    assert packed.any() and not packed.all()
    parts = store.gather_quantized(tables)
    up = sum(t.numel() * t.element_size() for name in ("k", "v")
             for t in parts[name].values())
    fp = B * W * cfg.num_kv_heads * cfg.head_dim * 2 * len(idxs)
    before = UNPACK.launches
    dev = dequantize_window(parts, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    assert UNPACK.launches == before + 2, UNPACK.launches - before
    plain = dequantize_window(parts, "cpu", torch.bfloat16)
    host = store.gather(tables)
    got = [x[n].cpu() for x in dev for n in ("k", "v")]
    check_equal(f"gathered KIVI window (starcoder2-3b heads, {len(idxs) // 2} layers, B={B}, "
                f"W={W}, {int(packed.sum())} packed + {int((~packed).sum())} filling "
                "blocks), unpack kernel (2 launches) vs plain", got,
                [x[n] for x in plain for n in ("k", "v")])
    check_equal("the same window vs the store's host dequantization", got,
                [x[n] for x in host for n in ("k", "v")])
    log(f"  upload {up} B against the fp window's {fp} B ({up / fp:.1%}): codes and planes "
        "of each distinct block once, staging only for blocks still filling")


# B, C, KV, G, D, P, NB, NP, chunk starts, tail_start (None: starts // P *
# P, as the engine keeps it), T (None: P + C): ragged starts with GQA,
# several 16-row tiles, tails of several 32-slot tiles, P = 4 and 32, whole
# pages in the tail
QEXTEND_CASES = [
    (3, 8, 2, 4, 64, 16, 32, 4, [0, 15, 40], None, None),
    (2, 5, 2, 5, 128, 8, 16, 4, [29, 3], None, None),
    (2, 24, 1, 8, 256, 16, 8, 3, [40, 0], None, None),
    (2, 70, 2, 1, 32, 32, 8, 3, [10, 50], None, None),
    (4, 64, 2, 1, 128, 4, 64, 16, [0, 13, 47, 60], None, None),
    (2, 6, 2, 2, 64, 8, 16, 4, [20, 9], [8, 0], 20),
]


def quant_extend_inputs(seed, B, C, KV, G, D, P, NB, NP, starts, ts, T, dtype,
                        tables=None):
    """The kernel's arguments for a chunk of C queries per sequence: q
    (B * C, KV, G, D), per-row lengths starts[b] + c + 1, tail_start
    starts // P * P unless given, T = P + C unless given; and the starts."""
    starts = np.asarray(starts)
    ts = starts // P * P if ts is None else np.asarray(ts)
    row_len = (starts[:, None] + np.arange(C)[None, :] + 1).reshape(-1)
    args = list(quant_inputs(seed, B, KV, G, D, P, NB, NP, P + C if T is None else T, 8,
                             dtype, tail_start=ts, lengths=row_len, tables=tables))
    args[0] = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(B * C, KV, G, D)).astype(np.float32)).to("cuda", dtype)
    return args, torch.tensor(starts, dtype=torch.int32, device="cuda")


def quant_poisoned(args, C):
    """A copy of a disjoint-table argument tuple with every slot no row may
    read poisoned: page slots at or past tail_start (codes 255, value planes
    Inf), the key planes of pages wholly past it (+-Inf), tail slots past
    every row's end (+-Inf)."""
    bad = [a.clone() for a in args]
    kc, ks, kz, vc, vs, vz, kt, vt, tables, lengths, tail_start = bad[1:12]
    P = kc.shape[2]
    for b in range(tables.shape[0]):
        ts = int(tail_start[b])
        for page in range(tables.shape[1]):
            blk = int(tables[b, page])
            dead = slice(max(0, ts - page * P), P)
            kc[:, blk, dead] = vc[:, blk, dead] = 255
            vs[:, blk, dead] = float("inf")
            if page * P >= ts:
                ks[:, blk], kz[:, blk] = float("inf"), float("-inf")
        end = max(0, int(lengths[b * C:(b + 1) * C].max()) - ts)
        kt[b, end:], vt[b, end:] = float("inf"), float("-inf")
    return bad


def phase_kernel_quant_mma():
    """The bf16 / f16 tensor-core route over KIVI pages: decode at forced
    and planned splits, native chunked extend against the chunked oracle,
    poisoned dead slots (bit-equal to the clean run) and a row with nothing
    valid (exactly 0)."""
    for case in QCASES:
        D = case[3]
        for bits in (4, 8):
            for dtype in (torch.bfloat16, torch.float16):
                args = quant_inputs(21, *case, 17, bits, dtype)
                kw = dict(scale=D ** -0.5, deq_dtype=dtype)
                want = paged_attention_quant_ref(*args, **kw)
                for sp in MMA_SPLITS:
                    check(f"quant mma case {case} T=17 {bits}-bit {str(dtype)[6:]} "
                          f"splits={sp or 'planned'}", QKERNEL(*args, splits=sp, **kw),
                          want, ATOL[torch.bfloat16])
    for case in QEXTEND_CASES:
        B, C, KV, G, D = case[:5]
        for dtype in (torch.bfloat16, torch.float16):
            args, starts = quant_extend_inputs(22, *case, dtype)
            kw = dict(scale=D ** -0.5, deq_dtype=dtype)
            want = paged_attention_chunked_quant_ref(
                args[0].reshape(B, C, KV, G, D), *args[1:10], starts, args[11], **kw)
            for sp in MMA_SPLITS:
                check(f"quant native extend {tuple(case[:8])} starts {case[8]} "
                      f"{str(dtype)[6:]} splits={sp or 'planned'}",
                      QKERNEL(*args, rows_per_seq=C, splits=sp, **kw),
                      want.reshape(args[0].shape), ATOL[torch.bfloat16])
    # tail only, pages only, nothing valid, tail_start 13 mid-page (P = 8);
    # decode and a C = 3 chunk
    B, KV, G, D, P, NB, NP = 4, 2, 2, 64, 8, 20, 4
    tables = np.arange(B * NP).reshape(B, NP)  # disjoint rows
    for dtype in (torch.bfloat16, torch.float16):
        for C, ts, starts, T in ((1, [0, 16, 0, 13], [4, 16, 0, 17], 5),
                                 (3, [0, 16, 8, 8], [2, 16, 9, 13], 8)):
            if C == 1:
                args = quant_inputs(23, B, KV, G, D, P, NB, NP, T, 8, dtype,
                                    tail_start=ts, lengths=starts, tables=tables)
            else:
                args, _ = quant_extend_inputs(23, B, C, KV, G, D, P, NB, NP, starts, ts,
                                              T, dtype, tables=tables)
            bad = quant_poisoned(args, C)
            want = paged_attention_quant_ref(*args, scale=0.2, deq_dtype=dtype,
                                             rows_per_seq=C)
            for sp in MMA_SPLITS:
                kw = dict(scale=0.2, deq_dtype=dtype, rows_per_seq=C, splits=sp)
                clean = QKERNEL(*args, **kw)
                label = f"quant mma C={C} {str(dtype)[6:]} splits={sp or 'planned'}"
                check(f"{label} edge rows vs plain", clean, want, ATOL[torch.bfloat16])
                check(f"{label} poisoned slots", QKERNEL(*bad, **kw), clean, 0.0)
                if C == 1:
                    check(f"{label} row with nothing valid", clean[2],
                          torch.zeros_like(clean[2]), 0.0)


def phase_kernel_verify():
    """The speculative verify's chunks (C = 2, 4, 5) through the model-layout
    ops ``verify_paged`` reaches, bf16 at three models' decode heads: over
    fp pages (the paged kernel's native chunked path) against the chunked
    oracle, and over 8-bit KIVI pages with the engine's tails (T = P + C
    slots from tail_start = starts // P * P: 18, 20, 21, none a multiple of
    the kernel's 32-slot tail tile) against the quantized chunked oracle.
    Then the draft's catch-up chunks (B = 1, C up to 32, fp pages only: the
    draft's store is never quantized) at olmo-1b's heads, each at the
    wrapper's own planned splits."""
    log("[3 kernel vs plain version on the card: speculative verify chunks]")
    P, NP = 16, 64
    _, KV, G, D = VERIFY_HEADS[0]
    H, kw = KV * G, dict(scale=D ** -0.5)
    for C in CATCHUP_C:
        for start in (0, 480, 319 - C // 2):
            qc, k, v, t, ln = extend_inputs(30, 1, C, KV, G, D, P, NP, NP, [start],
                                            torch.bfloat16)
            got = ops.paged_attend_extend(qc.reshape(1, C, H, D), k, v, t, ln, **kw)
            check(f"draft catch-up olmo-1b heads B=1 C={C} start {start} bf16, native "
                  f"({kmod.planned_splits(qc, t, k, rows_per_seq=C)} splits)",
                  got, paged_attention_chunked_ref(qc, k, v, t, ln, **kw).reshape(
                      1, C, H, D), ATOL[torch.bfloat16])
    B = 4
    for name, KV, G, D in VERIFY_HEADS:
        H, kw = KV * G, dict(scale=D ** -0.5)
        for C in VERIFY_C:
            qc, k, v, t, ln = extend_inputs(31, B, C, KV, G, D, P, B * NP, NP,
                                            VERIFY_KERNEL_STARTS, torch.bfloat16)
            check(f"verify {name} heads (KV={KV}, G={G}, D={D}) C={C} bf16, native",
                  ops.paged_attend_extend(qc.reshape(B, C, H, D), k, v, t, ln, **kw),
                  paged_attention_chunked_ref(qc, k, v, t, ln, **kw).reshape(B, C, H, D),
                  ATOL[torch.bfloat16])
            args, starts = quant_extend_inputs(32, B, C, KV, G, D, P, B * NP, NP,
                                               VERIFY_KERNEL_STARTS, None, None,
                                               torch.bfloat16)
            qkw = dict(kw, deq_dtype=torch.bfloat16)
            pages = [dict(zip(("codes", "scale", "zero"), args[i: i + 3])) for i in (1, 4)]
            check(f"KIVI verify {name} heads C={C} 8-bit bf16, tails T={P + C}",
                  ops.paged_attend_extend_quant(args[0].reshape(B, C, H, D), *pages,
                                                args[7], args[8], args[9], starts,
                                                args[11], **qkw),
                  paged_attention_chunked_quant_ref(
                      args[0].reshape(B, C, KV, G, D), *args[1:10], starts, args[11],
                      **qkw).reshape(B, C, H, D), ATOL[torch.bfloat16])
    torch.cuda.synchronize()


# decode shapes timed in phase 4 beside OLMO: qwen2.5-32b's and
# internvl2-2b's heads (GQA) and gemma-2b's (MQA)
DECODE_SHAPES = [("olmo-1b", OLMO),
                 ("qwen2.5-32b heads", dict(B=8, KV=8, G=5, D=128, P=16, L=1024)),
                 ("internvl2-2b heads", dict(B=8, KV=8, G=2, D=128, P=16, L=1024)),
                 ("gemma-2b heads", dict(B=8, KV=1, G=8, D=256, P=16, L=1024))]


def split_sweep(call) -> str:
    """Device time of ``call(splits)`` at forced split counts, beside the
    plan: what the plan chose against its neighbours."""
    return ", ".join(f"{sp}: {cuda_ms(lambda: call(sp)) * 1e3:.1f} us"
                     for sp in (1, 2, 4, 8, 16))


def phase_timing(card):
    """paged_attention at its five shapes, all bf16, every row L = 1024:
    olmo-1b, qwen2.5-32b's, internvl2-2b's and gemma-2b's heads in decode, and the
    olmo-1b ragged extend layer (B=4, C=64, chunk starts 0/100/513/300 in a
    1024-slot table). Bound: the K/V positions the rows see (whole decode
    rows; per sequence up to lengths + C in extend), q in and out once,
    tables and lengths, over HBM; 4 * D flops per visible (row, position)
    pair at the bf16 tensor-core rate. Library: one SDPA call over K/V
    gathered outside the timing (enable_gqa; extend with a boolean mask)."""
    out = {}
    for label, c in DECODE_SHAPES:
        B, KV, G, D, P, L = c["B"], c["KV"], c["G"], c["D"], c["P"], c["L"]
        NP = L // P
        q, k, v, t, ln = inputs(5, B, KV, G, D, P, B * NP, NP, torch.bfloat16,
                                lengths=[L] * B)
        scale = D ** -0.5
        got = KERNEL(q, k, v, t, ln, scale=scale)
        err = check(f"{label} timed shape vs plain", got,
                    paged_attention_ref(q, k, v, t, ln, scale=scale), ATOL[torch.bfloat16])
        ms = cuda_ms(lambda: KERNEL(q, k, v, t, ln, scale=scale))
        plain_ms = cuda_ms(lambda: paged_attention_ref(q, k, v, t, ln, scale=scale))
        kg = k[:, t.long()].transpose(0, 1).reshape(B, KV, L, D)
        vg = v[:, t.long()].transpose(0, 1).reshape(B, KV, L, D)
        qs = q.reshape(B, KV * G, 1, D)

        def library():
            return F.scaled_dot_product_attention(qs, kg, vg, scale=scale,
                                                  enable_gqa=True)
        check(f"{label} SDPA vs kernel", library(), got.reshape(B, KV * G, 1, D),
              ATOL[torch.bfloat16])
        library_ms = cuda_ms(library)
        isz = q.element_size()
        kv_bytes = B * KV * L * D * 2 * isz
        nbytes = kv_bytes + 2 * q.numel() * isz + t.numel() * 4 + ln.numel() * 4
        bound_ms, bound_by = bound(card, nbytes, 4 * B * KV * G * L * D, tensor_cores=True)
        splits = kmod.planned_splits(q, t, k)
        sweep = split_sweep(lambda sp: KERNEL(q, k, v, t, ln, scale=scale, splits=sp))
        log(f"[4 timing] paged_attention {label} B={B} KV={KV} G={G} D={D} P={P} L={L} "
            f"bf16 ({kmod.kernel_route(q.dtype, D)}, {splits} splits): kernel "
            f"{ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, "
            f"{bound_by}), plain {plain_ms * 1e3:.1f} us, SDPA(enable_gqa) "
            f"{library_ms * 1e3:.1f} us; kernel / SDPA {ms / library_ms:.2f}; "
            f"{bound_ms / ms:.1%} of bound; forced splits {sweep}")
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        del q, k, v, kg, vg
    # the olmo-1b ragged extend layer: one native chunked launch (+ merge)
    c = OLMO
    B, C, KV, G, D, P, NP = 4, 64, c["KV"], c["G"], c["D"], c["P"], c["L"] // c["P"]
    qc, k, v, t, ln = extend_inputs(5, B, C, KV, G, D, P, B * NP, NP,
                                    OLMO_EXTEND_LENGTHS, torch.bfloat16)
    scale = D ** -0.5
    qm = qc.reshape(B, C, KV * G, D)
    got = ops.paged_attend_extend(qm, k, v, t, ln, scale=scale)
    err = check("olmo-1b extend layer timed shape vs plain", got,
                paged_attention_chunked_ref(qc, k, v, t, ln, scale=scale).reshape(qm.shape),
                ATOL[torch.bfloat16])
    ms = cuda_ms(lambda: ops.paged_attend_extend(qm, k, v, t, ln, scale=scale))
    fold_ms = cuda_ms(lambda: ops.paged_attend_extend_folded(qm, k, v, t, ln, scale=scale))
    plain_ms = cuda_ms(lambda: paged_attention_chunked_ref(qc, k, v, t, ln, scale=scale))
    S = NP * P
    kg = k[:, t.long()].transpose(0, 1).reshape(B, KV, S, D)
    vg = v[:, t.long()].transpose(0, 1).reshape(B, KV, S, D)
    qs = qm.transpose(1, 2)  # (B, H, C, D)
    row_len = (ln.long()[:, None] + torch.arange(C, device="cuda")[None, :] + 1).clamp(
        max=S)  # (B, C)
    mask = (torch.arange(S, device="cuda")[None, None, :] < row_len[:, :, None])[:, None]

    def library():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask, scale=scale,
                                              enable_gqa=True)
    check("olmo-1b extend layer SDPA vs kernel", library().transpose(1, 2), got,
          ATOL[torch.bfloat16])
    library_ms = cuda_ms(library)
    isz = qc.element_size()
    seen = int(row_len[:, -1].sum())  # positions each sequence's rows read
    nbytes = (seen * KV * D * 2 * isz + 2 * qc.numel() * isz
              + t.numel() * 4 + ln.numel() * 4)
    flops = 4 * KV * G * D * int(row_len.sum())
    bound_ms, bound_by = bound(card, nbytes, flops, tensor_cores=True)
    splits = kmod.planned_splits(qc, t, k, rows_per_seq=C)
    sweep = split_sweep(lambda sp: KERNEL(qc, k, v, t, ln, scale=scale, rows_per_seq=C,
                                          splits=sp))
    log(f"[4 timing] paged_attention olmo-1b extend layer B={B} C={C} KV={KV} G={G} "
        f"D={D} P={P} lengths {OLMO_EXTEND_LENGTHS} bf16 (native, {splits} splits): "
        f"kernel {ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, "
        f"{bound_by}), the batch-axis fold through the decode path {fold_ms * 1e3:.1f} "
        f"us, plain "
        f"{plain_ms * 1e3:.1f} us, SDPA(boolean mask, enable_gqa) {library_ms * 1e3:.1f} "
        f"us; kernel / SDPA {ms / library_ms:.2f}; {bound_ms / ms:.1%} of bound; "
        f"forced splits {sweep}")
    out["olmo-1b extend"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    return out["olmo-1b"]


def bound(card, nbytes, flops, tensor_cores=False):
    """The least time in ms for ``nbytes`` of HBM traffic and ``flops``
    operations (fp32 on the CUDA cores, or bf16 / f16 on the tensor cores),
    and which of the two sets it."""
    rate = card[3] if tensor_cores else card[2]
    bytes_ms, ops_ms = nbytes / card[1] * 1e3, flops / rate * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def quant_bound(card, args, C):
    """The bound of one quantized call: each sequence's valid page slots'
    K and V codes, the K planes of its live pages and the V planes of its
    slots, the tail slots its longest row sees, q in and out, its table
    entries, lengths and tail_start, over HBM; 4 * D flops per visible
    (row, position) pair at the tensor-core rate and 2 per dequantized K or
    V element at the fp32 rate. Returns (ms, "bytes" or "operations", MB)."""
    q, tables, lengths, tail_start = args[0], args[9], args[10], args[11]
    KV, G, D = q.shape[1:]
    P, T = args[1].shape[2], args[7].shape[1]
    isz = q.element_size()
    n_page = tail_start.long().clamp(0, tables.shape[1] * P).cpu()
    seen = (lengths.long().cpu().reshape(-1, C) - n_page[:, None]).clamp(0, T)
    pages = -(-n_page // P)
    nbytes = int(KV * (n_page * D * 2 + pages * D * 2 * 2 + n_page * 2 * 2
                       + seen.amax(dim=1) * D * 2 * isz).sum()
                 + 2 * q.numel() * isz + (pages.sum() + lengths.numel()
                                          + tail_start.numel()) * 4)
    visible = int((n_page[:, None] + seen).sum())
    mma_ms = 4 * KV * G * D * visible / card[3] * 1e3
    deq_ms = 2 * 2 * KV * D * int(n_page.sum()) / card[2] * 1e3
    bytes_ms = nbytes / card[1] * 1e3
    return (max(bytes_ms, mma_ms + deq_ms),
            "bytes" if bytes_ms >= mma_ms + deq_ms else "operations", nbytes / 1e6)


def phase_timing_quant(card):
    """paged_attention_quant, 8-bit pages, all bf16 (the mma route), at
    olmo-1b's, qwen2.5-32b's and gemma-2b's decode heads (every row 1024
    tokens, 1008 of them in packed pages, a 17-slot tail) and the olmo-1b
    KIVI ragged extend layer (B=4, C=64, chunk starts 0/100/513/300,
    tail_start = starts // 16 * 16, an 80-slot tail); beside each, the
    CUDA-core kernel that served these shapes before (the parent's kernel;
    extend through it is the batch-axis fold), the plain version and a
    sweep of forced split counts."""
    out = {}
    shapes = [(label, dict(c, C=1, starts=[c["L"] - 1] * c["B"], ts=[c["L"] - c["P"]] * c["B"]))
              for label, c in DECODE_SHAPES]
    shapes.append(("olmo-1b KIVI extend layer",
                   dict(OLMO, B=4, C=64, starts=OLMO_EXTEND_LENGTHS,
                        ts=[n // OLMO["P"] * OLMO["P"] for n in OLMO_EXTEND_LENGTHS])))
    for label, c in shapes:
        B, C, KV, G, D, P, L = c["B"], c["C"], c["KV"], c["G"], c["D"], c["P"], c["L"]
        NP = L // P
        args, starts = quant_extend_inputs(5, B, C, KV, G, D, P, B * NP, NP, c["starts"],
                                           c["ts"], P + C, torch.bfloat16)
        kw = dict(scale=D ** -0.5, deq_dtype=torch.bfloat16, rows_per_seq=C)
        if C == 1:
            plain = lambda: paged_attention_quant_ref(*args, **kw)  # noqa: E731
        else:
            def plain():
                return paged_attention_chunked_quant_ref(
                    args[0].reshape(B, C, KV, G, D), *args[1:10], starts, args[11],
                    scale=kw["scale"], deq_dtype=torch.bfloat16).reshape(args[0].shape)
        err = check(f"quant {label} timed shape vs plain", QKERNEL(*args, **kw), plain(),
                    ATOL[torch.bfloat16])
        check(f"quant {label} CUDA-core kernel (before) vs plain",
              qmod._launch("cuda_core", *args, splits=None, **kw), plain(),
              ATOL[torch.bfloat16])
        ms = cuda_ms(lambda: QKERNEL(*args, **kw))
        before_ms = cuda_ms(lambda: qmod._launch("cuda_core", *args, splits=None, **kw))
        plain_ms = cuda_ms(plain, reps=20 if C == 1 else 5)  # extend: ~10 ms to queue
        bound_ms, bound_by, mb = quant_bound(card, args, C)
        splits = qmod.planned_splits(args[0], args[9], args[1], args[7], C)
        sweep = split_sweep(lambda sp: QKERNEL(*args, splits=sp, **kw))
        log(f"[4 timing] paged_attention_quant {label} B={B} C={C} KV={KV} G={G} D={D} "
            f"P={P} L={L} tail_start {c['ts'] if C > 1 else c['ts'][0]} T={P + C} 8-bit "
            f"bf16 ({qmod.kernel_route(torch.bfloat16, torch.bfloat16, D)}, {splits} "
            f"splits): kernel {ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
            f"({mb:.1f} MB, {bound_by}), before (the CUDA-core kernel"
            f"{', the fold' if C > 1 else ''}) {before_ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, library: none (no single PyTorch call attends "
            f"over uint8 codes with scale/zero planes and an fp tail); before / kernel "
            f"{before_ms / ms:.2f}; {bound_ms / ms:.1%} of bound; forced splits {sweep}")
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=err)
    return {"paged_attention_quant": out["olmo-1b"]}


def device_us(fn, pattern, reps: int = 20) -> float:
    """Device microseconds of one ``fn`` call on the profiler's clock: the
    summed time of the kernels whose names match ``pattern`` over ``reps``
    calls, divided by ``reps``. Unlike ``cuda_ms`` it leaves out the gaps
    between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(6):  # a profile now and then misses device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and re.search(pattern, e.name)]
        if len(hits) == reps:
            return sum(hits) / reps
    raise RuntimeError(f"the profiler recorded {len(hits)} of {reps} kernels matching "
                       f"{pattern!r}")


def rotating(fn, inputs):
    """``fn`` over ``inputs`` in turn, one per call, each call's result kept
    until its input's next turn, so the caching allocator hands every call
    other output memory: with enough copies the data a call reads and the
    memory it writes have left the L2 since their last use (from HBM, as a
    pack finds a freshly uploaded page group)."""
    turn, kept = [0], [None] * len(inputs)

    def call():
        turn[0] += 1
        i = turn[0] % len(inputs)
        kept[i] = fn(*inputs[i])
        return kept[i]
    return call


def hbm_copies(tensors, out_bytes=0):
    """Copies of ``tensors`` so that one pass over them, with ``out_bytes``
    written per call, moves three times the L2 (50 MB on the H100)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    n = max(2, math.ceil(3 * L2_BYTES / nbytes))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


# the pack / unpack kernels' names on the profiler's clock (any version)
PACK_NAMES, UNPACK_NAMES = r"\bquantize_pages", r"dequantize_pages"


def time_pack(card, NP, axis, dtype=torch.float32, plane_dtype=torch.float32):
    """One pack shape, P = 16 and C = 128 (olmo-1b's pages), 8 bits, from HBM:
    ``PACK`` by ``cuda_ms`` and by the profiler's device clock, its bound
    and the plain version's time. f32 planes are asked for by leaving
    ``plane_dtype`` out (so any version's wrapper takes the call)."""
    P, D = OLMO["P"], OLMO["D"]
    x = pack_pages(NP, NP, P, D).to(dtype)
    kw = dict(bits=8, axis=axis)
    if plane_dtype != torch.float32:
        kw["plane_dtype"] = plane_dtype
    check_equal(f"pack timed shape ({NP}, {P}, {D}) {str(dtype)[6:]} {axis} "
                f"{str(plane_dtype)[6:]} planes", PACK(x, **kw), plain_pack(x, 8, axis, plane_dtype))
    groups = NP * (D if axis == "channel" else P)
    plane_bytes = 2 * groups * torch.finfo(plane_dtype).bits // 8
    copies = hbm_copies([x], x.numel() + plane_bytes)
    fn = rotating(lambda t: PACK(t, **kw), copies)
    out = dict(ms=cuda_ms(fn), device_ms=device_us(fn, PACK_NAMES) / 1e3, max_abs_err=0.0,
               copies=len(copies), x=x, kw=kw)
    nbytes = x.numel() * (x.element_size() + 1) + plane_bytes
    out["bound_ms"], out["bound_by"] = bound(card, nbytes, 6 * x.numel())
    out["mb"] = nbytes / 1e6
    out["plain_ms"] = cuda_ms(rotating(lambda t: plain_pack(t, 8, axis, plane_dtype),
                                       copies))
    out["library_ms"] = None
    return out


def time_unpack(card, out_dtype, library=False):
    """``UNPACK`` of (4096, 16, 128) 8-bit codes grouped per channel, from
    HBM, like ``time_pack``; ``library``: also ``torch.addcmul(zero, codes,
    scale)``, the one PyTorch call computing its f32 form."""
    P, D = OLMO["P"], OLMO["D"]
    codes, sc, zr = quantize_pages_ref(pack_pages(4096, 4096, P, D), bits=8, axis="channel")
    kw = dict(out_dtype=out_dtype)
    want = dequantize_pages_ref(codes, sc, zr, **kw)
    check_equal(f"unpack timed shape -> {str(out_dtype)[6:]}", [UNPACK(codes, sc, zr, **kw)],
                [want])
    isz = torch.finfo(out_dtype).bits // 8
    copies = hbm_copies([codes, sc, zr], codes.numel() * isz)
    fn = rotating(lambda c, s_, z: UNPACK(c, s_, z, **kw), copies)
    out = dict(ms=cuda_ms(fn), device_ms=device_us(fn, UNPACK_NAMES) / 1e3, max_abs_err=0.0,
               copies=len(copies), x=(codes, sc, zr), kw=kw)
    nbytes = codes.numel() * (1 + isz) + 2 * sc.numel() * 4
    out["bound_ms"], out["bound_by"] = bound(card, nbytes, 2 * codes.numel())
    out["mb"] = nbytes / 1e6
    out["plain_ms"] = cuda_ms(rotating(lambda c, s_, z: dequantize_pages_ref(c, s_, z, **kw),
                                       copies))
    out["library_ms"] = None
    if library:
        lib_err = (torch.addcmul(zr, codes, sc) - want).abs().max().item()
        out["library_ms"] = cuda_ms(rotating(torch.addcmul, [(z, c, s_) for c, s_, z in copies]))
        out["library_err"] = lib_err
    return out


def log_kv_timing(name, label, t) -> None:
    lib = "" if t["library_ms"] is None else (
        f", torch.addcmul {t['library_ms'] * 1e3:.1f} us (max |diff| "
        f"{t['library_err']:.3g}: it may fuse into one rounding)")
    log(f"[4 timing] {name} {label}, from HBM ({t['copies']} copies of the inputs and "
        f"outputs): kernel {t['ms'] * 1e3:.1f} us (device clock {t['device_ms'] * 1e3:.2f} "
        f"us), bound {t['bound_ms'] * 1e3:.1f} us ({t['mb']:.1f} MB, {t['bound_by']}), "
        f"plain {t['plain_ms'] * 1e3:.1f} us{lib}; {t['bound_ms'] / t['ms']:.1%} of bound "
        f"({t['bound_ms'] / t['device_ms']:.1%} by the device clock)")


def warm_row(name, label, t, kernel, plain):
    """The ``kernels`` line's row for ``name``, defined as before the
    from-HBM timing: one input timed over and over (warm in the L2), the
    bound of ``t`` (the same shape)."""
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    log(f"[4 timing] {name} {label}, one input over and over (the kernels line's row): "
        f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
        f"{t['bound_ms'] * 1e3:.1f} us; {t['bound_ms'] / ms:.1%} of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], max_abs_err=0.0)


# the pack shapes of the KIVI serve: one call per grouping axis per step,
# every layer's filled pages at once (16 layers x 16 KV heads per filled
# block). A decode step that fills one block packs 256 (16, 128) pages per
# axis; a prefill step of 4 x 64 tokens fills 16 blocks: 4096 pages. The
# serve packs bf16 staging pages into f16 planes; f32 with f32 planes is the
# JAX kernel's own call (and the only input the parent's kernel took)
PACK_SHAPES = [
    (256, "channel", torch.float32, torch.float32),
    (256, "token", torch.float32, torch.float32),
    (4096, "token", torch.float32, torch.float32),
    (4096, "channel", torch.float32, torch.float32),
    (256, "channel", torch.bfloat16, torch.float16),
    (256, "token", torch.bfloat16, torch.float16),
    (4096, "token", torch.bfloat16, torch.float16),
    (4096, "channel", torch.bfloat16, torch.float16),
]


def phase_timing_kv_quant(card):
    """The pack at ``PACK_SHAPES`` and the unpack of (4096, 16, 128) codes
    into bf16 and f32 (beside ``torch.addcmul``), each from HBM. The
    ``kernels`` line keeps the rows it had before: the f32 per-channel pack
    of 4096 pages and the bf16 unpack, warm in the L2 (``warm_row``)."""
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for NP, axis, dtype, plane in PACK_SHAPES:
        t = time_pack(card, NP, axis, dtype, plane)
        plan = kvmod.pack_plan(NP, 16, 128, torch.finfo(dtype).bits // 8, axis, sms)
        label = f"({NP}, 16, 128) {str(dtype)[6:]} -> 8-bit, {axis}, {str(plane)[6:]} planes"
        log_kv_timing("quantize_pages", f"{label} ({plan})", t)
        if (NP, axis, dtype) == (4096, "channel", torch.float32):
            x, kw = t["x"], t["kw"]
            out["quantize_pages"] = warm_row("quantize_pages", label, t,
                                             lambda: PACK(x, **kw),
                                             lambda: plain_pack(x, 8, axis, plane))
    for dtype in (torch.bfloat16, torch.float32):
        t = time_unpack(card, dtype, library=dtype == torch.float32)
        label = f"(4096, 16, 128) 8-bit -> {str(dtype)[6:]}, channel"
        log_kv_timing("dequantize_pages", label, t)
        if dtype == torch.bfloat16:
            (c, s_, z), kw = t["x"], t["kw"]
            out["dequantize_pages"] = warm_row(
                "dequantize_pages", label, t, lambda: UNPACK(c, s_, z, **kw),
                lambda: dequantize_pages_ref(c, s_, z, **kw))
    return out


# B, C, Din, R, Dout, T: tests/test_lora.py:70-84's case, ranks 4-64 at C = 1
# and C = 64, then olmo-1b's three adapter site shapes at decode and prefill
BGMV_CASES = (
    [(5, 3, 16, 4, 24, 4)]
    + [(6, C, 256, R, 320, 5) for R in (4, 8, 16, 64) for C in (1, 64)]
    # decode, a ragged prefill, the speculative verify (C = k + 1) and the
    # draft's B = 1 catch-up chunk at olmo-1b's widths
    + [(B, C, Din, 8, Dout, 5) for B, C in ((8, 1), (4, 64), (8, 5), (1, 32))
       for Din, Dout in ((2048, 2048), (2048, 16384), (8192, 2048))]
    # ranks between the kernel's instances (R not a multiple of 4 reads A
    # element by element) and a Din / Dout that is not a multiple of the
    # 16-byte vectors (scalar loads and stores)
    + [(6, C, 256, R, 320, 5) for R in (5, 12, 33) for C in (1, 17)]
    + [(3, 5, 1030, 8, 1002, 4), (4, 1, 2049, 16, 2050, 3)])
# the fused q/k/v launch: Din and the three sites' Dout at each model's
# published widths (MHA; GQA 40 / 8 heads; MQA, head_dim 256), and the
# (C, B) it is checked at: decode, the speculative verify (5, 8), the draft's
# catch-up chunk (32, 1), ragged prefill rows
QKV_SITES = {"olmo-1b": (2048, (2048, 2048, 2048)),
             "qwen2.5-32b": (5120, (5120, 1024, 1024)),
             "gemma-2b": (2048, (2048, 256, 256))}
FUSED_ROWS = ((1, 8), (3, 8), (5, 8), (17, 4), (32, 1), (64, 4))
# bgmv tolerance beyond ATOL. f32: the plain version's own rounding error,
# measured against an f64 product on the card (its batched matmul sums the Din
# products sequentially: at Din 2048-8192 and C=64 its error alone reaches
# 1e-5 at O(1) outputs, while the kernel's tree sums stay near 1e-6). bf16:
# both versions sum in f32 and round once; where the two sums straddle a
# rounding boundary they differ by one bf16 step, 2^-7 relative.
BGMV_RTOL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}


def bgmv_f64(x, a, b, idx):
    """The same products in f64 on the card: the yardstick of f32 rounding."""
    i = idx.long()
    h = torch.einsum("bcd,bdr->bcr", x.double(), a[i].double())
    return torch.einsum("bcr,bro->bco", h, b[i].double())


def bgmv_inputs(seed, B, C, Din, R, Dout, T, dtype, idx=None):
    """O(1) outputs (A and B scaled as make_adapter scales them), slot 0 the
    null adapter, ids with slot 0 and a repeat unless given (B = 1: slot 1)."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.normal(size=(B, C, Din)).astype(np.float32)).to(dev, dtype)
    a = (rng.normal(size=(T, Din, R)) / np.sqrt(Din)).astype(np.float32)
    b = (rng.normal(size=(T, R, Dout)) / np.sqrt(R)).astype(np.float32)
    a[0] = 0
    b[0] = 0
    if idx is None:  # B = 1: the draft's catch-up row, one tenant
        idx = (np.arange(B) * 2 + 1) % T
        if B > 1:
            idx[0] = 0
            idx[-1] = idx[1]
    return (x, torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.tensor(np.asarray(idx), dtype=torch.int32, device=dev))


def check_bgmv(name, x, a, b, idx, got=None, quiet=False) -> float:
    """``got`` (the kernel's output unless given) vs the plain version on
    the same inputs: within ATOL plus BGMV_RTOL relative plus, in f32, the
    plain version's own distance from f64 (and ``got`` within ATOL of f64);
    every null-slot row exactly 0. ``quiet``: log only a failure."""
    got = BGMV(x, a, b, idx) if got is None else got
    want = bgmv_ref(x, a, b, idx)
    exact = bgmv_f64(x, a, b, idx)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    slack = BGMV_RTOL[x.dtype] * want.float().abs()
    plain_err = got_err = 0.0
    if x.dtype == torch.float32:
        slack = (want.double() - exact).abs().float()
        plain_err = slack.max().item()
        got_err = (got.double() - exact).abs().max().item()
    over = (diff - slack).max().item()
    null = idx == 0
    null_max = got[null].float().abs().max().item() if null.any() else 0.0
    ok = math.isfinite(err) and over <= ATOL[x.dtype] and \
        got_err <= ATOL[x.dtype] and null_max == 0.0
    if not quiet or not ok:
        log(f"  {name}: max_abs_err={err:.3g} (atol {ATOL[x.dtype]:g} + "
            + (f"the plain version's f32 error {plain_err:.3g}; vs f64 {got_err:.3g}"
               if x.dtype == torch.float32 else f"rtol {BGMV_RTOL[x.dtype]:g}")
            + f"), null-slot rows max |y| {null_max:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: disagrees with the plain bgmv")
    return err


def fused_inputs(seed, B, C, Din, R, douts, T, dtype, idx=None, bases=True):
    """``bgmv_inputs`` for several sites sharing x: per site (a, b, base),
    base random in x's dtype (None where ``bases`` is false)."""
    x, a, b, ix = bgmv_inputs(seed, B, C, Din, R, douts[0], T, dtype, idx=idx)
    rng = np.random.default_rng(seed + 1)
    tables = [(a, b)]
    for dout in douts[1:]:
        a2 = (rng.normal(size=(T, Din, R)) / np.sqrt(Din)).astype(np.float32)
        b2 = (rng.normal(size=(T, R, dout)) / np.sqrt(R)).astype(np.float32)
        a2[0] = 0
        b2[0] = 0
        tables.append((torch.from_numpy(a2).cuda(), torch.from_numpy(b2).cuda()))
    sites = [(sa, sb, torch.from_numpy(rng.normal(size=(B, C, sb.shape[2])).astype(
        np.float32)).to("cuda", dtype) if bases else None) for sa, sb in tables]
    return x, ix, sites


def check_fused(name, x, idx, sites, got, bases0) -> float:
    """One fused launch's outputs ``got`` (bases written in place; their
    values before in ``bases0``). A site without a base: ``check_bgmv`` of
    its delta. With one: within ATOL + BGMV_RTOL of base + the plain delta
    (f32: plus the plain delta's own distance from f64); bit-equal to
    PyTorch's base + the delta of the same launch without bases (the same
    plan, so the same sums); null-slot rows bit-equal to base + 0."""
    err, null = 0.0, idx == 0
    deltas = BGMV_ADD(x, idx, [(a, b, None) for a, b, _ in sites])
    for i, ((a, b, _), g, b0, delta) in enumerate(zip(sites, got, bases0, deltas)):
        if b0 is None:
            err = max(err, check_bgmv(f"{name} site {i}", x, a, b, idx, got=g, quiet=True))
            continue
        plain = bgmv_ref(x, a, b, idx)
        want = b0 + plain
        own = b0 + delta
        torch.cuda.synchronize()
        diff = (g.float() - want.float()).abs()
        slack = BGMV_RTOL[x.dtype] * want.float().abs()
        if x.dtype == torch.float32:
            slack = slack + (plain.double() - bgmv_f64(x, a, b, idx)).abs().float()
        e, over = diff.max().item(), (diff - slack).max().item()
        bit, nul = torch.equal(g, own), torch.equal(g[null], b0[null] + 0)
        if not (math.isfinite(e) and over <= ATOL[x.dtype] and bit and nul):
            raise AssertionError(f"{name} site {i}: max_abs_err {e:.3g} (over the "
                                 f"slack by {over:.3g}), bit-equal to base + kernel "
                                 f"delta: {bit}, null rows equal to base: {nul}")
        err = max(err, e)
    return err


def phase_kernel_lora():
    log("[3 kernel vs plain version on the card: LoRA bgmv]")
    for case in BGMV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            check_bgmv(f"bgmv (B, C, Din, R, Dout, T) = {case} {str(dtype)[6:]}",
                       *bgmv_inputs(9, *case, dtype))
    # ids outside the table never read it: those rows come back NaN
    x, a, b, _ = bgmv_inputs(10, 3, 2, 64, 4, 96, 3, torch.float32)
    out = BGMV(x, a, b, torch.tensor([1, 3, 0], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and not torch.isnan(out[[0, 2]]).any()
    log("  bgmv id outside the table: its row NaN, the others finite ok")
    # the fused q/k/v launch, with and without bases
    for model, (Din, douts) in QKV_SITES.items():
        for C, B in FUSED_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                errs = []
                for bases in (True, False):
                    x, idx, sites = fused_inputs(13, B, C, Din, 8, douts, 5, dtype,
                                                 bases=bases)
                    bases0 = [None if base is None else base.clone()
                              for _, _, base in sites]
                    before = BGMV_ADD.launches
                    got = BGMV_ADD(x, idx, sites)
                    assert BGMV_ADD.launches == before + 1
                    errs.append(check_fused(f"fused q/k/v {model} C={C}", x, idx,
                                            sites, got, bases0))
                log(f"  fused q/k/v {model} (Din {Din} -> {douts}) B={B} C={C} "
                    f"{str(dtype)[6:]}, one launch: with bases max_abs_err={errs[0]:.3g}, "
                    "bit-equal to base + the same launch's delta, null-slot rows = base + 0; "
                    f"without bases {errs[1]:.3g}, null-slot rows exactly 0 ok")


def phase_timing_lora(card):
    """bgmv at olmo-1b's w1 site (2048 -> 16384, rank 8) and its fused q/k/v
    launch (3 x 2048 -> 2048, bases read and written in place), with 4
    distinct adapters plus the null slot: decode (B=8, C=1) and prefill
    (B=4, C=64). Beside each: the plain version and the PyTorch calls for
    the same function. Bound: each distinct slot's factors, x, y (and the
    bases) once."""
    one = torch.zeros(1, device="cuda")
    log(f"[4 timing] cuda_ms of a one-element add_ (what a launch costs this clock): "
        f"{cuda_ms(lambda: one.add_(1)) * 1e3:.1f} us")
    out = {}
    R, T = 8, 5
    for label, B, C, idx in (("decode", 8, 1, [1, 2, 0, 3, 4, 1, 0, 2]),
                             ("prefill", 4, 64, [1, 2, 0, 3])):
        Din, Dout = 2048, 16384
        x, a, b, ix = bgmv_inputs(11, B, C, Din, R, Dout, T, torch.bfloat16, idx=idx)
        err = check_bgmv(f"bgmv timed {label} shape", x, a, b, ix)
        ms = cuda_ms(lambda: BGMV(x, a, b, ix))
        plain_ms = cuda_ms(lambda: bgmv_ref(x, a, b, ix))

        def library():  # 2 gathers, 2 torch.bmm, casts in and out of f32
            ag, bg = a.index_select(0, ix), b.index_select(0, ix)
            return torch.bmm(torch.bmm(x.float(), ag), bg).to(x.dtype)
        check_bgmv(f"bgmv {label}: gather + 2 x torch.bmm", x, a, b, ix, got=library())
        library_ms = cuda_ms(library)
        slots = len(set(idx))  # the distinct slots this run's ids read
        nbytes = (slots * R * (Din + Dout) * 4 + x.numel() * 2 + B * C * Dout * 2
                  + B * 4)
        bound_ms, bound_by = bound(card, nbytes, 2 * B * C * R * (Din + Dout))
        p = bgmod.plan(B, C, Din, R, (Dout,), torch.cuda.get_device_properties(0)
                       .multi_processor_count, 2)
        log(f"[4 timing] bgmv w1 {label} B={B} C={C} Din={Din} R={R} Dout={Dout} bf16, "
            f"{slots} distinct slots (plan: {p.rows} rows x {p.spans[0]} columns a CTA, "
            f"clusters of {p.cluster}, {B * p.row_tiles * sum(p.ctas)} CTAs): kernel "
            f"{ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, "
            f"{bound_by}), plain {plain_ms * 1e3:.1f} us, library "
            f"(2 index_select + 2 torch.bmm + 2 casts = 6 calls) {library_ms * 1e3:.1f} "
            f"us; {bound_ms / ms:.1%} of bound")
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    for label, B, C, idx in (("decode", 8, 1, [1, 2, 0, 3, 4, 1, 0, 2]),
                             ("prefill", 4, 64, [1, 2, 0, 3])):
        Din, douts = QKV_SITES["olmo-1b"]
        x, ix, sites = fused_inputs(12, B, C, Din, R, douts, T, torch.bfloat16, idx=idx)
        err = check_fused(f"fused q/k/v timed {label} shape", x, ix, sites,
                          BGMV_ADD(x, ix, [(a, b, base.clone()) for a, b, base in sites]),
                          [base for _, _, base in sites])
        # the bases take the delta again on every timed call: only the time counts
        ms = cuda_ms(lambda: BGMV_ADD(x, ix, sites))
        plain_ms = cuda_ms(lambda: bgmv_add_ref(x, ix, sites))

        def library():  # per site the 6-call yardstick and an add: 21 calls
            return [base + torch.bmm(torch.bmm(x.float(), a.index_select(0, ix)),
                                     b.index_select(0, ix)).to(x.dtype)
                    for a, b, base in sites]
        library_ms = cuda_ms(library)
        slots = len(set(idx))
        out_bytes = sum(B * C * d * 2 for d in douts)
        nbytes = (slots * sum(R * (Din + d) * 4 for d in douts) + x.numel() * 2
                  + 2 * out_bytes + B * 4)
        bound_ms, bound_by = bound(card, nbytes, sum(2 * B * C * R * (Din + d) + B * C * d
                                                     for d in douts))
        log(f"[4 timing] bgmv fused q/k/v olmo-1b {label} B={B} C={C} Din={Din} R={R} "
            f"Dout 3 x {douts[0]} bf16, bases read and written, {slots} distinct slots: "
            f"kernel {ms * 1e3:.1f} us in one launch, bound {bound_ms * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB, {bound_by}), plain {plain_ms * 1e3:.1f} us, "
            f"library (3 x (6 calls + an add)) "
            f"{library_ms * 1e3:.1f} us; {bound_ms / ms:.1%} of bound; "
            f"max_abs_err {err:.3g}")
    return out["decode"]


# B, H, KV, S, D, window: tests/test_kernels_flash.py:9-16's cases, then
# starcoder2-3b's heads (H=24 over KV=2, D=128) with its 4096 window: S 512
# and 2048 (the window never binds), 8192 (it binds), and an S that is no
# multiple of the kernels' row tiles; then the wgmma kernel's edges: one
# row, a tile plus one, groups of 8 and 12, a window binding at D=64
FLASH_CASES = [
    (2, 4, 2, 128, 64, 0), (1, 8, 1, 256, 32, 0), (2, 6, 6, 64, 64, 0),
    (1, 4, 2, 256, 64, 64), (1, 2, 2, 128, 128, 0),
    (1, 24, 2, 512, 128, 4096), (1, 24, 2, 2048, 128, 4096),
    (1, 24, 2, 8192, 128, 4096), (2, 24, 2, 300, 128, 4096),
    (1, 2, 2, 1, 128, 0), (2, 16, 2, 129, 64, 0), (1, 12, 1, 2053, 128, 1000),
    (1, 8, 1, 500, 64, 100),
    (2, 40, 8, 256, 128, 0),  # llama4-scout's fresh rows: G = 5, the serve's chunk
    # jamba-v0.1-52b's attention layer (G = 4, no RoPE): phase 5's fresh
    # B=2, C=256 step, which is also the serve's full fresh chunk; a ragged
    # one-row chunk of the serve's (its prompts of 128-256 tokens go whole);
    # a chunk of 512
    (2, 32, 8, 256, 128, 0), (1, 32, 8, 200, 128, 0), (2, 32, 8, 512, 128, 0)]
# f32 (the CUDA-core kernel): summation order only; bf16 and f16 (the
# wgmma kernel: bf16 P split into head and remainder, f16 P rounded once):
# tests/test_kernels_flash.py's bf16 tolerance
FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}
STARCODER_WINDOW = 4096


def flash_inputs(seed, B, H, KV, S, D, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]


def phase_kernel_flash():
    log("[3 kernel vs plain version on the card: flash_prefill]")
    for case in FLASH_CASES:
        B, H, KV, S, D, w = case
        for dtype in FLASH_ATOL:
            q, k, v = flash_inputs(1, B, H, KV, S, D, dtype)
            check(f"flash_prefill (B, H, KV, S, D, window) = {case} {str(dtype)[6:]}",
                  FLASH(q, k, v, scale=D ** -0.5, window=w),
                  flash_prefill_ref(q, k, v, scale=D ** -0.5, window=w), FLASH_ATOL[dtype])
            del q, k, v
        torch.cuda.empty_cache()
    # causality (tests/test_kernels_flash.py:33): perturbing keys and values
    # past position 40 leaves rows 0..39 as they were
    q, k, v = flash_inputs(2, 1, 2, 2, 64, 32, torch.float32)
    out1 = FLASH(q, k, v, scale=0.2)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] += 100.0
    v2[:, :, 40:] -= 50.0
    check("flash_prefill causality: rows < 40 unmoved", FLASH(q, k2, v2, scale=0.2)[:, :, :40],
          out1[:, :, :40], 1e-5)
    # the model's layouts read in place: (B, S, H, D) queries, (B, W, KV, D) windows
    x = torch.randn(2, 300, 24, 128, device="cuda", dtype=torch.bfloat16)
    win = torch.randn(2, 1024, 2, 128, device="cuda", dtype=torch.bfloat16)
    kk, vv = win[:, :300].transpose(1, 2), win[:, 500:800].transpose(1, 2)
    check("flash_prefill strided (B, S, H, D) / (B, W, KV, D) inputs",
          FLASH(x.transpose(1, 2), kk, vv, scale=0.1, window=100),
          flash_prefill_ref(x.transpose(1, 2).contiguous(), kk.contiguous(),
                            vv.contiguous(), scale=0.1, window=100),
          FLASH_ATOL[torch.bfloat16])
    torch.cuda.synchronize()


def live_pairs(S: int, window: int) -> int:
    """(i, j) pairs a causal S-row attention with this window computes."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def phase_timing_flash(card):
    """flash_prefill at starcoder2-3b's heads (H=24, KV=2, D=128, bf16): B=1
    causal at S=2048 (its 4096 window does not bind), B=1 at S=8192 where it
    does, and the serve's fresh extend chunk, B=2 at S=512. Bound: the
    larger of q, k, v read and o written once over HBM, and 4 * H * D flops
    per live (i, j) pair at the bf16 tensor-core rate. Library: one SDPA
    call (is_causal with enable_gqa; with the window, an explicit boolean
    mask over K/V repeated to H heads outside the timing)."""
    out = {}
    H, KV, D, w = 24, 2, 128, STARCODER_WINDOW
    for B, S in ((1, 2048), (1, 8192), (2, 512)):
        q, k, v = flash_inputs(5, B, H, KV, S, D, torch.bfloat16)
        scale = D ** -0.5
        got = FLASH(q, k, v, scale=scale, window=w)
        err = check(f"flash_prefill timed shape B={B} S={S} vs plain", got,
                    flash_prefill_ref(q, k, v, scale=scale, window=w),
                    FLASH_ATOL[torch.bfloat16])
        ms = cuda_ms(lambda: FLASH(q, k, v, scale=scale, window=w))
        plain_ms = cuda_ms(lambda: flash_prefill_ref(q, k, v, scale=scale, window=w),
                           reps=5 if S > 4096 else 20)
        if w >= S:
            def library():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      scale=scale, enable_gqa=True)
            lib_name = "SDPA(is_causal, enable_gqa)"
        else:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))

            def library():
                return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask,
                                                      scale=scale)
            lib_name = "SDPA(boolean window mask)"
        check(f"{lib_name} vs kernel B={B} S={S}", library(), got,
              FLASH_ATOL[torch.bfloat16])
        library_ms = cuda_ms(library)
        pairs = live_pairs(S, w)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * H * D * pairs
        bytes_ms, ops_ms = nbytes / card[1] * 1e3, flops / card[3] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[4 timing] flash_prefill B={B} H={H} KV={KV} S={S} D={D} window={w} "
            f"bf16 ({fmod.kernel_route(q.dtype, D)}): kernel {ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.1f} us ({flops / 1e9:.2f} GFLOP at {card[3] / 1e12:g} "
            f"TFLOP/s bf16 = {ops_ms * 1e3:.1f} us; {nbytes / 1e6:.1f} MB = "
            f"{bytes_ms * 1e3:.1f} us; {bound_by}), plain {plain_ms * 1e3:.1f} us, "
            f"{lib_name} {library_ms * 1e3:.1f} us; kernel / SDPA {ms / library_ms:.2f}; "
            f"{bound_ms / ms:.1%} of bound, {flops / ms / 1e9:.1f} TFLOP/s")
        out[B, S] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        del q, k, v, got
        torch.cuda.empty_cache()
    return out[1, 2048]


def build_olmo():
    t0 = time.perf_counter()
    model, params = olmo_model("bfloat16")
    cfg = model.cfg
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[5 model] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{nparam / 1e9:.2f} B params bf16, built in {time.perf_counter() - t0:.1f} s")
    return model, params


def model_steps(model, params, pages, tails, counter, patch, label, focus=()):
    """One decode and one ragged extend step at full width, kernel vs plain
    attention on the same inputs and the same page pools (``tails``: per
    step kind, per layer, the quantized path's fp tails), and one
    speculative verify against sequential decode steps, all on the kernel;
    the decode and extend steps then profiled, with the share of the
    kernels named in ``focus``."""
    cfg = model.cfg
    P, NP, B = 16, 64, 4
    rng = np.random.default_rng(6)
    NB = B * NP + 1  # block 0 is the scratch page
    tables = torch.tensor(rng.permutation(np.arange(1, NB))[: B * NP].reshape(B, NP),
                          dtype=torch.int64, device="cuda")

    def fresh(kind, copy=True):  # a compared run writes its own copy
        cp = (lambda x: x.clone()) if copy else (lambda x: x)  # noqa: E731
        if tails is None:
            return [{n: cp(x) for n, x in pg.items()} for pg in pages]
        return [{n: dict(pg[n], tail=cp(tails[kind][i][n])) for n in pg}
                for i, pg in enumerate(pages)]

    def run(step, kind, *args):
        before = counter.launches
        logits = step(params, args[0], fresh(kind), tables, *args[1:])[0]
        torch.cuda.synchronize()
        return logits.float(), counter.launches - before

    tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, 1)), device="cuda")
    lengths = torch.tensor([100, 300, 517, 1000], dtype=torch.int32, device="cuda")
    lk, n = run(model.decode_paged, "decode", tok, lengths)
    assert n == cfg.num_layers, n
    with patch():
        lp, _ = run(model.decode_paged, "decode", tok, lengths)
    assert lk.shape == (B, 1, cfg.vocab_size) and torch.isfinite(lk).all()
    check(f"{label}decode_paged logits, kernel vs plain", lk, lp, MODEL_ATOL)
    C = 64
    tokc = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, C)), device="cuda")
    lengthsc = torch.tensor(OLMO_EXTEND_LENGTHS, dtype=torch.int32, device="cuda")
    chunk_lens = torch.tensor(OLMO_CHUNK_LENS, dtype=torch.int32, device="cuda")
    lk, n = run(model.extend_paged, "extend", tokc, lengthsc, chunk_lens, 0)
    assert n == cfg.num_layers, n
    with patch():
        lp, _ = run(model.extend_paged, "extend", tokc, lengthsc, chunk_lens, 0)
    real = torch.arange(C, device="cuda")[None, :] < chunk_lens[:, None]
    assert torch.isfinite(lk[real]).all()
    check(f"{label}ragged extend_paged logits, kernel vs plain", lk[real], lp[real],
          MODEL_ATOL)
    # the speculative verify: one verify_paged over C = k + 1 (the kernel's
    # native chunked path) against C decode_paged steps on the kernel, which
    # write their K/V into one copy of the pages (or of the KIVI tail) in turn
    Cv = SPEC_K + 1
    tokv = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, Cv)), device="cuda")
    lengthsv = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device="cuda")
    lv, n = run(model.verify_paged, "verify", tokv, lengthsv)
    assert n == cfg.num_layers, n
    seq = fresh("verify")
    before = counter.launches
    ls = [model.decode_paged(params, tokv[:, j: j + 1], seq, tables, lengthsv + j)[0][:, 0]
          for j in range(Cv)]
    torch.cuda.synchronize()
    assert counter.launches - before == Cv * cfg.num_layers
    assert lv.shape == (B, Cv, cfg.vocab_size) and torch.isfinite(lv).all()
    check(f"{label}verify_paged C={Cv} vs {Cv} decode_paged steps, both on the kernel",
          lv, torch.stack(ls, 1), MODEL_ATOL)
    # where a full-width step's time goes (the kernel path; writes land in
    # the same slots on every call)
    dec, ext = fresh("decode", copy=False), fresh("extend", copy=False)
    device_profile(f"{label}decode_paged B={B}", lambda: model.decode_paged(
        params, tok, dec, tables, lengths), focus=focus)
    device_profile(f"{label}extend_paged B={B} C={C}", lambda: model.extend_paged(
        params, tokc, ext, tables, lengthsc, chunk_lens, 0), focus=focus)


def phase_model(model, params):
    """Full published width over fp pages."""
    P, NP, B = 16, 64, 4
    pages = model.init_pages(B * NP + 1, P)
    g = torch.Generator(device="cuda").manual_seed(6)
    for pg in pages:
        for x in pg.values():
            x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
    model_steps(model, params, pages, None, KERNEL, plain_attention, "", focus=PAGED_FOCUS)


def phase_model_quant(model, params):
    """Full published width over KIVI 8-bit pages: codes and f16 planes
    packed on the card from random pages, random bf16 tails of P + C slots."""
    cfg = model.cfg
    P, NP, B = 16, 64, 4
    pages = model.init_pages(B * NP + 1, P, quantized=True)
    g = torch.Generator(device="cuda").manual_seed(8)
    KV, D = cfg.num_kv_heads, cfg.head_dim
    for pg in pages:
        for name, axis in (("k", "channel"), ("v", "token")):
            fp = torch.randn(KV * (B * NP + 1), P, D, generator=g, device="cuda")
            for key, t in zip(("codes", "scale", "zero"),
                              quantize_pages_ref(fp, bits=8, axis=axis)):
                pg[name][key].copy_(t.reshape(pg[name][key].shape))
    tails = {kind: [{n: torch.randn(B, P + C, KV, D, generator=g, device="cuda")
                     .to(model.dtype) for n in ("k", "v")} for _ in pages]
             for kind, C in (("decode", 1), ("extend", 64), ("verify", SPEC_K + 1))}
    model_steps(model, params, pages, tails, QKERNEL, plain_quant_attention, "KIVI ",
                focus=QUANT_FOCUS)


def lora_operand(cfg, ids, max_loaded=2):
    """Full-width rank-8 tables on the card (a paged adapter store with
    ``max_loaded`` adapters from make_adapter seeds 1, 2, ...) and the rows'
    slots ``ids`` as one int32 tensor: the models' lora argument."""
    lora = LoRAConfig(rank=8, alpha=16.0, max_loaded_adapters=max_loaded)
    store = PagedAdapterStore(cfg, lora, BlockManager(1024, 16), 2 * 1024 * 1024,
                              device="cuda")
    names = [f"a{j}" for j in range(max_loaded)]
    for j, name in enumerate(names):
        store.registry.register(name, make_adapter(cfg, lora, seed=j + 1))
    store.ensure(names)
    assert [store.slot(n) for n in names] == list(range(1, max_loaded + 1))
    return {"ids": torch.tensor(ids, dtype=torch.int32, device="cuda"),
            "layers": store.tables}


def phase_model_lora(model, params):
    """Full published width over fp pages with LoRA slots [1, 2, 0, 1], in
    bf16 (the serving dtype) and in an f32 twin of the same weights. bf16:
    the null-slot row equals the LoRA-free step exactly, the adapter rows
    are apart from it, and one LoRA decode step is profiled. f32: logits
    with the bgmv kernel vs the plain bgmv within MODEL_ATOL_F32. In bf16
    the two differ wherever their f32 sums straddle a bf16 rounding
    boundary, and 16 layers of random rank-8 adapters carry those one-step
    differences on to the logits; that drift is printed, not gated."""
    cfg = model.cfg
    P, NP, B, C = 16, 64, 4, 64
    rng = np.random.default_rng(6)
    tables = torch.tensor(rng.permutation(np.arange(1, B * NP + 1)).reshape(B, NP),
                          dtype=torch.int64, device="cuda")
    ids = [1, 2, 0, 1]
    lora = lora_operand(cfg, ids)
    null, tenants = ids.index(0), [i for i, s in enumerate(ids) if s]
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, 1)), device="cuda")
    lengths = torch.tensor([100, 300, 517, 1000], dtype=torch.int32, device="cuda")
    tokc = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, C)), device="cuda")
    lengthsc = torch.tensor(OLMO_EXTEND_LENGTHS, dtype=torch.int32, device="cuda")
    chunk_lens = torch.tensor(OLMO_CHUNK_LENS, dtype=torch.int32, device="cuda")
    steps = [("decode_paged", "decode_paged",
              torch.ones(B, 1, dtype=torch.bool, device="cuda"), (tok, lengths)),
             ("ragged extend_paged", "extend_paged",
              torch.arange(C, device="cuda")[None, :] < chunk_lens[:, None],
              (tokc, lengthsc, chunk_lens, 0))]
    g = torch.Generator(device="cuda").manual_seed(6)
    pages = model.init_pages(B * NP + 1, P)
    for pg in pages:
        for x in pg.values():
            x.copy_(torch.randn(x.shape, generator=g, device="cuda"))

    def run(m, prm, pgs, name, args, **kw):
        before = BGMV_ADD.launches
        logits = getattr(m, name)(prm, args[0], [{n: x.clone() for n, x in pg.items()}
                                                 for pg in pgs], tables, *args[1:], **kw)[0]
        torch.cuda.synchronize()
        return logits.float(), BGMV_ADD.launches - before

    for label, name, rows, args in steps:
        lk, n = run(model, params, pages, name, args, lora=lora)
        base, _ = run(model, params, pages, name, args)
        with plain_bgmv():
            lp, _ = run(model, params, pages, name, args, lora=lora)
        assert n == 4 * cfg.num_layers, n  # q/k/v in one launch, wo, w1, w2
        assert torch.isfinite(lk[rows]).all()
        same = (lk[null] - base[null])[rows[null]].abs().max().item()
        apart = min((lk[i] - base[i])[rows[i]].abs().max().item() for i in tenants)
        drift = (lk[rows] - lp[rows]).abs().max().item()
        log(f"  LoRA {label} bf16: null-slot row vs lora=None max |diff| {same:g}; "
            f"adapter rows vs lora=None max |diff| >= {apart:.3g}; kernel vs plain "
            f"bgmv logits max |diff| {drift:.3g} (bf16 drift, not gated; logits max "
            f"|x| {lk[rows].abs().max().item():.3g}); {n} bgmv launches "
            f"(= 4 x {cfg.num_layers} layers)")
        assert same == 0.0 and apart > MODEL_ATOL, (same, apart)
    device_profile(f"LoRA decode_paged B={B}", lambda: model.decode_paged(
        params, tok, pages, tables, lengths, lora=lora), focus=("bgmv",) + PAGED_FOCUS)
    # the f32 twin: same weights, pages, adapters and inputs
    model32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                              param_dtype="float32"), device="cuda")
    params32 = _to_f32(params)
    pages32 = [{n: x.float() for n, x in pg.items()} for pg in pages]
    for label, name, rows, args in steps:
        lk, _ = run(model32, params32, pages32, name, args, lora=lora)
        with plain_bgmv():
            lp, _ = run(model32, params32, pages32, name, args, lora=lora)
        check(f"LoRA {label} f32 logits, kernel vs plain bgmv", lk[rows], lp[rows],
              MODEL_ATOL_F32)
    # the speculative verify with adapters: one verify_paged over C = k + 1
    # against C decode_paged steps, all on the kernels; gated in f32, the
    # bf16 drift printed (bgmv's sums in bf16 differ between C = 1 and C = 5
    # row tiles, as kernel and plain bgmv do above)
    Cv = SPEC_K + 1
    tokv = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, Cv)), device="cuda")
    lengthsv = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device="cuda")
    for dt, m, prm, pgs in (("bf16", model, params, pages),
                            ("f32", model32, params32, pages32)):
        lv = m.verify_paged(prm, tokv, [{n: x.clone() for n, x in pg.items()}
                                        for pg in pgs], tables, lengthsv, lora=lora)[0]
        seq = [{n: x.clone() for n, x in pg.items()} for pg in pgs]
        ls = torch.stack([m.decode_paged(prm, tokv[:, j: j + 1], seq, tables,
                                         lengthsv + j, lora=lora)[0][:, 0]
                          for j in range(Cv)], 1)
        torch.cuda.synchronize()
        label = f"LoRA verify_paged C={Cv} vs {Cv} decode_paged steps {dt}, on the kernels"
        if dt == "f32":
            check(label, lv, ls, MODEL_ATOL_F32)
        else:
            log(f"  {label}: max |diff| {(lv.float() - ls.float()).abs().max().item():.3g} "
                f"(bf16 drift, not gated); argmax equal on "
                f"{(lv.argmax(-1) == ls.argmax(-1)).float().mean().item():.1%} of "
                f"{B * Cv} positions")
    # the draft's LoRA catch-up: one sequence (B = 1, slot 1), a C = 32 chunk
    # from position 256 through verify_paged, kernel bgmv against plain bgmv
    # on the same positions; gated in f32, the bf16 drift printed
    Cc = CATCHUP_C[-1]
    tokc1 = torch.tensor(rng.integers(0, cfg.vocab_size, size=(1, Cc)), device="cuda")
    start1 = torch.tensor([256], dtype=torch.int32, device="cuda")
    lora1 = {"ids": lora["ids"][:1], "layers": lora["layers"]}
    for dt, m, prm, pgs in (("bf16", model, params, pages),
                            ("f32", model32, params32, pages32)):
        def catchup():
            return m.verify_paged(prm, tokc1, [{n: x.clone() for n, x in pg.items()}
                                               for pg in pgs], tables[:1], start1,
                                  lora=lora1)[0].float()
        before = BGMV_ADD.launches
        lk = catchup()
        n = BGMV_ADD.launches - before
        with plain_bgmv():
            lp = catchup()
        torch.cuda.synchronize()
        assert n == 4 * cfg.num_layers, n
        label = (f"LoRA catch-up verify_paged B=1 C={Cc} from 256 {dt}, kernel vs "
                 f"plain bgmv")
        if dt == "f32":
            check(label, lk, lp, MODEL_ATOL_F32)
        else:
            log(f"  {label}: max |diff| {(lk - lp).abs().max().item():.3g} (bf16 drift, "
                f"not gated); argmax equal on {(lk.argmax(-1) == lp.argmax(-1)).float().mean().item():.1%} "
                f"of {Cc} positions; {n} bgmv launches")
    del model32, params32, pages32


def phase_model_starcoder():
    """starcoder2-3b at its published width (30 layers, d_model 3072, 24
    query heads over 2 KV heads, window 4096), random bf16 weights from
    seed 0: two gathered ``Model.extend`` steps over 1024-slot windows — a
    fresh batch (B=2, C=512) and a mixed one (fresh rows of 512 and 300
    tokens beside continuation rows of one token at 700 and 1000). Logits
    with the flash_prefill kernel vs with its plain version: gated in an f32
    twin of the same weights and windows (MODEL_ATOL_F32), printed in bf16;
    each bf16 step profiled with flash_prefill's share of the busy time."""
    cfg = configs.get_config("starcoder2-3b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[5 model] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, window "
        f"{cfg.sliding_window}, {nparam / 1e9:.2f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    W, C = 1024, 512
    rng = np.random.default_rng(9)
    g = torch.Generator(device="cuda").manual_seed(9)
    steps = []
    for label, cache_len, lens in (("fresh B=2 C=512", [0, 0], [512, 512]),
                                   ("mixed B=4 C=512", [0, 700, 0, 1000], [512, 1, 300, 1])):
        B = len(lens)
        win = model.init_cache(B, W)
        for layer in win:
            for x in layer.values():
                x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        steps.append((label, win, torch.tensor(
            rng.integers(0, cfg.vocab_size, size=(B, C)), device="cuda"),
            torch.tensor(cache_len, dtype=torch.int32, device="cuda"),
            torch.arange(C, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]))

    def run(m, prm, win, tok, cl):
        cache = [{n: x.clone() for n, x in layer.items()} for layer in win]
        before = FLASH.launches
        logits = m.extend(prm, tok, cache, cl)[0]
        torch.cuda.synchronize()
        return logits.float(), FLASH.launches - before

    drift = {}
    for label, win, tok, cl, real in steps:
        lk, n = run(model, params, win, tok, cl)
        assert n == cfg.num_layers, n
        assert lk.shape == (len(cl), C, cfg.vocab_size) and torch.isfinite(lk[real]).all()
        with plain_flash():
            lp, _ = run(model, params, win, tok, cl)
        drift[label] = ((lk[real] - lp[real]).abs().max().item(),
                        lk[real].abs().max().item())
        del lk, lp
    for label, win, tok, cl, real in steps:
        cache = [{n: x.clone() for n, x in layer.items()} for layer in win]
        device_profile(f"{cfg.name} extend {label} bf16", lambda: model.extend(
            params, tok, cache, cl), focus="flash_prefill")
        del cache
    model32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                              param_dtype="float32"), device="cuda")
    params32 = _to_f32(params)
    del params
    torch.cuda.empty_cache()
    for label, win, tok, cl, real in steps:
        win32 = [{n: x.float() for n, x in layer.items()} for layer in win]
        lk, _ = run(model32, params32, win32, tok, cl)
        with plain_flash():
            lp, _ = run(model32, params32, win32, tok, cl)
        check(f"{cfg.name} extend {label} f32 logits, kernel vs plain flash_prefill",
              lk[real], lp[real], MODEL_ATOL_F32)
        log(f"    bf16: kernel vs plain logits max |diff| {drift[label][0]:.3g} "
            f"(bf16 drift, not gated; logits max |x| {drift[label][1]:.3g})")
        del win32, lk, lp
    del model32, params32, steps
    torch.cuda.empty_cache()


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def olmo_model(dtype):
    """olmo-1b at published width, random weights from seed 0, in ``dtype``."""
    cfg = configs.get_config("olmo-1b")
    cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    model = build_model(cfg, device="cuda")
    return model, model.init(0)


def equal_share(streams, ref):
    """Tokens of ``streams`` equal to ``ref``'s, over each request's common
    prefix; and the total."""
    same = sum(next((i for i, (a, b) in enumerate(zip(g, ref[rid])) if a != b),
                    len(ref[rid])) for rid, g in streams.items())
    return same, sum(len(g) for g in streams.values())


def serve_engine(kv_quant=None, lora=None, **kw):
    return build_engine(
        "olmo-1b", debug=False, device="cuda", max_model_len=1024,
        num_blocks=640, block_size=16, kv_quant=kv_quant, lora=lora,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=256,
                                  prefill_chunk=64), **kw)


def add_traffic(engine, rng, prefix, adapters=(None,), n=8, prompt=(128, 512), gen=32):
    """``n`` requests (8), prompts of ``prompt`` (128-512) random tokens,
    ``gen`` (32) greedy tokens each; request i names adapter
    ``adapters[i % len(adapters)]``."""
    vocab = engine.model.cfg.vocab_size
    for i in range(n):
        ln = int(rng.integers(prompt[0], prompt[1] + 1))
        engine.add_request(Request(
            request_id=f"{prefix}{i}", prompt=[int(x) for x in rng.integers(2, vocab, ln)],
            adapter_id=adapters[i % len(adapters)],
            sampling=SamplingParams(temperature=0.0, max_new_tokens=gen)))


def run_served(engine, counters, paged=True, n=8, gen=32):
    """Serve the queued traffic (``n`` requests of ``gen`` tokens) with
    every kernel count set to 0 just before; returns (metrics, seconds,
    launches by kernel). ``paged``: every step ran on the paged backend,
    with no window staging; None: some dispatches ran on each backend
    (chunks carrying images gathered, the rest paged); else every step ran
    gathered (a state stack's exact-chunk steps in one dispatch per chunk
    length)."""
    for k in counters.values():
        k.launches = 0  # the main path's count starts here
    t0 = time.perf_counter()
    metrics = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    cfg = engine.model.cfg
    assert len(metrics) == n and all(m.num_generated == gen for m in metrics), \
        [m.num_generated for m in metrics]
    assert all(0 <= tok < cfg.vocab_size for s in engine.seqs.values()
               for tok in s.generated)
    if paged is None:
        assert engine.paged_steps > 0 and engine.runner.steps > 0
        assert engine.host_copy_bytes > 0
    elif paged:
        assert engine.host_copy_bytes == 0, engine.host_copy_bytes
        if engine.spec_runner is None:
            assert engine.paged_steps == engine.steps > 0
        else:  # each step dispatched a speculative group, a paged one or both
            snap = engine.metrics_snapshot()
            assert snap["engine.dispatch.paged"] + snap["engine.dispatch.speculative"] \
                >= engine.steps > 0, snap
    else:
        assert engine.paged_steps == 0 and engine.steps > 0
        if engine.scheduler.cfg.exact_chunks:
            assert engine.runner.steps >= engine.steps
        else:
            assert engine.runner.steps == engine.steps
        assert engine.host_copy_bytes > 0
    return metrics, dt, launches


def traced_rerun(engine, rng, adapters=(None,), *, label):
    """The same traffic again (fresh prompts) on a second engine over the
    same model, weights, adapters and settings, built with
    ``TelemetryConfig()``: host-clock spans per engine layer
    (``tail_upload`` and ``writeback`` run inside ``dispatch``,
    ``lora_fault`` before it); the untraced run gives the end-to-end
    numbers. The Chrome trace goes to ``build/chip_smoke_trace_<label>.json``
    and ``tools/trace_summary.py`` reads it back (exit 0 or the phase
    fails); its decode roofline line is printed: live tokens/s of the paged
    decode dispatches against ``launch/roofline.py``'s bound on this card."""
    traced = LLMEngine(engine.model, engine.params,
                       dataclasses.replace(engine.cfg, telemetry=TelemetryConfig()))
    if engine.adapters is not None:
        reg = engine.adapters.registry
        for aid in reg.ids():
            traced.register_adapter(aid, reg.get(aid))
    add_traffic(traced, rng, "t", adapters)
    t0 = time.perf_counter()
    metrics = traced.run()
    torch.cuda.synchronize()
    dt_traced = time.perf_counter() - t0
    spans = {}
    for e in traced.trace.events:
        if e.dur is not None and not e.track.startswith("batch.row"):
            key = e.name if e.name != "dispatch" else f"dispatch[{e.args['phase']}]"
            n_, us = spans.get(key, (0, 0.0))
            spans[key] = (n_ + 1, us + e.dur)
    log(f"  traced rerun: {sum(m.num_generated for m in metrics)} generated tokens in "
        f"{dt_traced:.2f} s over {traced.steps} steps; host-clock spans: "
        + ", ".join(f"{k} {n_}x {us / 1e3:.0f} ms"
                    for k, (n_, us) in sorted(spans.items(), key=lambda kv: -kv[1][1])))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = write_chrome_trace(
        os.path.join(ROOT, "build", f"chip_smoke_trace_{label}.json"), traced.trace,
        metadata={"arch": engine.model.cfg.name, "backend": engine.cfg.execution_backend,
                  "device": torch.cuda.get_device_name(engine.device)})
    summary = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                              path], capture_output=True, text=True, check=True,
                             timeout=300).stdout
    roof = next(line for line in summary.splitlines() if line.startswith("decode roofline"))
    log(f"  trace {os.path.relpath(path, ROOT)} ({len(traced.trace.events)} events), "
        f"tools/trace_summary.py exit 0: {roof}")
    del traced
    return spans


COUNTERS = {"paged_attention": KERNEL, "paged_attention_quant": QKERNEL,
            "quantize_pages": PACK, "dequantize_pages": UNPACK, "bgmv": BGMV_ADD,
            "flash_prefill": FLASH}


def phase_serve():
    engine = serve_engine()
    cfg = engine.model.cfg
    rng = np.random.default_rng(7)
    add_traffic(engine, rng, "r")
    metrics, dt, counts = run_served(engine, COUNTERS)
    launches = counts["paged_attention"]
    gen = sum(m.num_generated for m in metrics)
    assert launches == cfg.num_layers * engine.paged_steps, \
        (launches, engine.paged_steps)
    assert counts["paged_attention_quant"] == counts["quantize_pages"] == 0, counts
    assert counts["bgmv"] == counts["flash_prefill"] == 0, counts
    ttft = statistics.median(m.ttft for m in metrics)
    prompt = sum(m.num_prompt for m in metrics)
    log(f"[6 serve] {cfg.name} full width: 8 requests, {prompt} prompt + {gen} "
        f"generated tokens in {dt:.2f} s = {gen / dt:.1f} generated tok/s, "
        f"TTFT p50 {ttft * 1e3:.0f} ms, {engine.steps} steps "
        f"({engine.paged_steps} paged), {launches} kernel launches "
        f"(= {cfg.num_layers} x steps), host_copy_bytes 0")
    streams = {rid: list(s.generated) for rid, s in engine.seqs.items()}
    traced_rerun(engine, rng, label="fp")
    return counts, gen / dt, ttft, streams


def phase_serve_quant():
    """The same 8-request traffic on KIVI 8-bit pages."""
    qc = QuantConfig(bits=8)
    engine = serve_engine(kv_quant=qc)
    cfg, store, runner = engine.model.cfg, engine.store, engine.paged_runner
    assert store.quantized
    rng = np.random.default_rng(7)  # the fp serve's prompts, then its rerun's
    add_traffic(engine, rng, "r")
    by_kind = {"decode": 0, "extend": 0}
    op = ops.paged_decode_attention_quant

    def recorded(*args, rows_per_seq=1, **kw):  # the kernel's calls, by step kind
        by_kind["extend" if rows_per_seq > 1 else "decode"] += 1
        return op(*args, rows_per_seq=rows_per_seq, **kw)
    packs = []  # (elements, staging bytes per element, pages, axis) per pack call
    pack_op = state_mod.quantize_kv_pages

    def recorded_pack(x, *, axis, **kw):
        packs.append((x.numel(), x.element_size(), x.shape[0], axis, x.dtype))
        return pack_op(x, axis=axis, **kw)
    with mock.patch.object(ops, "paged_decode_attention_quant", recorded), \
            mock.patch.object(state_mod, "quantize_kv_pages", recorded_pack):
        metrics, dt, counts = run_served(engine, COUNTERS)
    gen = sum(m.num_generated for m in metrics)
    assert counts["paged_attention_quant"] == cfg.num_layers * engine.paged_steps \
        == sum(by_kind.values()), (counts, engine.paged_steps, by_kind)
    assert counts["paged_attention"] == counts["bgmv"] == counts["flash_prefill"] == 0, \
        counts
    assert counts["quantize_pages"] == len(packs) >= 1, (counts, len(packs))
    # the pack's round trip: staging pages up in their own dtype (bf16), codes
    # and f16 planes back; before, the pages went up as f32
    P, D = store.cfg.block_size, cfg.head_dim
    assert {p[4] for p in packs} == {store.dtype}, {p[4] for p in packs}
    planes = sum(2 * n * (D if axis == "channel" else P) * 2 for _, _, n, axis, _ in packs)
    want = sum(e * (isz + 1) for e, isz, _, _, _ in packs) + planes
    as_f32 = sum(e * (4 + 1) for e, _, _, _, _ in packs) + planes
    assert store.pack_transfer_bytes == want, (store.pack_transfer_bytes, want)
    ttft = statistics.median(m.ttft for m in metrics)
    ratio = store.kv_fp16_bytes_per_block() / store.kv_bytes_per_block()
    log(f"[6 serve] {cfg.name} full width, kv_quant {qc.bits}-bit: 8 requests, {gen} "
        f"generated tokens in {dt:.2f} s = {gen / dt:.1f} generated tok/s, TTFT p50 "
        f"{ttft * 1e3:.0f} ms, {engine.steps} steps ({engine.paged_steps} paged); "
        f"launches: paged_attention_quant {counts['paged_attention_quant']} "
        f"(= {cfg.num_layers} x steps: {by_kind['decode']} in decode steps, "
        f"{by_kind['extend']} in steps with a chunk of C > 1), quantize_pages "
        f"{counts['quantize_pages']}, paged_attention {counts['paged_attention']}, "
        f"dequantize_pages "
        f"{counts['dequantize_pages']}; tail_upload_bytes {runner.tail_upload_bytes}, "
        f"mirror_upload_bytes {runner.mirror_upload_bytes}, pack_transfer_bytes "
        f"{store.pack_transfer_bytes} (= the formula for {str(store.dtype)[6:]} pages up, "
        f"codes and f16 planes down, over {sum(p[2] for p in packs)} pages; "
        f"{as_f32} with f32 pages up), writeback_bytes {runner.writeback_bytes}, "
        f"host_copy_bytes 0; {store.kv_bytes_per_block()} "
        f"B per block vs {store.kv_fp16_bytes_per_block()} B as fp16 pages = "
        f"{ratio:.3f}x capacity")
    streams = {rid: list(s.generated) for rid, s in engine.seqs.items()}
    spans = traced_rerun(engine, rng, label="kivi8")
    n_wb, wb_us = spans.get("writeback", (0, 0.0))
    log(f"  KIVI traced rerun: writeback span {n_wb}x {wb_us / 1e3:.1f} ms (the page "
        "writes to host staging and the packs' round trips)")
    return counts, streams


def phase_serve_lora(fp_rate, fp_ttft):
    """The same 8-request traffic over fp pages with multi-tenant LoRA: rank
    8 adapters a0..a3 registered, a store of 2 slots, requests cycling over
    a0, a1, a2, a3 and no adapter, so adapters fault in and evict while
    serving."""
    lora = LoRAConfig(rank=8, alpha=16.0, max_loaded_adapters=2)
    engine = serve_engine(lora=lora)
    cfg, store = engine.model.cfg, engine.adapters
    names = [f"a{j}" for j in range(4)]
    for j, name in enumerate(names):
        engine.register_adapter(name, make_adapter(cfg, lora, seed=j + 1))
    rng = np.random.default_rng(7)  # the fp serve's prompts
    add_traffic(engine, rng, "r", adapters=names + [None])
    metrics, dt, counts = run_served(engine, COUNTERS)
    gen = sum(m.num_generated for m in metrics)
    steps = engine.paged_steps
    snap = engine.metrics_snapshot()
    # q/k/v share one launch, then wo, w1 and w2: 4 a layer
    assert counts["bgmv"] == 4 * cfg.num_layers * steps, (counts, steps)
    assert counts["paged_attention"] == cfg.num_layers * steps, (counts, steps)
    assert counts["paged_attention_quant"] == counts["quantize_pages"] == 0, counts
    assert counts["flash_prefill"] == 0, counts
    assert snap["lora.misses"] >= 4 and snap["lora.evictions"] >= 2, snap
    assert store.pages_per_adapter == 11, store.pages_per_adapter
    assert snap["lora.rented_pages"] == 11 * len(store.loaded), snap
    ttft = statistics.median(m.ttft for m in metrics)
    log(f"[6 serve] {cfg.name} full width, LoRA rank {lora.rank} x 4 adapters over "
        f"{lora.max_loaded_adapters} slots: 8 requests, {gen} generated tokens in "
        f"{dt:.2f} s = {gen / dt:.1f} generated tok/s (fp serve above: {fp_rate:.1f}), "
        f"TTFT p50 {ttft * 1e3:.0f} ms (fp: {fp_ttft * 1e3:.0f}), {engine.steps} steps "
        f"({steps} paged); launches: bgmv {counts['bgmv']} (= 4 x {cfg.num_layers} x "
        f"steps), paged_attention {counts['paged_attention']} (= {cfg.num_layers} x "
        f"steps); lora hits {snap['lora.hits']}, misses {snap['lora.misses']}, "
        f"evictions {snap['lora.evictions']}, loads {snap['lora.loads']} "
        f"({snap['lora.load_bytes'] / 1e6:.1f} MB), {snap['lora.rented_pages']} pages "
        f"rented (= {store.pages_per_adapter} x {len(store.loaded)} resident); "
        f"preemptions {snap['engine.preemptions']}, host_copy_bytes 0")
    streams = {rid: list(s.generated) for rid, s in engine.seqs.items()}
    traced_rerun(engine, rng, adapters=names + [None], label="lora")
    return counts, streams


def phase_serve_spec(label, ref_streams, fp_rate, *, kv_quant=None, lora=None,
                     draft_seed=None, min_acceptance=0.0, window=64, traced=False,
                     plain_packs=None):
    """The fp serve's 8-request traffic with speculative decoding at k =
    SPEC_K: the target drafts for itself unless ``draft_seed`` gives the
    draft other weights. Each kernel's launches are held to the engine's
    counts: every paged dispatch runs L layers of the target's attention, a
    speculative step k + 1 draft decode steps (fp draft pages) and one
    verify, a draft catch-up call L layers; with LoRA every one of them
    launches bgmv 4 times a layer. Prints the end-to-end numbers, the
    acceptance and the share of tokens equal to each serve's streams in
    ``ref_streams`` (label -> streams; each request's common prefix)."""
    names = [f"a{j}" for j in range(4)] if lora is not None else []
    engine = serve_engine(kv_quant=kv_quant, lora=lora, draft_seed=draft_seed,
                          speculative=SpeculativeConfig(
                              num_draft_tokens=SPEC_K, min_acceptance=min_acceptance,
                              window=window))
    cfg, runner = engine.model.cfg, engine.spec_runner
    for j, name in enumerate(names):
        engine.register_adapter(name, make_adapter(cfg, lora, seed=j + 1))
    rng = np.random.default_rng(7)  # the fp serve's prompts
    adapters = tuple(names) + (None,)
    add_traffic(engine, rng, "r", adapters=adapters)
    metrics, dt, counts = run_served(engine, COUNTERS)
    st, snap = engine.spec_stats, engine.metrics_snapshot()
    L, k, S = cfg.num_layers, SPEC_K, st.steps
    paged, calls = snap["engine.dispatch.paged"], runner.draft_catchup_calls
    assert S > 0 and S == snap["engine.dispatch.speculative"] == runner.steps, (S, snap)
    draft = L * (S * (k + 1) + calls)  # draft decode steps and catch-up calls
    if kv_quant is None:
        want = {"paged_attention": L * (paged + S) + draft}
    else:
        want = {"paged_attention": draft, "paged_attention_quant": L * (paged + S)}
    want["bgmv"] = 4 * (L * (paged + S) + draft) if lora is not None else 0
    for name, n in want.items():
        assert counts[name] == n, (name, counts[name], n, paged, S, calls)
    assert counts["flash_prefill"] == counts["dequantize_pages"] == 0, counts
    if kv_quant is None:
        assert counts["paged_attention_quant"] == counts["quantize_pages"] == 0, counts
    if min_acceptance:
        assert st.disabled_at_step is not None, st
        assert engine.scheduler.cfg.speculative_tokens == 0
    gen = sum(m.num_generated for m in metrics)
    shares = []
    for ref_label, streams in ref_streams.items():
        same, _ = equal_share({rid: s.generated for rid, s in engine.seqs.items()}, streams)
        shares.append(f"{ref_label}'s {same} of {gen} ({same / gen:.1%})")
    ttft = statistics.median(m.ttft for m in metrics)
    extra = (f", disabled at step {st.disabled_at_step}"
             if st.disabled_at_step is not None else "")
    quant = (f"; quantize_pages {counts['quantize_pages']} (the plain KIVI serve's: "
             f"{plain_packs})" if kv_quant is not None else "")
    log(f"[6 serve] {cfg.name} full width, speculative k={k}, {label}: 8 requests, "
        f"{gen} generated tokens in {dt:.2f} s = {gen / dt:.1f} generated tok/s (fp serve "
        f"above: {fp_rate:.1f}), TTFT p50 {ttft * 1e3:.0f} ms, {engine.steps} steps, "
        f"{S} speculative steps ({paged} paged dispatches); acceptance "
        f"{st.acceptance_rate:.3f}, {st.tokens_per_step:.2f} tokens per speculative "
        f"step{extra}; draft catch-up {snap['runner.spec.draft_catchup_tokens']} tokens "
        f"in {calls} calls, {snap['runner.spec.draft_resets']} resets; tokens equal to "
        f"the streams of (common prefixes) " + ", ".join(shares) + "; "
        f"launches: " + ", ".join(f"{name} {counts[name]} (= {n})"
                                  for name, n in want.items()) + quant
        + f"; preemptions {snap['engine.preemptions']}, host_copy_bytes 0")
    if traced:
        traced_rerun(engine, rng, adapters=adapters, label="spec_fp")
    return counts


def phase_serve_spec_lora_f32():
    """The LoRA serve and its self-speculation (k = SPEC_K) again with an
    f32 olmo-1b at full width (weights from seed 0, f32 pages: the paged
    kernels' CUDA-core route and bgmv's f32 instances), on the same traffic.
    In bf16 the verify's and the draft's sums round apart and random rank-8
    adapters carry that on; in f32 a self-draft must propose what the target
    verifies, and the streams must be the plain serve's. A wrong draft K/V
    from the LoRA catch-up, or a row given another row's adapter, would show
    here as low acceptance or parted streams."""
    lora = LoRAConfig(rank=8, alpha=16.0, max_loaded_adapters=2)
    model, params = olmo_model("float32")
    cfg = model.cfg
    names = [f"a{j}" for j in range(4)]
    out = {}
    for spec in (None, SpeculativeConfig(num_draft_tokens=SPEC_K)):
        engine = LLMEngine(model, params, EngineConfig(
            block_size=16, num_blocks=640, max_model_len=1024, device="cuda",
            lora=lora, speculative=spec, scheduler=SchedulerConfig(
                max_batch_slots=8, max_batched_tokens=256, prefill_chunk=64)))
        for j, name in enumerate(names):
            engine.register_adapter(name, make_adapter(cfg, lora, seed=j + 1))
        add_traffic(engine, np.random.default_rng(7), "r", adapters=names + [None])
        metrics, dt, _ = run_served(engine, COUNTERS)
        out[spec is not None] = (engine, metrics, dt)
    (plain, pm, pdt), (engine, metrics, dt) = out[False], out[True]
    st, snap = engine.spec_stats, engine.metrics_snapshot()
    gen = sum(m.num_generated for m in metrics)
    same, _ = equal_share({rid: s.generated for rid, s in engine.seqs.items()},
                          {rid: s.generated for rid, s in plain.seqs.items()})
    log(f"[6 serve] {cfg.name} full width f32, LoRA rank {lora.rank} x 4 adapters over "
        f"{lora.max_loaded_adapters} slots: plain {gen / pdt:.1f} generated tok/s; "
        f"speculative k={SPEC_K}, self-speculation {gen / dt:.1f} tok/s, {st.steps} "
        f"speculative steps, acceptance {st.acceptance_rate:.3f}, {st.tokens_per_step:.2f} "
        f"tokens per speculative step; draft catch-up "
        f"{snap['runner.spec.draft_catchup_tokens']} tokens in "
        f"{engine.spec_runner.draft_catchup_calls} calls; tokens equal to the plain f32 "
        f"LoRA serve's streams (common prefixes) {same} of {gen} ({same / gen:.1%}); "
        f"lora evictions {snap['lora.evictions']}")
    assert st.steps > 0 and st.acceptance_rate >= 0.9, st
    assert same >= 0.9 * gen, (same, gen)
    del plain, engine, model, params


# ---------------------------------------------------------------------------
# phases 7-8: KV migration — disaggregated prefill/decode and the fleet
# ---------------------------------------------------------------------------
def migration_cfg(**kw):
    """``serve_engine``'s settings with the prefix cache off, for engines
    that share one model."""
    return EngineConfig(block_size=16, num_blocks=640, max_model_len=1024, device="cuda",
                        enable_prefix_cache=False, scheduler=SchedulerConfig(
                            max_batch_slots=8, max_batched_tokens=256, prefill_chunk=64),
                        **kw)


def mirror_block(runner, block):
    """One block of the paged runner's device mirror in ``block_payload``'s
    order: each leaf's fp page, or its KIVI (codes, scale, zero)."""
    out = []
    for layer, name, idx in runner.store.attn_kv_leaves():
        dev = runner._pages[layer][name]
        if idx in runner.store.qplanes:
            out.append(tuple(dev[k][:, block].cpu() for k in ("codes", "scale", "zero")))
        else:
            out.append(dev[:, block].cpu())
    return out


def payload_nbytes(payload):
    """A migration payload's page bytes: fp pages, or KIVI codes, planes and
    the staging page of a block still filling (not the packed flag)."""
    return sum(t.numel() * t.element_size() for page in payload["blocks"]
               for leaf in page if not isinstance(leaf, bool)
               for t in (leaf if isinstance(leaf, tuple) else (leaf,)))


class MigrationProbe:
    """Instruments the engines of a ``DisaggregatedServer`` or a
    ``ServingFleet`` through instance attributes over their methods: each
    ``export_seq`` + ``import_seq`` pair's host time, each payload's blocks
    and bytes and the destination's ``last_import_bytes``, the plan of every
    engine step; at each destination's next mirror sync, the imported
    blocks in its device mirror are held byte for byte against the payload
    (``check_s``: the seconds that check takes, to be taken out of the
    serve's time), and a migrated adapter-bound sequence scheduled in that
    step is confirmed when its adapter is loaded there."""

    def __init__(self, engines):
        self.host_s, self.blocks, self.payload_bytes, self.import_bytes = [], [], [], []
        self.filling = []  # KIVI blocks still filling per payload (staging shipped)
        self.plans = {id(e): [] for e in engines}
        self.adapter_confirmed = []  # (engine, request id, adapter id)
        self.checked_blocks, self.check_s = 0, 0.0
        self._t_export = 0.0
        for eng in engines:
            self._wrap(eng)

    def _wrap(self, eng):
        export, import_ = eng.export_seq, eng.import_seq
        plan, sync = eng.scheduler.plan, eng.paged_runner.sync
        pending, bound = [], {}  # (rid, table, blocks) to check; rid -> adapter

        def export_seq(rid):
            self._t_export = time.perf_counter()
            pending[:] = [p for p in pending if p[0] != rid]
            bound.pop(rid, None)
            return export(rid)

        def import_seq(payload):
            seq = import_(payload)
            self.host_s.append(time.perf_counter() - self._t_export)
            self.blocks.append(len(payload["blocks"]))
            self.payload_bytes.append(payload_nbytes(payload))
            self.filling.append(sum(isinstance(page[-1], bool) and not page[-1]
                                    for page in payload["blocks"]))
            self.import_bytes.append(eng.last_import_bytes)
            pending.append((seq.request_id, list(seq.block_table), payload["blocks"]))
            if seq.request.adapter_id is not None:
                bound[seq.request_id] = seq.request.adapter_id
            return seq

        def recorded_plan(now=0.0):
            p = plan(now)
            self.plans[id(eng)].append(p)
            return p

        def checked_sync():
            sync()
            for rid, aid in list(bound.items()):
                if rid in (eng._step_inflight or ()) and eng.adapters.is_loaded(aid):
                    self.adapter_confirmed.append((eng, rid, aid))
                    del bound[rid]
            if not pending:
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _, table, blocks in pending:
                for b, page in zip(table, blocks):
                    for got, want in zip(mirror_block(eng.paged_runner, b), page):
                        got = got if isinstance(got, tuple) else (got,)
                        want = want[:3] if isinstance(want, tuple) else (want,)
                        assert all(g.dtype == w.dtype and torch.equal(g, w)
                                   for g, w in zip(got, want)), (b, table)
                    self.checked_blocks += 1
            pending.clear()
            self.check_s += time.perf_counter() - t0

        eng.export_seq, eng.import_seq = export_seq, import_seq
        eng.scheduler.plan, eng.paged_runner.sync = recorded_plan, checked_sync


def run_migrating(server, counters):
    """Serve the queued traffic through a ``DisaggregatedServer`` or a
    ``ServingFleet`` with every kernel count set to 0 just before; returns
    (metrics, seconds, launches by kernel). Every request finishes with 32
    in-vocabulary tokens; no engine stages a window."""
    for k in counters.values():
        k.launches = 0  # the main path's count starts here
    t0 = time.perf_counter()
    metrics = server.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    engines = getattr(server, "engines", None) or (server.prefill_engine,
                                                    server.decode_engine)
    vocab = engines[0].model.cfg.vocab_size
    assert len(metrics) == 8 and all(m.num_generated == 32 for m in metrics), \
        [m.num_generated for m in metrics]
    assert all(0 <= tok < vocab for s in server.seqs.values() for tok in s.generated)
    for eng in engines:
        assert eng.host_copy_bytes == 0 and eng.paged_steps == eng.steps, eng.steps
    return metrics, dt, launches


def phase_disagg(model, params, ref_label, ref_streams, kv_quant=None, fp_bytes=None):
    """Phase 7a (fp pages) / 7c (``kv_quant``: KIVI pages): phase 6's
    8-request traffic through a ``DisaggregatedServer`` whose two engines
    share ``model``. Holds: 8 migrations, whose bytes are the payloads'
    (fp: blocks x ``kv_bytes_per_block``); the prefill engine planned no
    decode chunk and the decode engine no chunk longer than one token; each
    attention kernel's launches = layers x both engines' paged steps (KIVI:
    one pack launch per pack call); every migrated block in the decode
    engine's device mirror byte-equal to its payload after the next sync."""
    srv = DisaggregatedServer(model, params, prefill_cfg=migration_cfg(kv_quant=kv_quant),
                              decode_cfg=migration_cfg(kv_quant=kv_quant))
    pre, dec = srv.prefill_engine, srv.decode_engine
    cfg, L = model.cfg, model.cfg.num_layers
    probe = MigrationProbe((pre, dec))
    add_traffic(pre, np.random.default_rng(7), "r")  # srv.add_request is pre's
    packs = []
    pack_op = state_mod.quantize_kv_pages

    def recorded_pack(x, **kw):
        packs.append(x.shape[0])
        return pack_op(x, **kw)
    with mock.patch.object(state_mod, "quantize_kv_pages", recorded_pack):
        metrics, dt, counts = run_migrating(srv, COUNTERS)
    dt -= probe.check_s
    st = srv.stats
    assert st.migrated == len(probe.blocks) == 8, (st, len(probe.blocks))
    assert st.transfer_bytes == sum(probe.import_bytes) == sum(probe.payload_bytes), st
    if kv_quant is None:
        assert st.transfer_bytes == sum(probe.blocks) * dec.store.kv_bytes_per_block(), st
    assert probe.checked_blocks == sum(probe.blocks), (probe.checked_blocks, probe.blocks)
    assert not any(p.decode for p in probe.plans[id(pre)])
    assert all(c.length == 1 for p in probe.plans[id(dec)] for c in p.chunks)
    assert not pre.seqs and len(dec.finished) == 8
    steps = pre.paged_steps + dec.paged_steps
    kernel = "paged_attention" if kv_quant is None else "paged_attention_quant"
    assert counts[kernel] == L * steps, (counts, pre.paged_steps, dec.paged_steps)
    assert counts["quantize_pages"] == len(packs) and (kv_quant is None) == (not packs), \
        (counts, len(packs))
    assert all(n == 0 for k, n in counts.items()
               if k not in (kernel, "quantize_pages")), counts
    gen = sum(m.num_generated for m in metrics)
    ttft = statistics.median(m.ttft for m in metrics)
    gaps = [b - a for m in metrics for a, b in zip(m.token_times[1:], m.token_times[2:])]
    streams = {rid: list(s.generated) for rid, s in srv.seqs.items()}
    same, total = equal_share(streams, ref_streams)
    kind = "fp pages" if kv_quant is None else f"KIVI {kv_quant.bits}-bit pages"
    log(f"[{'7a' if kv_quant is None else '7c'} disagg] {cfg.name} full width, {kind}, "
        f"prefill + decode engine on one model: 8 requests, {gen} generated tokens in "
        f"{dt:.2f} s = {gen / dt:.1f} generated tok/s (mirror checks of "
        f"{probe.check_s:.2f} s taken out), TTFT p50 {ttft * 1e3:.0f} ms; decode engine "
        f"inter-token gap p50 {statistics.median(gaps) * 1e3:.1f} ms, max "
        f"{max(gaps) * 1e3:.1f} ms; {st.migrated} migrations, {sum(probe.blocks)} blocks, "
        f"transfer_bytes {st.transfer_bytes}"
        + (f" (codes, planes and the staging of {sum(probe.filling)} blocks still "
           f"filling; {st.transfer_bytes / fp_bytes:.3f} of 7a's {fp_bytes})" if fp_bytes
           else f" (= {sum(probe.blocks)} x {dec.store.kv_bytes_per_block()} B)")
        + f"; export_seq + import_seq host time median "
        f"{statistics.median(probe.host_s) * 1e3:.1f} ms, max {max(probe.host_s) * 1e3:.1f} "
        f"ms; {probe.checked_blocks} migrated blocks byte-equal in the decode engine's "
        f"device mirror; steps: prefill engine {pre.steps} (no decode chunk), decode "
        f"engine {dec.steps} (chunks of 1); launches: {kernel} {counts[kernel]} (= {L} x "
        f"{steps}), quantize_pages {counts['quantize_pages']}; tokens equal to "
        f"{ref_label}'s streams (common prefixes) {same} of {total} ({same / total:.1%})")
    return st.transfer_bytes


def phase_interference(model, params):
    """Phase 7b: ``benchmarks/bench_disagg.py``'s traffic at full width — one
    foreground request (8-token prompt, 64 greedy tokens) and, once it has
    10 tokens, 4 background prompts of 512 random tokens with 2 new tokens
    each — through a colocated engine and a ``DisaggregatedServer``. The
    device is synchronized before each clock read. Gated: foreground
    tokens emitted by an engine step whose plan also held another
    sequence's prefill chunk, 0 disaggregated and above 0 colocated; the
    foreground's decode gaps are printed."""
    vocab = model.cfg.vocab_size
    out = {}
    for label in ("colocated", "disaggregated"):
        rng = np.random.default_rng(5)
        if label == "colocated":
            target = LLMEngine(model, params, migration_cfg())
            engines, has_work = (target,), target.scheduler.has_work
        else:
            target = DisaggregatedServer(model, params, prefill_cfg=migration_cfg(),
                                         decode_cfg=migration_cfg())
            engines, has_work = (target.prefill_engine, target.decode_engine), target.has_work
        mixed = [0]
        for eng in engines:
            plans = []
            plan, step = eng.scheduler.plan, eng.step

            def recorded_plan(now=0.0, plan=plan, plans=plans):
                plans.append(plan(now))
                return plans[-1]

            def counted_step(eng=eng, step=step, plans=plans):
                fg = eng.seqs.get("fg")
                before = len(fg.generated) if fg is not None else 0
                plans.clear()
                n = step()
                if fg is not None and len(fg.generated) > before and any(
                        c.seq.request_id != "fg" for p in plans for c in p.prefill):
                    mixed[0] += len(fg.generated) - before
                return n
            eng.scheduler.plan, eng.step = recorded_plan, counted_step
        target.add_request(Request(request_id="fg", prompt=[3] * 8, sampling=SamplingParams(
            temperature=0.0, max_new_tokens=64)))
        gaps, tprev, added = [], None, False
        while has_work():
            fg = target.seqs["fg"]
            before = len(fg.generated)
            if before >= 10 and not added:
                for i in range(4):
                    target.add_request(Request(
                        request_id=f"bg{i}",
                        prompt=[int(x) for x in rng.integers(2, vocab, 512)],
                        sampling=SamplingParams(temperature=0.0, max_new_tokens=2)))
                added = True
            target.step()
            if len(target.seqs["fg"].generated) > before:
                torch.cuda.synchronize()
                now = time.perf_counter()
                if tprev is not None:
                    gaps.append(now - tprev)
                tprev = now
        seqs = target.seqs
        assert len(seqs["fg"].generated) == 64 and added
        assert all(len(seqs[f"bg{i}"].generated) == 2 for i in range(4))
        out[label] = (max(gaps[1:]), statistics.median(gaps), mixed[0])
        del target, engines
    assert out["disaggregated"][2] == 0 < out["colocated"][2], out
    log(f"[7b interference] {model.cfg.name} full width, bench_disagg's traffic (fg: 8-token "
        f"prompt, 64 greedy tokens; at its 10th token 4 prompts of 512 with 2 new tokens "
        f"each): foreground decode gap max / p50: colocated "
        f"{out['colocated'][0] * 1e3:.1f} / {out['colocated'][1] * 1e3:.1f} ms, "
        f"disaggregated {out['disaggregated'][0] * 1e3:.1f} / "
        f"{out['disaggregated'][1] * 1e3:.1f} ms "
        f"({out['disaggregated'][0] / out['colocated'][0]:.2f}x); "
        f"foreground tokens emitted by a step whose plan held another sequence's prefill "
        f"chunk: colocated {out['colocated'][2]}, disaggregated {out['disaggregated'][2]}")


def phase_disagg_f32(model, params):
    """Phase 7d: 7a's traffic with an f32 olmo-1b through the
    ``DisaggregatedServer`` and through one colocated engine: in f32 the
    greedy streams must be equal."""
    srv = DisaggregatedServer(model, params, prefill_cfg=migration_cfg(),
                              decode_cfg=migration_cfg())
    add_traffic(srv.prefill_engine, np.random.default_rng(7), "r")
    metrics, dt, _ = run_migrating(srv, COUNTERS)
    colo = LLMEngine(model, params, migration_cfg())
    add_traffic(colo, np.random.default_rng(7), "r")
    cmetrics, cdt, _ = run_served(colo, COUNTERS)
    streams = {rid: list(s.generated) for rid, s in srv.seqs.items()}
    ref = {rid: list(s.generated) for rid, s in colo.seqs.items()}
    same, total = equal_share(streams, ref)
    log(f"[7d disagg f32] {model.cfg.name} full width f32: disaggregated "
        f"{total / dt:.1f} generated tok/s ({srv.stats.migrated} migrations, "
        f"{srv.stats.transfer_bytes} B), colocated {total / cdt:.1f} tok/s; tokens equal "
        f"{same} of {total}")
    assert srv.stats.migrated == 8 and streams == ref, (same, total)


def phase_fleet(model, params, f32=False, ref_streams=None):
    """Phase 8: a ``ServingFleet`` of 2 instances on one model, LoRA rank 8
    with 4 adapters registered fleet-wide over 2 slots an instance, the 8
    requests naming a0-a3 and none, all added to instance 0, rebalanced at
    a 0.05 load gap. Holds: at least one migration; ``migrated_bytes`` =
    the destinations' ``last_import_bytes`` summed; a migrated adapter-bound
    sequence served on its destination with the adapter loaded there (that
    store missed at least once); bgmv launches = 4 x layers x both
    instances' paged steps; migrated blocks byte-equal in the destination's
    device mirror. ``f32`` (the f32 twin): the streams must also equal
    those of one LoRA engine on the same model that is not migrated."""
    cfg, L = model.cfg, model.cfg.num_layers
    lora = LoRAConfig(rank=8, alpha=16.0, max_loaded_adapters=2)
    fleet = ServingFleet(model, params, instances=2, engine_cfg=migration_cfg(lora=lora),
                         rebalance_threshold=0.05)
    names = [f"a{j}" for j in range(4)]
    adapters = {name: make_adapter(cfg, lora, seed=j + 1) for j, name in enumerate(names)}
    for name, w in adapters.items():
        fleet.register_adapter(name, w)
    probe = MigrationProbe(fleet.engines)
    add_traffic(fleet.engines[0], np.random.default_rng(7), "r", adapters=names + [None])
    moves = []  # (load gap before, after, migrations) of each rebalance that moved
    rebalance = fleet.rebalance

    def recorded_rebalance():
        before = fleet.load_gap()
        moved = rebalance()
        if moved:
            moves.append((before, fleet.load_gap(), moved))
        return moved
    fleet.rebalance = recorded_rebalance
    metrics, dt, counts = run_migrating(fleet, COUNTERS)
    dt -= probe.check_s
    st = fleet.stats
    steps = sum(e.paged_steps for e in fleet.engines)
    assert st.migrations >= 1 and st.migrations == len(probe.import_bytes), st
    assert st.migrated_bytes == sum(probe.import_bytes) == sum(probe.payload_bytes), st
    assert probe.checked_blocks == sum(probe.blocks)
    assert probe.adapter_confirmed and all(e.adapters.stats.misses >= 1
                                           for e, _, _ in probe.adapter_confirmed), \
        probe.adapter_confirmed
    assert counts["bgmv"] == 4 * L * steps and counts["paged_attention"] == L * steps, \
        (counts, steps)
    assert all(n == 0 for k, n in counts.items() if k not in ("bgmv", "paged_attention")), \
        counts
    gen = sum(m.num_generated for m in metrics)
    streams = {rid: list(s.generated) for rid, s in fleet.seqs.items()}
    label = f"[8 fleet{' f32' if f32 else ''}]"
    eng_dst = probe.adapter_confirmed[0][0]
    log(f"{label} {cfg.name} full width{' f32' if f32 else ''}, 2 instances on one model, "
        f"LoRA rank {lora.rank} x 4 adapters over {lora.max_loaded_adapters} slots each, "
        f"8 requests added to instance 0: {gen} generated tokens in {dt:.2f} s = "
        f"{gen / dt:.1f} generated tok/s; {st.migrations} migrations over {len(moves)} "
        f"rebalances, {st.migrated_bytes} B (= the imports' last_import_bytes); load gap "
        f"before / after each moving rebalance "
        + ", ".join(f"{b:.3f} / {a:.3f} ({n})" for b, a, n in moves)
        + f", final {fleet.load_gap():.3f}; migrated adapter-bound sequences served with "
        f"their adapter loaded on the destination: {len(probe.adapter_confirmed)} "
        f"(instance {fleet.engines.index(eng_dst)}: lora misses "
        f"{eng_dst.adapters.stats.misses}); steps by instance "
        f"{[e.steps for e in fleet.engines]}; launches: bgmv {counts['bgmv']} (= 4 x {L} x "
        f"{steps}), paged_attention {counts['paged_attention']}; {probe.checked_blocks} "
        f"migrated blocks byte-equal in the destination's device mirror")
    if f32:
        ref = LLMEngine(model, params, migration_cfg(lora=lora))
        for name, w in adapters.items():
            ref.register_adapter(name, w)
        add_traffic(ref, np.random.default_rng(7), "r", adapters=names + [None])
        run_served(ref, COUNTERS)
        want = {rid: list(s.generated) for rid, s in ref.seqs.items()}
        same, total = equal_share(streams, want)
        log(f"{label} streams equal to one LoRA engine's that is not migrated: "
            f"{same} of {total}")
        assert streams == want, (same, total)


def phase_serve_starcoder():
    """starcoder2-3b at full width on the gathered backend (its only one):
    8 requests queued at once, prompts of 128-512 random tokens, 32 greedy
    output tokens each, block 16, max_model_len 1024, prefill_chunk 512 (a
    prompt prefills as one fresh chunk unless the step's 1024-token budget
    splits it), then a traced rerun."""
    engine = build_engine(
        "starcoder2-3b", debug=False, device="cuda", max_model_len=1024,
        num_blocks=640, block_size=16,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=1024,
                                  prefill_chunk=512))
    cfg, runner, model = engine.model.cfg, engine.runner, engine.model
    assert engine.paged_runner is None and runner.name == "gathered"
    rng = np.random.default_rng(7)
    add_traffic(engine, rng, "r")
    model.route_rows = dict.fromkeys(model.route_rows, 0)
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False)
    gen = sum(m.num_generated for m in metrics)
    assert counts["flash_prefill"] == cfg.num_layers * runner.prefill_steps > 0, \
        (counts, runner.prefill_steps)
    assert all(n == 0 for k, n in counts.items() if k != "flash_prefill"), counts
    rows = dict(model.route_rows)
    assert rows["flash_prefill"] >= 8, rows
    ttft = statistics.median(m.ttft for m in metrics)
    prompt = sum(m.num_prompt for m in metrics)
    log(f"[6 serve] {cfg.name} full width, gathered backend: 8 requests, {prompt} "
        f"prompt + {gen} generated tokens in {dt:.2f} s = {gen / dt:.1f} generated "
        f"tok/s, TTFT p50 {ttft * 1e3:.0f} ms, {engine.steps} steps "
        f"({runner.prefill_steps} with a fresh row), flash_prefill launches "
        f"{counts['flash_prefill']} (= {cfg.num_layers} x {runner.prefill_steps}); "
        f"rows by route: flash_prefill {rows['flash_prefill']}, flash_attention "
        f"{rows['flash_attention']}; host_copy_bytes {engine.host_copy_bytes} "
        f"({engine.host_copy_bytes / engine.steps / 1e6:.1f} MB per step); "
        f"preemptions {engine.metrics_snapshot()['engine.preemptions']}")
    traced_rerun(engine, rng, label="starcoder2_3b")
    return counts, gen / dt, ttft


# ---------------------------------------------------------------------------
# llama4-scout: routed + shared MoE, chunked attention, NoPE global layers
# ---------------------------------------------------------------------------
LLAMA4 = "llama4-scout-17b-a16e"
# the two gathered extend steps over 8448-slot windows: label, cache_len and
# real chunk length per row (C = 256). The mixed step's last row runs from
# 8150 to 8213 across the 8192-token attention chunk boundary
LLAMA4_W, LLAMA4_C = 8448, 256
LLAMA4_STEPS = (("fresh B=2 C=256", [0, 0], [256, 256]),
                ("mixed B=4 C=256", [0, 700, 0, 8150], [256, 1, 200, 64]))
# moe_apply vs moe_dense_ref in f32 at published width: the same f32
# matmuls (no TF32) over other row groupings, so summation order only, over
# 5120- and 8192-term sums of O(1) terms
MOE_ATOL_F32 = 1e-4
# one expert's w1 (5120 x 16384) and w2 (8192 x 5120) in bf16: 251.7 MB
EXPERT_BYTES = 3 * 5120 * 8192 * 2


def llama4_block():
    """llama4-scout at its published width, its depth cut to one interleave
    block (3 chunked layers + 1 global NoPE layer) to fit one card: the
    config and the published layer count."""
    cfg = configs.get_config(LLAMA4)
    return dataclasses.replace(cfg, stages=((cfg.stages[0][0], 1),)), cfg.num_layers


def _to_f32_inplace(tree):
    """Each leaf of a parameter tree cast to f32 in place of the bf16 one,
    so the bf16 leaves are freed as the f32 ones are made (one interleave
    block: 43.5 GB of f32 beside no more than one bf16 leaf)."""
    for key in (range(len(tree)) if isinstance(tree, list) else list(tree)):
        if isinstance(tree[key], (dict, list)):
            _to_f32_inplace(tree[key])
        else:
            tree[key] = tree[key].float()


def busy_ms(fn, reps: int = 5) -> float:
    """Device busy milliseconds of one ``fn`` call on the profiler's clock:
    every kernel's time summed over ``reps`` calls, over ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if not us:
        raise RuntimeError("the profiler recorded no kernel")
    return us / reps / 1e3


def wall_ms(fn, reps: int = 10) -> float:
    """Median host milliseconds of one synchronized ``fn`` call (for calls
    that read the device from the host, which ``cuda_ms`` cannot hold)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def moe_timing(card, cfg, p):
    """One MoE layer in bf16 (layer 0's weights) at decode (B=8 rows of one
    token) and at prefill (T=512): ``moe_apply`` by the host clock around a
    synchronized call (it reads the experts' counts from the device) and by
    the profiler's busy time, beside its bound and ``moe_dense_ref``'s
    times. Bound: the weights of the experts this input touches and of the
    shared expert read once from HBM, x read and y written once, against
    2 * 3 * d * f flops per routed and per shared token row at the bf16
    tensor-core rate."""
    d, f, k = cfg.d_model, cfg.moe_d_ff, cfg.top_k
    g = torch.Generator(device="cuda").manual_seed(21)
    for label, shape in (("decode T=8", (8, 1, d)), ("prefill T=512", (1, 512, d))):
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        T = x.shape[0] * x.shape[1]
        _, experts, _ = moe_mod.route(p, cfg, x.reshape(T, d))
        touched = int(torch.unique(experts).numel())
        nbytes = (touched + cfg.num_shared_experts) * EXPERT_BYTES + 2 * x.numel() * 2
        flops = 2 * 3 * d * f * T * (k + cfg.num_shared_experts)
        bound_ms, bound_by = bound(card, nbytes, flops, tensor_cores=True)
        y = moe_mod.moe_apply(p, cfg, x, capacity_factor=2.0)[0]
        want = moe_mod.moe_dense_ref(p, cfg, x, capacity_factor=2.0)[0]
        diff = (y.float() - want.float()).abs().max().item()

        def grouped():
            return moe_mod.moe_apply(p, cfg, x, capacity_factor=2.0)

        def dense():
            return moe_mod.moe_dense_ref(p, cfg, x, capacity_factor=2.0)
        ms, busy = wall_ms(grouped), busy_ms(grouped)
        dense_ms, dense_busy = wall_ms(dense), busy_ms(dense)
        cap = moe_mod.capacity(T, k, cfg.num_experts, 2.0)
        log(f"[5 timing] MoE layer {label} bf16, {touched} of {cfg.num_experts} experts "
            f"touched + {cfg.num_shared_experts} shared: moe_apply {ms:.3f} ms wall, "
            f"{busy:.3f} ms device busy; bound {bound_ms:.3f} ms ({nbytes / 1e6:.1f} MB "
            f"at {card[1] / 1e12:g} TB/s, {flops / 1e9:.1f} GFLOP at {card[3] / 1e12:g} "
            f"TFLOP/s; {bound_by}): busy at {bound_ms / busy:.1%} of bound; "
            f"moe_dense_ref ({cfg.num_experts} x {cap} slots) {dense_ms:.3f} ms wall, "
            f"{dense_busy:.3f} ms busy; bf16 outputs max |diff| {diff:.3g}")
        del x, y, want


def phase_model_llama4(card):
    """llama4-scout at its published width (d_model 5120, 40 query heads
    over 8 KV heads, 16 routed experts at top-1 + a shared expert of d_ff
    8192, vocab 202048), its depth cut to one interleave block (3 chunked
    layers, 8192-token chunks, + 1 global NoPE layer: 4 of 48), random bf16
    weights from seed 0. Two gathered ``Model.extend`` steps over
    8448-slot windows (``LLAMA4_STEPS``): logits with the flash_prefill
    kernel vs with its plain version, printed in bf16 and gated in f32 on
    the same weights cast in place (MODEL_ATOL_F32), the kernel launched
    once per layer and call; each bf16 step profiled, with flash_prefill's
    share and the MoE's (its four calls of the step replayed alone, busy
    time over the step's). Then one chunked layer's ``attn_extend`` on the
    mixed step twice, the second time with the crossing row's window slots
    below 8192 overwritten by noise: its queries at positions >= 8192 must
    come out bit for bit the same. Then ``moe_apply`` vs ``moe_dense_ref``
    in f32 at published width (T=8 and T=512), and the MoE layer timing."""
    cfg, full_layers = llama4_block()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[5 model] {cfg.name}: published width (d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads over {cfg.num_kv_heads} KV heads x {cfg.head_dim}, {cfg.num_experts} "
        f"experts top-{cfg.top_k} + {cfg.num_shared_experts} shared, expert d_ff "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}), depth cut to one interleave block: "
        f"{cfg.num_layers} of {full_layers} layers ("
        + ", ".join(s.attn_kind for s in model.specs)
        + f"; chunk {cfg.chunk_size}), {nparam / 1e9:.2f} B params bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    W, C = LLAMA4_W, LLAMA4_C
    rng = np.random.default_rng(9)
    g = torch.Generator(device="cuda").manual_seed(9)
    steps = []
    for label, cache_len, lens in LLAMA4_STEPS:
        B = len(lens)
        win = model.init_cache(B, W)
        for layer in win:
            for x in layer.values():
                x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        steps.append((label, win, torch.tensor(
            rng.integers(0, cfg.vocab_size, size=(B, C)), device="cuda"),
            torch.tensor(cache_len, dtype=torch.int32, device="cuda"),
            torch.arange(C, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]))

    def run(m, prm, win, tok, cl, experts=None):
        """Logits and flash_prefill launches of one step; ``experts``, a
        list, receives each layer's routing."""
        cache = [{n: x.clone() for n, x in layer.items()} for layer in win]
        before = FLASH.launches
        route = moe_mod.route

        def record(*a):
            out = route(*a)
            experts.append(out[1])
            return out
        with mock.patch.object(moe_mod, "route", record if experts is not None else route):
            logits = m.extend(prm, tok, cache, cl)[0]
        torch.cuda.synchronize()
        return logits.float(), FLASH.launches - before

    drift = {}
    for label, win, tok, cl, real in steps:
        ek, ep = [], []
        lk, n = run(model, params, win, tok, cl, ek)
        # every fresh row's chunk lies inside the first 8192-token chunk
        assert n == cfg.num_layers, n
        assert lk.shape == (len(cl), C, cfg.vocab_size) and torch.isfinite(lk[real]).all()
        with plain_flash():
            lp, _ = run(model, params, win, tok, cl, ep)
        # the bf16 drift's source: tokens whose top-1 expert differs between
        # the kernel's run and the plain one (per layer, real positions)
        flips = [int(((a != b).reshape(real.shape) & real).sum()) for a, b in zip(ek, ep)]
        drift[label] = ((lk[real] - lp[real]).abs().max().item(),
                        lk[real].abs().max().item(),
                        (lk[real].argmax(-1) == lp[real].argmax(-1)).float().mean().item(),
                        flips, int(real.sum()))
        del lk, lp
    moe_fn = moe_mod.moe_apply
    for label, win, tok, cl, real in steps:
        cache = [{n: x.clone() for n, x in layer.items()} for layer in win]
        busy = device_profile(f"{cfg.name} extend {label} bf16", lambda: model.extend(
            params, tok, cache, cl), focus="flash_prefill")
        calls = []

        def record(p, c, x, **kw):
            calls.append((p, x.clone(), kw))
            return moe_fn(p, c, x, **kw)
        with mock.patch.object(moe_mod, "moe_apply", record):
            model.extend(params, tok, cache, cl)
        assert len(calls) == cfg.num_layers, len(calls)
        moe_busy = busy_ms(lambda: [moe_fn(p, cfg, x, **kw) for p, x, kw in calls], reps=2)
        log(f"    MoE ({cfg.num_layers} moe_apply calls of the step replayed alone): "
            f"{moe_busy:.3f} ms busy"
            + (f" = {moe_busy * 1e3 / busy:.1%} of the step's busy time" if busy else ""))
        del cache, calls
    # chunk independence: a chunked layer's queries past 8192 read only their chunk
    label, win, tok, cl, real = steps[1]
    row, start = 3, LLAMA4_STEPS[1][1][3]
    past = cfg.chunk_size - start  # the row's first query at or past 8192
    x = torch.randn((len(cl), C, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    route = attn_mod.extend_route(cl, C, W)
    noisy = {n: t.clone() for n, t in win[0].items()}
    for t in noisy.values():
        t[row, :cfg.chunk_size] = torch.randn(t[row, :cfg.chunk_size].shape, generator=g,
                                              device="cuda") * 50
    outs = [attn_mod.attn_extend(params["layers"][0]["mixer"], cfg, model.specs[0], x,
                                 {n: t.clone() for n, t in w.items()}, cl, route)[0]
            for w in (win[0], noisy)]
    same = torch.equal(outs[0][row, past:], outs[1][row, past:])
    moved = not torch.equal(outs[0][row, :past], outs[1][row, :past])
    log(f"  chunked layer, row at {start}..{start + LLAMA4_STEPS[1][2][3] - 1}: window "
        f"slots < {cfg.chunk_size} replaced by noise; queries at >= {cfg.chunk_size} "
        f"({C - past} of {C}) {'bit-equal' if same else 'FAIL'}, queries below "
        f"{'moved' if moved else 'did not move (FAIL)'}")
    if not (same and moved):
        raise AssertionError("chunked attention read keys outside the query's chunk")
    del noisy, outs, x
    # moe_apply vs its dense oracle in f32 at published width
    gen = torch.Generator(device="cuda").manual_seed(5)
    p32 = moe_mod.make_moe_params(gen, cfg, torch.float32, "cuda")
    for label, shape in (("T=8 (8 rows of 1)", (8, 1, cfg.d_model)),
                         ("T=512", (1, 512, cfg.d_model))):
        x = torch.randn(shape, generator=gen, device="cuda")
        y, aux = moe_mod.moe_apply(p32, cfg, x, capacity_factor=2.0)
        want, want_aux = moe_mod.moe_dense_ref(p32, cfg, x, capacity_factor=2.0)
        check(f"moe_apply vs moe_dense_ref {label} f32 (published width)", y, want,
              MOE_ATOL_F32)
        assert abs(aux.item() - want_aux.item()) <= 1e-6
    del p32, x, y, want
    torch.cuda.empty_cache()
    moe_timing(card, cfg, params["layers"][0]["ff"])
    # the f32 gate: the same weights and windows, cast in place
    _to_f32_inplace(params)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32", param_dtype="float32"),
                          device="cuda")
    torch.cuda.empty_cache()
    for label, win, tok, cl, real in steps:
        win32 = [{n: x.float() for n, x in layer.items()} for layer in win]
        lk, _ = run(model32, params, win32, tok, cl)
        with plain_flash():
            lp, _ = run(model32, params, win32, tok, cl)
        check(f"{cfg.name} extend {label} f32 logits, kernel vs plain flash_prefill",
              lk[real], lp[real], MODEL_ATOL_F32)
        d, mx, agree, flips, nreal = drift[label]
        log(f"    bf16: kernel vs plain logits max |diff| {d:.3g} (bf16 drift, not gated; "
            f"logits max |x| {mx:.3g}; argmax equal on {agree:.1%} of real positions); "
            f"top-1 expert differs on {flips} of {nreal} real positions by layer")
        del win32, lk, lp
    del model32, params, steps
    torch.cuda.empty_cache()


def phase_serve_llama4():
    """llama4-scout, the same one-block cut, served on the gathered backend
    (its only one) with the other serves' traffic: 8 requests queued at
    once, prompts of 128-512 random tokens, 32 greedy output tokens each,
    block 16, max_model_len 1024, prefill_chunk 256, 512 batched tokens a
    step; then a traced rerun."""
    cfg, _ = llama4_block()
    model = build_model(cfg, device="cuda")
    engine = LLMEngine(model, model.init(0), EngineConfig(
        block_size=16, num_blocks=640, max_model_len=1024, device="cuda", seed=0,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=512,
                                  prefill_chunk=256)))
    runner = engine.runner
    assert engine.paged_runner is None and runner.name == "gathered"
    rng = np.random.default_rng(7)
    add_traffic(engine, rng, "r")
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False)
    gen = sum(m.num_generated for m in metrics)
    assert counts["flash_prefill"] == cfg.num_layers * runner.prefill_steps > 0, \
        (counts, runner.prefill_steps)
    assert all(n == 0 for k, n in counts.items() if k != "flash_prefill"), counts
    rows = dict(model.route_rows)
    ttft = statistics.median(m.ttft for m in metrics)
    prompt = sum(m.num_prompt for m in metrics)
    log(f"[6 serve] {cfg.name} published width, {cfg.num_layers} layers, gathered "
        f"backend: 8 requests, {prompt} prompt + {gen} generated tokens in {dt:.2f} s = "
        f"{gen / dt:.1f} generated tok/s, TTFT p50 {ttft * 1e3:.0f} ms, {engine.steps} "
        f"steps ({runner.prefill_steps} with a fresh row), flash_prefill launches "
        f"{counts['flash_prefill']} (= {cfg.num_layers} x {runner.prefill_steps}); rows "
        f"by route: flash_prefill {rows['flash_prefill']}, flash_attention "
        f"{rows['flash_attention']}; host_copy_bytes {engine.host_copy_bytes} "
        f"({engine.host_copy_bytes / engine.steps / 1e6:.1f} MB per step); "
        f"preemptions {engine.metrics_snapshot()['engine.preemptions']}")
    traced_rerun(engine, rng, label="llama4_scout")
    return counts


# ---------------------------------------------------------------------------
# quantized stores on the gathered backend; deepseek-v3 (MLA + 256 experts)
# ---------------------------------------------------------------------------
def record_chunks(runner):
    """Wrap ``runner.execute`` so each step's (start, length) of every chunk
    is appended to the returned list (for the byte and launch formulas)."""
    steps, execute = [], runner.execute

    def run(batch):
        steps.append([(c.start, c.length) for c in batch.chunks])
        return execute(batch)
    runner.execute = run
    return steps


def phase_serve_starcoder_quant(fp_rate, fp_ttft):
    """starcoder2-3b at full width with KIVI 8-bit pages on the gathered
    backend, phase 6's starcoder2-3b traffic and settings. Each step's
    window is dequantized on the card (``dequantize_pages``: 2 launches a
    step, one per leaf name) and each row whose chunk fills a page packs
    (``quantize_pages``: 2 launches per such row, one per grouping axis).
    Printed: the bytes uploaded against the fp window's (what
    ``host_copy_bytes`` charges for the gathers), tok/s and TTFT p50 beside
    the fp serve's; then a traced rerun (gather, window_upload, scatter)."""
    engine = build_engine(
        "starcoder2-3b", debug=False, device="cuda", max_model_len=1024,
        num_blocks=640, block_size=16, kv_quant=QuantConfig(bits=8),
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=1024,
                                  prefill_chunk=512))
    cfg, runner, store = engine.model.cfg, engine.runner, engine.store
    assert engine.paged_runner is None and store.quantized
    steps = record_chunks(runner)
    rng = np.random.default_rng(7)
    add_traffic(engine, rng, "r")
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False)
    gen = sum(m.num_generated for m in metrics)
    P = engine.cfg.block_size
    fills = sum((st + ln) // P > st // P for step in steps for st, ln in step)
    assert counts["dequantize_pages"] == 2 * engine.steps, (counts, engine.steps)
    assert counts["quantize_pages"] == 2 * fills, (counts, fills)
    assert counts["flash_prefill"] == cfg.num_layers * runner.prefill_steps > 0, counts
    assert counts["paged_attention"] == counts["paged_attention_quant"] == counts["bgmv"] == 0
    fp_window = sum(len(step) for step in steps) * engine.cfg.max_model_len * \
        cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    ttft = statistics.median(m.ttft for m in metrics)
    log(f"[6 serve] {cfg.name} full width, KIVI 8-bit pages, gathered backend: "
        f"{gen} generated tokens in {dt:.2f} s = {gen / dt:.1f} tok/s ({gen / dt / fp_rate:.2f}x "
        f"the fp serve's {fp_rate:.1f}), TTFT p50 {ttft * 1e3:.0f} ms (fp {fp_ttft * 1e3:.0f} "
        f"ms), {engine.steps} steps; dequantize_pages {counts['dequantize_pages']} launches "
        f"(= 2 x {engine.steps} steps), quantize_pages {counts['quantize_pages']} (= 2 x "
        f"{fills} rows filling a page); window upload {runner.window_upload_bytes} B against "
        f"the fp window's {fp_window} B ({runner.window_upload_bytes / fp_window:.1%}); "
        f"host_copy_bytes {engine.host_copy_bytes} (the reference's count: the fp window "
        f"and the written tokens); pack round trip {store.pack_transfer_bytes} B; "
        f"{int(store.block_quantized.sum())} blocks packed at the end")
    traced_rerun(engine, rng, label="starcoder2_3b_kivi")
    return counts


DEEPSEEK = "deepseek-v3-671b"
# gathered extend steps over 1024-slot windows: label, cache_len and real
# chunk length per row
DEEPSEEK_W = 1024
DEEPSEEK_STEPS = (("fresh B=2 C=256", [0, 0], [256, 256]),
                  ("mixed B=4 C=256", [0, 700, 0, 1000], [256, 1, 200, 1]),
                  ("decode B=8 C=1", [100, 250, 380, 512, 640, 777, 900, 1010], [1] * 8))
# mla_decode (absorbed) vs mla_extend (expanded) in f32: the same function
# summed in other orders (over the 512-wide latent against the 192-wide
# expanded head), no TF32; O(1) outputs
MLA_ATOL_F32 = 1e-4


def deepseek_block():
    """deepseek-v3 at its published width, its depth cut to one dense and
    one MoE layer (of 3 and 58); the config and the published layer count."""
    cfg = configs.get_config(DEEPSEEK)
    return dataclasses.replace(cfg, stages=((cfg.stages[0][0], 1), (cfg.stages[1][0], 1))), \
        cfg.num_layers


def replay_busy(fn_mod, name, step):
    """Device busy ms of one step's calls of ``fn_mod.<name>``, replayed
    alone, and their number."""
    calls, fn = [], getattr(fn_mod, name)

    def record(*a, **kw):
        calls.append((a, kw))
        return fn(*a, **kw)
    with mock.patch.object(fn_mod, name, record):
        step()
    return busy_ms(lambda: [fn(*a, **kw) for a, kw in calls], reps=2), len(calls)


def phase_model_deepseek():
    """deepseek-v3 at its published width (d_model 7168, 128 MLA heads:
    q_lora_rank 1536, kv_lora_rank 512, qk 128 + 64 rope, v 128; 256 routed
    experts at top-8, sigmoid + bias routing, + 1 shared; vocab 129280), its
    depth cut to one dense and one MoE layer, random bf16 weights from seed
    0. Three gathered ``Model.extend`` steps over 1024-slot latent windows
    (``DEEPSEEK_STEPS``): finite logits at the real positions, every row on
    the plain attention (no flash_prefill launch); each profiled, with the
    MoE's and the MLA attention's shares (their calls replayed alone).
    Returns (model, params) for phase 6's serves."""
    cfg, full_layers = deepseek_block()
    gc.collect()  # earlier phases' engines hold their models in cycles
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[5 model] {cfg.name}: published width (d_model {cfg.d_model}, {cfg.num_heads} "
        f"MLA heads, q rank {cfg.q_lora_rank}, kv rank {cfg.kv_lora_rank}, qk "
        f"{cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim} rope, v {cfg.v_head_dim}; "
        f"{cfg.num_experts} experts top-{cfg.top_k} + {cfg.num_shared_experts} shared, "
        f"expert d_ff {cfg.moe_d_ff}, dense d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth "
        f"cut to {cfg.num_layers} of {full_layers} layers (dense, MoE): {nparam} params, "
        f"{nparam * 2 / 1e9:.1f} GB bf16, built in {time.perf_counter() - t0:.1f} s; the "
        f"latent cache {(cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2} B per token per "
        f"layer against {cfg.num_heads * (cfg.head_dim + cfg.v_head_dim) * 2} B of expanded "
        "K/V")
    W, H = DEEPSEEK_W, cfg.num_heads
    rng = np.random.default_rng(9)
    g = torch.Generator(device="cuda").manual_seed(9)
    for label, cache_len, lens in DEEPSEEK_STEPS:
        B, C = len(lens), max(lens)
        win = model.init_cache(B, W)
        for layer in win:
            for x in layer.values():
                x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, C)), device="cuda")
        cl = torch.tensor(cache_len, dtype=torch.int32, device="cuda")
        real = torch.arange(C, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]

        def step():
            return model.extend(params, tok, win, cl)[0]
        before, rows = FLASH.launches, dict(model.route_rows)
        logits = step().float()
        torch.cuda.synchronize()
        assert FLASH.launches == before and model.route_rows["flash_prefill"] == \
            rows["flash_prefill"], "an MLA row reached flash_prefill"
        assert logits.shape == (B, C, cfg.vocab_size) and torch.isfinite(logits[real]).all()
        kv_mb = B * W * H * (cfg.head_dim + cfg.v_head_dim) * 2 / 1e6
        log(f"  {label}: logits finite at {int(real.sum())} real positions (max |x| "
            f"{logits[real].abs().max().item():.3g}); expanded K/V {kv_mb:.0f} MB a layer, "
            f"f32 scores {B * H * C * W * 4 / 1e9:.3f} GB a layer")
        del logits
        busy = device_profile(f"{cfg.name} extend {label} bf16", step)
        for fn_mod, name, what in ((moe_mod, "moe_apply", "MoE"),
                                   (mla_mod, "mla_extend", "MLA attention")):
            part, n = replay_busy(fn_mod, name, step)
            log(f"    {what} ({n} {name} calls of the step replayed alone): {part:.3f} ms "
                "busy" + (f" = {part * 1e3 / busy:.1%} of the step's busy time" if busy
                          else ""))
        del win
        torch.cuda.empty_cache()
    return model, params


def phase_serve_deepseek(model, params, kv_quant=None, ref=None):
    """The deepseek block on the gathered backend (its only one), the other
    serves' traffic: 8 requests, prompts of 128-512 tokens, 32 greedy
    tokens each, block 16, max_model_len 1024, prefill_chunk 256, 512
    batched tokens a step. No kernel runs on this path; every row takes the
    plain attention. ``host_copy_bytes`` is held to its formula: 2 layers x
    (512 + 64) latent values x 2 bytes, times each step's rows x 1024 window
    slots plus the tokens it wrote. ``kv_quant``: the latents' quantize-
    dequantize round trip into fp pages, its streams compared with
    ``ref``'s (not gated). Returns the streams."""
    cfg = model.cfg
    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=640, max_model_len=1024, device="cuda", seed=0,
        kv_quant=kv_quant, scheduler=SchedulerConfig(
            max_batch_slots=8, max_batched_tokens=512, prefill_chunk=256)))
    runner = engine.runner
    assert engine.paged_runner is None and not engine.store.quantized
    steps = record_chunks(runner)
    add_traffic(engine, np.random.default_rng(7), "r")
    model.route_rows = dict.fromkeys(model.route_rows, 0)
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False)
    assert all(n == 0 for n in counts.values()), counts
    rows = dict(model.route_rows)
    assert rows == {"flash_prefill": 0, "flash_attention": sum(map(len, steps))}, rows
    per_slot = cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    want = per_slot * sum(len(s) * engine.cfg.max_model_len + sum(ln for _, ln in s)
                          for s in steps)
    assert engine.host_copy_bytes == want, (engine.host_copy_bytes, want)
    gen = sum(m.num_generated for m in metrics)
    ttft = statistics.median(m.ttft for m in metrics)
    streams = {rid: list(s.generated) for rid, s in engine.seqs.items()}
    kind = "fp latents" if kv_quant is None else f"kv_quant {kv_quant.bits}-bit (round trip)"
    extra = ""
    if ref is not None:
        same, total = equal_share(streams, ref)
        extra = f"; {same} of {total} tokens equal to the fp serve's (not gated)"
    log(f"[6 serve] {cfg.name} block, {kind}, gathered backend: 8 requests, "
        f"{sum(m.num_prompt for m in metrics)} prompt + {gen} generated tokens in "
        f"{dt:.2f} s = {gen / dt:.1f} generated tok/s, TTFT p50 {ttft * 1e3:.0f} ms, "
        f"{engine.steps} steps ({runner.prefill_steps} with a fresh row); rows by route "
        f"flash_attention {rows['flash_attention']}, flash_prefill 0; host_copy_bytes "
        f"{engine.host_copy_bytes} (= formula; {engine.host_copy_bytes / engine.steps / 1e6:.1f} "
        f"MB a step); preemptions {engine.metrics_snapshot()['engine.preemptions']}{extra}")
    del engine
    return streams


def phase_deepseek_f32(model, params):
    """One MLA layer in f32 at published width: ``mla_decode`` (absorbed)
    against ``mla_extend`` (expanded) at C = 1, B = 8 over 1024-slot
    windows (MLA_ATOL_F32). Then ``moe_apply`` against ``moe_dense_ref`` at
    T = 8 in f32 on the MoE layer's own weights, cast in place after every
    other parameter is freed (the f32 experts are 45.3 GB)."""
    cfg = dataclasses.replace(model.cfg, dtype="float32", param_dtype="float32")
    spec = model.specs[0]
    p32 = _to_f32(params["layers"][0]["mixer"])
    g = torch.Generator(device="cuda").manual_seed(4)
    B, W = 8, DEEPSEEK_W
    cache = {"c_kv": torch.randn(B, W, cfg.kv_lora_rank, generator=g, device="cuda"),
             "k_pe": torch.randn(B, W, cfg.qk_rope_head_dim, generator=g, device="cuda")}
    x = torch.randn(B, 1, cfg.d_model, generator=g, device="cuda")
    cl = torch.tensor([0, 1, 100, 511, 512, 700, 1000, 1023], device="cuda")
    a = {k: v.clone() for k, v in cache.items()}
    od, a = mla_mod.mla_decode(p32, cfg, spec, x, a, cl)
    oe, cache = mla_mod.mla_extend(p32, cfg, spec, x, cache, cl)
    assert all(torch.equal(a[k], cache[k]) for k in a)
    check(f"{DEEPSEEK} MLA layer f32 (published width, B={B}, W={W}): mla_decode vs "
          f"mla_extend at C=1 (outputs max |x| {oe.abs().max().item():.3g})", od, oe,
          MLA_ATOL_F32)
    del p32, cache, a, od, oe
    ff = params["layers"][1]["ff"]
    params.clear()  # the caller's dict: frees the block but the MoE layer
    torch.cuda.empty_cache()
    _to_f32_inplace(ff)
    torch.cuda.empty_cache()
    x = torch.randn(8, 1, cfg.d_model, generator=g, device="cuda")
    touched = int(torch.unique(moe_mod.route(ff, cfg, x.reshape(8, -1))[1]).numel())
    y, aux = moe_mod.moe_apply(ff, cfg, x, capacity_factor=2.0)
    want, want_aux = moe_mod.moe_dense_ref(ff, cfg, x, capacity_factor=2.0)
    check(f"{DEEPSEEK} moe_apply vs moe_dense_ref T=8 (8 rows of 1) f32 (published "
          f"width, {cfg.num_experts} experts top-{cfg.top_k}, {touched} touched)", y, want,
          MOE_ATOL_F32)
    assert abs(aux.item() - want_aux.item()) <= 1e-6
    del ff, x, y, want
    torch.cuda.empty_cache()


def smoke_serve(arch, params, device, bits=None):
    """The smoke config of ``arch`` in f32 on ``device`` with the given CPU
    weights: 4 greedy requests (the ``gpu`` tests' twin; a state stack
    holds 32 state slots). Returns (streams, engine)."""
    model = build_model(configs.smoke_config(arch), device=device)
    eng = LLMEngine(model, _to_device(params, device), EngineConfig(
        block_size=8, num_blocks=128, max_model_len=128, device=device,
        kv_quant=QuantConfig(bits=bits) if bits else None))
    rng = np.random.default_rng(4)
    for i in range(4):
        eng.add_request(Request(
            request_id=f"r{i}", prompt=[int(t) for t in rng.integers(
                2, model.cfg.vocab_size, int(rng.integers(12, 40)))],
            sampling=SamplingParams(max_new_tokens=12)))
    eng.run()
    return {rid: s.generated for rid, s in eng.seqs.items()}, eng


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def phase_smoke_twins():
    """The f32 smoke twins of tests/test_torch_cuda.py: the same weights
    served on the CPU (plain versions) and on the card (kernels) give equal
    greedy streams: deepseek's latents, starcoder2-3b's KIVI 8-bit pages
    (pack and unpack kernels, flash_prefill), jamba's state slots with fp
    and with KIVI 8-bit attention pages, and xlstm's state slots. The
    unpack runs twice per dispatch (a state stack dispatches once per
    chunk length, so more than once in some steps)."""
    for arch, bits in ((DEEPSEEK, None), ("starcoder2-3b", 8), (JAMBA, None), (JAMBA, 8),
                       (XLSTM, None)):
        params = build_model(configs.smoke_config(arch), device="cpu").init(0)
        cpu, _ = smoke_serve(arch, params, "cpu", bits)
        before = UNPACK.launches
        gpu, eng = smoke_serve(arch, params, "cuda", bits)
        same, total = equal_share(gpu, cpu)
        unpacks = UNPACK.launches - before
        ok = gpu == cpu and unpacks == (2 * eng.runner.steps if bits else 0)
        log(f"[6 serve] {arch} smoke f32{', KIVI 8-bit pages' if bits else ''}: card vs CPU "
            f"streams {same} of {total} tokens equal, {eng.steps} steps "
            f"({eng.runner.steps} dispatches), unpack {unpacks} launches: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{arch} smoke: the card's streams differ from the CPU's")


# ---------------------------------------------------------------------------
# state mixers: jamba-v0.1-52b (Mamba + MoE + GQA attention), xlstm-1.3b
# ---------------------------------------------------------------------------
JAMBA = "jamba-v0.1-52b"
XLSTM = "xlstm-1.3b"
# gathered extend steps of the Jamba block over 1024-slot attention windows:
# label, cache_len per row, chunk length (a state stack's rows share one)
JAMBA_W = 1024
JAMBA_STEPS = (("fresh B=2 C=256", [0, 0], 256),
               ("decode B=8 C=1", [100, 250, 380, 512, 640, 777, 900, 1010], 1))
# xlstm-1.3b steps: C = 256 takes the chunkwise mLSTM (S >= 128, S % 64 == 0),
# C = 200 the recurrence
XLSTM_STEPS = (("fresh B=2 C=256 (chunkwise mLSTM)", [0, 0], 256),
               ("fresh B=2 C=200 (mLSTM recurrence)", [0, 0], 200),
               ("decode B=4 C=1", [130, 200, 260, 300], 1))
# f32 chunked-equals-whole checks of one state layer at published width: the
# same function summed in another order (Mamba: the scan from a carried
# state and the single-step branch; mLSTM: chunkwise against recurrence)
STATE_ATOL_F32 = 1e-4


def free_device(label):
    """Drop what earlier phases left (cycles included) and log the card's
    free memory before ``label`` is built."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"  before {label}: {free / 1e9:.1f} of {total / 1e9:.1f} GB of device memory free")


def jamba_block():
    """jamba-v0.1-52b at its published width, its depth cut to one Jamba
    block (7 Mamba + 1 attention layer, MoE on the odd offsets) of four,
    since 52 B parameters do not fit one card: the config and the published
    layer count."""
    cfg = configs.get_config(JAMBA)
    return dataclasses.replace(cfg, stages=((cfg.stages[0][0], 1),)), cfg.num_layers


def state_steps(model, steps, W, seed):
    """Each step's (label, cache, tokens, cache_len): empty states, attention
    windows of W slots filled with noise."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for label, cache_len, C in steps:
        B = len(cache_len)
        cache = model.init_cache(B, W)
        for layer, spec in zip(cache, model.specs):
            if spec.mixer == "attn":
                for x in layer.values():
                    x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        out.append((label, cache, torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, C)),
                                               device="cuda"),
                    torch.tensor(cache_len, dtype=torch.int32, device="cuda")))
    return out


def phase_model_jamba():
    """jamba-v0.1-52b at its published width (d_model 4096, Mamba d_inner
    8192, d_state 16, d_conv 4, dt rank 256; one attention layer of 32
    heads over 8 KV heads x 128, no RoPE; 16 experts of d_ff 14336 at top-2
    on 4 of the 8 layers, dense d_ff 14336 on the others; vocab 65536), its
    depth cut to one block of 8 layers, random bf16 weights from seed 0.
    Two gathered ``Model.extend`` steps (``JAMBA_STEPS``): finite logits,
    ``flash_prefill`` launched once per fresh step (the attention layer's
    fresh rows) and not at all in decode; each profiled, with the Mamba
    layers' and the MoE's shares (their calls replayed alone). Returns
    (model, params)."""
    cfg, full_layers = jamba_block()
    free_device(f"the {JAMBA} block")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    store_bytes = sum(leaf.dtype.itemsize * math.prod(leaf.shape)
                      for leaves in cache_leaf_shapes(cfg) for leaf in leaves.values()
                      if leaf.state)
    log(f"[5 model] {cfg.name}: published width (d_model {cfg.d_model}, Mamba d_inner "
        f"{mamba_mod.d_inner_of(cfg)}, d_state {cfg.ssm_d_state}, dt rank "
        f"{mamba_mod.dt_rank_of(cfg)}; attention {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} KV heads x {cfg.head_dim}; {cfg.num_experts} experts top-"
        f"{cfg.top_k}, d_ff {cfg.d_ff}; vocab {cfg.vocab_size}), depth cut to one block: "
        f"{cfg.num_layers} of {full_layers} layers ("
        + ", ".join(f"{s.mixer}+{s.ff}" for s in model.specs)
        + f"): {nparam} params, {nparam * 2 / 1e9:.1f} GB bf16, built in "
        f"{time.perf_counter() - t0:.1f} s; state {store_bytes} B a sequence")
    for label, cache, tok, cl in state_steps(model, JAMBA_STEPS, JAMBA_W, 9):
        B, C = tok.shape

        def step():
            return model.extend(params, tok, cache, cl)[0]
        before = FLASH.launches
        logits = step().float()
        torch.cuda.synchronize()
        want = 1 if C > 1 else 0  # fresh rows in the one attention layer
        assert FLASH.launches - before == want, (label, FLASH.launches - before)
        assert logits.shape == (B, C, cfg.vocab_size) and torch.isfinite(logits).all()
        log(f"  {label}: logits finite (max |x| {logits.abs().max().item():.3g}), "
            f"flash_prefill launches {want}")
        del logits
        busy = device_profile(f"{cfg.name} extend {label} bf16", step, focus="flash_prefill")
        for fn_mod, name, what in ((mamba_mod, "mamba_forward", "Mamba layers"),
                                   (moe_mod, "moe_apply", "MoE")):
            part, n = replay_busy(fn_mod, name, step)
            log(f"    {what} ({n} {name} calls of the step replayed alone): {part:.3f} ms "
                "busy" + (f" = {part * 1e3 / busy:.1%} of the step's busy time" if busy
                          else ""))
        del cache
        torch.cuda.empty_cache()
    return model, params


def phase_jamba_f32(model, params):
    """One Mamba layer of the block in f32 at published width: a sequence of
    129 tokens fed in chunks of 37, 91 and 1 (the scan from a carried state,
    then the single-step branch) against the whole, outputs, final SSM
    state and conv window within STATE_ATOL_F32 (the twin of
    tests/test_recurrent.py::test_mamba_chunked_equals_full)."""
    cfg = dataclasses.replace(model.cfg, dtype="float32", param_dtype="float32")
    p32 = _to_f32(params["layers"][0]["mixer"])
    g = torch.Generator(device="cuda").manual_seed(6)
    x = 0.5 * torch.randn(2, 129, cfg.d_model, generator=g, device="cuda")
    whole, (conv_w, ssm_w) = mamba_mod.mamba_forward(p32, cfg, x)
    st = mamba_mod.init_mamba_cache(cfg, 2, torch.float32, "cuda")
    conv, ssm, outs = st["conv"], st["ssm"], []
    for lo, hi in ((0, 37), (37, 128), (128, 129)):
        y, (conv, ssm) = mamba_mod.mamba_forward(p32, cfg, x[:, lo:hi], conv_state=conv,
                                                 ssm_state=ssm)
        outs.append(y)
    check(f"{JAMBA} Mamba layer f32 (published width, B=2, S=129): chunks 37 + 91 + 1 vs "
          f"whole (outputs max |x| {whole.abs().max().item():.3g})", torch.cat(outs, 1),
          whole, STATE_ATOL_F32)
    check(f"{JAMBA} Mamba layer f32: final SSM state, chunks vs whole", ssm, ssm_w,
          STATE_ATOL_F32)
    # the last 3 inputs of in_proj: one matmul of another batch shape apart
    check(f"{JAMBA} Mamba layer f32: final conv window, chunks vs whole", conv, conv_w,
          STATE_ATOL_F32)
    del p32, x, whole, outs
    torch.cuda.empty_cache()


def state_host_bytes(engine, steps):
    """What ``host_copy_bytes`` charges a gathered state stack, the
    reference's count: per dispatch, each row's window of ``max_model_len``
    slots of every page leaf and the tokens it wrote, and each row's state
    slot read and written whole."""
    st, cfg = engine.store, engine.model.cfg
    per_token = sum(math.prod(s) for s in st.shapes) * st.dtype.itemsize
    W = engine.cfg.max_model_len
    return sum(len(s) * (W * per_token + 2 * st.state_bytes_per_slot())
               + sum(ln for _, ln in s) * per_token for s in steps)


def check_flash_served(model, steps) -> None:
    """``flash_prefill`` held against its plain version at every shape a
    serve gave it: per dispatch with a fresh row, (fresh rows, H, KV, the
    chunk's length, D), in the model's dtype and in f32, at FLASH_ATOL. Run
    after the serve's counts were read, so these launches count nowhere."""
    cfg = model.cfg
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = sorted({(sum(st == 0 for st, _ in s), max(ln for _, ln in s))
                     for s in steps if any(st == 0 for st, _ in s)})
    log(f"  flash_prefill at the serve's {len(shapes)} fresh shapes (B, S): {shapes}")
    for B, S in shapes:
        for dtype in dict.fromkeys((model.dtype, torch.float32)):
            q, k, v = flash_inputs(2, B, H, KV, S, D, dtype)
            check(f"flash_prefill served (B, H, KV, S, D) = {(B, H, KV, S, D)} "
                  f"{str(dtype)[6:]}", FLASH(q, k, v, scale=D ** -0.5),
                  flash_prefill_ref(q, k, v, scale=D ** -0.5), FLASH_ATOL[dtype])
            del q, k, v


def phase_serve_jamba(model, params, kv_quant=None, fp=None):
    """The Jamba block on the gathered backend (its only one) with the other
    serves' traffic: 8 requests, prompts of 128-512 tokens, 32 greedy tokens
    each, block 16, max_model_len 1024, prefill_chunk 256, 512 batched tokens
    a step, 8 state slots. Exact chunks: one dispatch per chunk length.
    ``flash_prefill`` launches once per dispatch holding a fresh row;
    ``host_copy_bytes`` equals ``state_host_bytes``. With ``kv_quant``
    (KIVI 8-bit attention pages beside the state slots):
    ``dequantize_pages`` 2 launches a dispatch, ``quantize_pages`` 2 per row
    whose chunk fills a page, tok/s and TTFT beside ``fp``'s. Returns
    (launches, tok/s, TTFT p50 s)."""
    cfg = model.cfg
    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=640, num_state_slots=8, max_model_len=1024,
        device="cuda", seed=0, kv_quant=kv_quant, scheduler=SchedulerConfig(
            max_batch_slots=8, max_batched_tokens=512, prefill_chunk=256)))
    runner, store = engine.runner, engine.store
    assert engine.paged_runner is None and store.quantized == (kv_quant is not None)
    assert engine.scheduler.cfg.exact_chunks and engine.prefix_cache is None
    steps = record_chunks(runner)
    add_traffic(engine, np.random.default_rng(7), "r")
    model.route_rows = dict.fromkeys(model.route_rows, 0)
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False)
    assert all(len({ln for _, ln in s}) == 1 for s in steps), "a ragged state dispatch"
    fresh = sum(any(st == 0 for st, _ in s) for s in steps)
    assert counts["flash_prefill"] == fresh == runner.prefill_steps > 0, (counts, fresh)
    check_flash_served(model, steps)
    want = state_host_bytes(engine, steps)
    assert engine.host_copy_bytes == want, (engine.host_copy_bytes, want)
    P = engine.cfg.block_size
    fills = sum((st + ln) // P > st // P for s in steps for st, ln in s)
    if kv_quant is None:
        assert counts["quantize_pages"] == counts["dequantize_pages"] == 0, counts
    else:
        assert counts["dequantize_pages"] == 2 * runner.steps, (counts, runner.steps)
        assert counts["quantize_pages"] == 2 * fills, (counts, fills)
    assert counts["paged_attention"] == counts["paged_attention_quant"] == counts["bgmv"] == 0
    gen = sum(m.num_generated for m in metrics)
    rate, ttft = gen / dt, statistics.median(m.ttft for m in metrics)
    slot = store.state_bytes_per_slot()
    kind = "fp pages" if kv_quant is None else f"KIVI {kv_quant.bits}-bit attention pages"
    extra = "" if fp is None else (f" ({rate / fp[0]:.2f}x the fp serve's {fp[0]:.1f}; "
                                   f"TTFT fp {fp[1] * 1e3:.0f} ms)")
    quant = "" if kv_quant is None else (
        f"; dequantize_pages {counts['dequantize_pages']} launches (= 2 x {runner.steps} "
        f"dispatches), quantize_pages {counts['quantize_pages']} (= 2 x {fills} rows "
        f"filling a page); window upload {runner.window_upload_bytes} B")
    log(f"[6 serve] {cfg.name} block, {kind}, gathered backend: 8 requests, "
        f"{sum(m.num_prompt for m in metrics)} prompt + {gen} generated tokens in {dt:.2f} s "
        f"= {rate:.1f} generated tok/s{extra}, TTFT p50 {ttft * 1e3:.0f} ms, {engine.steps} "
        f"steps in {runner.steps} dispatches ({runner.prefill_steps} with a fresh row); "
        f"flash_prefill {counts['flash_prefill']} launches (= 1 attention layer x "
        f"{fresh}); host_copy_bytes {engine.host_copy_bytes} (= formula: windows, written "
        f"tokens and {slot} B of state per row each way; "
        f"{engine.host_copy_bytes / engine.steps / 1e6:.1f} MB a step){quant}; "
        f"preemptions {engine.metrics_snapshot()['engine.preemptions']}")
    del engine
    return counts, rate, ttft


def phase_model_xlstm():
    """xlstm-1.3b whole (48 layers: 6 x (7 mLSTM + 1 sLSTM), d_model 2048, 4
    heads, mLSTM d_inner 4096, sLSTM FFN 4/3; vocab 50304), random bf16
    weights from seed 0. Three gathered ``Model.extend`` steps
    (``XLSTM_STEPS``): finite logits and no kernel (no attention); the
    chunkwise step and the decode step profiled, the recurrence step timed
    by the host clock (some 200 000 launches). Then one mLSTM layer in f32:
    a 256-token sequence whole (chunkwise) against four 64-token chunks
    from the carried state (the recurrence) within STATE_ATOL_F32. Returns
    (model, params)."""
    cfg = configs.get_config(XLSTM)
    free_device(XLSTM)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[5 model] {cfg.name}: published width and depth ({cfg.num_layers} layers: "
        f"{sum(s.mixer == 'mlstm' for s in model.specs)} mLSTM, "
        f"{sum(s.mixer == 'slstm' for s in model.specs)} sLSTM; d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, mLSTM d_inner {xlstm_mod.mlstm_d_inner(cfg)}; vocab "
        f"{cfg.vocab_size}): {nparam} params, {nparam * 2 / 1e9:.1f} GB bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    for label, cache, tok, cl in state_steps(model, XLSTM_STEPS, 16, 11):
        B, C = tok.shape

        def step():
            return model.extend(params, tok, cache, cl)[0]
        before = FLASH.launches
        t0 = time.perf_counter()
        logits = step().float()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert FLASH.launches == before
        assert logits.shape == (B, C, cfg.vocab_size) and torch.isfinite(logits).all()
        log(f"  {label}: logits finite (max |x| {logits.abs().max().item():.3g}), first "
            f"call {wall * 1e3:.0f} ms wall")
        del logits
        if C == 200:
            log(f"  {cfg.name} extend {label} bf16: wall {wall_ms(step, reps=2):.1f} ms "
                "(not profiled: one launch per op per time step)")
        else:
            device_profile(f"{cfg.name} extend {label} bf16", step)
        del cache
        torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = _to_f32(params["layers"][0]["mixer"])
    g = torch.Generator(device="cuda").manual_seed(8)
    x = 0.5 * torch.randn(2, 256, cfg.d_model, generator=g, device="cuda")
    whole, _ = xlstm_mod.mlstm_forward(p32, c32, x)
    st, outs = None, []
    for lo in range(0, 256, 64):
        y, st = xlstm_mod.mlstm_forward(p32, c32, x[:, lo:lo + 64], state=st)
        outs.append(y)
    check(f"{XLSTM} mLSTM layer f32 (published width, B=2, S=256): chunkwise vs 4 x 64 "
          f"by the recurrence (outputs max |x| {whole.abs().max().item():.3g})",
          torch.cat(outs, 1), whole, STATE_ATOL_F32)
    del p32, x, whole, outs, st
    torch.cuda.empty_cache()
    return model, params


def phase_serve_xlstm(model, params):
    """xlstm-1.3b on the gathered backend: 4 requests, prompts of 128-256
    tokens, 16 greedy tokens each, 4 state slots, block 16, max_model_len
    1024, prefill_chunk 256. No page leaf and no kernel: every byte of
    ``host_copy_bytes`` is a state slot, read and written whole, 706 511 616
    B a row each way."""
    cfg = model.cfg
    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=640, num_state_slots=4, max_model_len=1024,
        device="cuda", seed=0, scheduler=SchedulerConfig(
            max_batch_slots=4, max_batched_tokens=512, prefill_chunk=256)))
    runner, store = engine.runner, engine.store
    assert engine.paged_runner is None and not store.shapes
    assert len(store.state_leaves) == 4 * cfg.num_layers, len(store.state_leaves)
    slot = store.state_bytes_per_slot()
    assert slot == 706_511_616, slot
    steps = record_chunks(runner)
    add_traffic(engine, np.random.default_rng(7), "r", n=4, prompt=(128, 256), gen=16)
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False, n=4, gen=16)
    assert all(n == 0 for n in counts.values()), counts
    rows = sum(len(s) for s in steps)
    assert engine.host_copy_bytes == 2 * rows * slot == state_host_bytes(engine, steps)
    assert runner.window_upload_bytes == rows * slot, runner.window_upload_bytes
    gen = sum(m.num_generated for m in metrics)
    decode = [s for s in steps if all(ln == 1 for _, ln in s)]
    log(f"[6 serve] {cfg.name} whole, gathered backend, state slots only: 4 requests, "
        f"{sum(m.num_prompt for m in metrics)} prompt + {gen} generated tokens in {dt:.2f} s "
        f"= {gen / dt:.1f} generated tok/s, TTFT p50 "
        f"{statistics.median(m.ttft for m in metrics) * 1e3:.0f} ms, {engine.steps} steps "
        f"in {runner.steps} dispatches; state {slot} B a row each way (decode dispatches of "
        f"{sorted({len(s) for s in decode})} rows: "
        f"{max(len(s) for s in decode) * slot / 1e9:.2f} GB each way at the widest); "
        f"host_copy_bytes {engine.host_copy_bytes} (= 2 x {rows} rows x {slot} B); "
        f"kernel launches 0")
    del engine


def phase_recycled_slot():
    """The reference's dirty-slot fault, absent on the card: jamba at smoke
    width in f32, 4 state slots; a request served after another has
    finished (its slot handed out again) equals the same request in a
    fresh engine."""
    cfg = configs.smoke_config(JAMBA)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(5)
    reqs = [Request(request_id=f"r{i}", prompt=[int(t) for t in rng.integers(
        2, cfg.vocab_size, n)], sampling=SamplingParams(max_new_tokens=8))
        for i, n in enumerate((30, 45))]

    def engine():
        return LLMEngine(model, params, EngineConfig(
            block_size=8, num_blocks=128, num_state_slots=4, max_model_len=128,
            device="cuda"))
    fresh, reused = engine(), engine()
    fresh.add_request(dataclasses.replace(reqs[1]))
    fresh.run()
    reused.add_request(dataclasses.replace(reqs[0]))
    reused.step()
    slot = reused.seqs["r0"].state_slot
    reused.run()
    reused.add_request(dataclasses.replace(reqs[1]))
    reused.step()
    assert reused.seqs["r1"].state_slot == slot  # the finished request's slot
    reused.run()
    ok = reused.seqs["r1"].generated == fresh.seqs["r1"].generated
    log(f"[6 serve] {JAMBA} smoke f32, recycled state slot {slot}: the second request's "
        f"stream {reused.seqs['r1'].generated} "
        f"{'equals' if ok else 'DIFFERS FROM'} a fresh engine's")
    if not ok:
        raise AssertionError("a recycled state slot changed a stream")


# ---------------------------------------------------------------------------
# phase 9: the modality families — whisper-base (encoder, cross-attention,
# learned positions) and internvl2-2b (the image splice), served through
# request extras
# ---------------------------------------------------------------------------
WHISPER = "whisper-base"
INTERNVL = "internvl2-2b"


def record_paged_calls():
    """Patch the model's two paged-attention entries (``paged_attend``:
    decode; ``paged_attend_extend``: native chunked extend) so every call's
    (kind, q shape, page shape, table width, lengths) is appended to the
    returned list before it goes on to the op, whose kernel launch counts as
    before. Returns (the list, the patch)."""
    calls = []

    def wrap(kind, fn):
        def recorded(q, k, v, tables, lengths, *, scale):
            calls.append((kind, tuple(q.shape), tuple(k.shape), tables.shape[1],
                          lengths.clone()))
            return fn(q, k, v, tables, lengths, scale=scale)
        return recorded
    return calls, mock.patch.multiple(
        attn_mod, paged_attend=wrap("decode", ops.paged_attend),
        paged_attend_extend=wrap("extend", ops.paged_attend_extend))


def check_paged_served(calls) -> None:
    """``paged_attention`` held against its plain version at every distinct
    shape a serve gave it — decode (B, 1, H, D) and native chunked extend
    (B, C, H, D) — with the serve's lengths and table width, random pages
    and tables, bf16, at ATOL, through the model's ops (kernel, then the
    plain version under ``plain_attention``). Run after the serve's counts
    were read, so these launches count nowhere."""
    shapes = {}
    for kind, qs, ks, NP, lengths in calls:
        shapes.setdefault((kind, qs, ks[0], ks[2], NP), lengths.tolist())
    log(f"  paged_attention at the serve's {len(shapes)} distinct shapes (of "
        f"{len(calls)} calls): decode B "
        f"{sorted({qs[0] for kind, qs, *_ in shapes if kind == 'decode'})}, extend "
        f"(B, C) {sorted({qs[:2] for kind, qs, *_ in shapes if kind == 'extend'})}")
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(4)
    for (kind, qs, KV, P, NP), lengths in sorted(shapes.items(), key=str):
        B, H, D = qs[0], qs[2], qs[3]
        _, k, v, t, ln = inputs(3, B, KV, H // KV, D, P, B * NP, NP, torch.bfloat16,
                                lengths=lengths)
        q = torch.randn(qs, generator=g, device="cuda").to(torch.bfloat16)
        fn = ops.paged_attend if kind == "decode" else ops.paged_attend_extend
        got = fn(q, k, v, t, ln, scale=D ** -0.5)
        with plain_attention():
            want = fn(q, k, v, t, ln, scale=D ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATOL[torch.bfloat16]:
            check(f"paged_attention served {kind} {qs} NP={NP}", got, want,
                  ATOL[torch.bfloat16])
        worst = max(worst, err)
    log(f"  paged_attention at every served shape vs plain: max_abs_err={worst:.3g} "
        f"(atol {ATOL[torch.bfloat16]:g}) ok")


def timed_dispatches(runner):
    """Wrap ``runner.execute`` so each dispatch's (rows, longest chunk, host
    seconds) is appended to the returned list; a dispatch ends with its
    logits on the host, so the host clock covers its device work."""
    out, execute = [], runner.execute

    def run(batch):
        t0 = time.perf_counter()
        logits = execute(batch)
        out.append((len(batch.chunks), max(c.length for c in batch.chunks),
                    time.perf_counter() - t0))
        return logits
    runner.execute = run
    return out


def dispatch_walls(label, walls) -> str:
    """The median host time of ``walls``' prefill and decode dispatches."""
    parts = []
    for kind, sel in (("prefill", [w for w in walls if w[1] > 1]),
                      ("decode", [w for w in walls if w[1] == 1])):
        if sel:
            parts.append(f"{len(sel)} {kind} {statistics.median(w[2] for w in sel) * 1e3:.1f}"
                         f" ms median (max {max(w[2] for w in sel) * 1e3:.1f})")
    return f"{label} dispatches: " + ", ".join(parts)


def time_flash_shape(card, label, B, H, KV, S, D):
    """flash_prefill at one causal bf16 shape beside its bound, its plain
    version and SDPA(is_causal, enable_gqa), as phase 4 times starcoder2-3b's
    (no window)."""
    q, k, v = flash_inputs(5, B, H, KV, S, D, torch.bfloat16)
    scale = D ** -0.5
    got = FLASH(q, k, v, scale=scale)
    err = check(f"flash_prefill {label} timed shape vs plain", got,
                flash_prefill_ref(q, k, v, scale=scale), FLASH_ATOL[torch.bfloat16])
    ms = cuda_ms(lambda: FLASH(q, k, v, scale=scale))
    plain_ms = cuda_ms(lambda: flash_prefill_ref(q, k, v, scale=scale))

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                              enable_gqa=True)
    check(f"SDPA vs kernel {label}", library(), got, FLASH_ATOL[torch.bfloat16])
    library_ms = cuda_ms(library)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * D * live_pairs(S, 0)
    bound_ms, bound_by = bound(card, nbytes, flops, tensor_cores=True)
    log(f"[9 timing] flash_prefill {label} B={B} H={H} KV={KV} S={S} D={D} bf16 "
        f"({fmod.kernel_route(q.dtype, D)}): kernel {ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
        f"{bound_by}), plain {plain_ms * 1e3:.1f} us, SDPA(is_causal, enable_gqa) "
        f"{library_ms * 1e3:.1f} us; kernel / SDPA {ms / library_ms:.2f}; "
        f"{bound_ms / ms:.1%} of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def most_common_fresh(steps):
    """(fresh rows, chunk length) of the serve's most frequent fresh
    dispatch shape (the longest on a tie)."""
    shapes = [(sum(st == 0 for st, _ in s), max(ln for _, ln in s))
              for s in steps if any(st == 0 for st, _ in s)]
    return max(set(shapes), key=lambda sh: (shapes.count(sh), sh[1]))


def bf16_rows(rng, shape, scale):
    """Random rows rounded to bf16 (the host's numpy has no bf16), f32."""
    x = torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def modality_traffic(engine, rng, n, prompt, gen, extras):
    """``n`` requests, prompts of ``prompt`` random tokens, ``gen`` greedy
    tokens each, request i carrying ``extras(i)``."""
    vocab = engine.model.cfg.vocab_size
    for i in range(n):
        ln = int(rng.integers(prompt[0], prompt[1] + 1))
        engine.add_request(Request(
            request_id=f"r{i}", prompt=[int(x) for x in rng.integers(2, vocab, ln)],
            extras=extras(i), sampling=SamplingParams(temperature=0.0, max_new_tokens=gen)))


def phase_serve_whisper(card):
    """whisper-base whole (6 encoder + 6 decoder layers, d_model 512, 8 heads
    x 64, 1500 audio frames, 448 learned positions, vocab 51865), random
    bf16 weights from seed 0, on the gathered backend (its only one): 8
    requests, each with its own 1500 random frames (bf16-rounded), prompts
    of 16-64 tokens, 32 greedy tokens, block 16, max_model_len 448, 8 state
    slots. Exact chunks; the encoder runs on each request's first chunk and
    its cross K/V (18 432 000 B a slot) cross the host with every dispatch
    of that request, both ways. flash_prefill launches = 6 x the dispatches
    holding a fresh row (the wgmma route at D = 64), held against its plain
    version at every fresh shape; one decode step (B = 8) profiled. Returns
    (launches, the timing of the most common fresh shape)."""
    cfg = configs.get_config(WHISPER)
    free_device(WHISPER)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=256, num_state_slots=8, max_model_len=448,
        device="cuda", seed=0, scheduler=SchedulerConfig(
            max_batch_slots=8, max_batched_tokens=512, prefill_chunk=256)))
    runner, store = engine.runner, engine.store
    assert engine.paged_runner is None and engine.prefix_cache is None
    slot = store.state_bytes_per_slot()
    assert slot == 18_432_000, slot
    log(f"[9 serve] {cfg.name}: published width and depth ({cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, {cfg.num_heads} heads x "
        f"{cfg.head_dim}, {cfg.n_audio_ctx} frames, {cfg.learned_positions} positions): "
        f"{nparam} params, {nparam * 2 / 1e6:.1f} MB bf16, built in "
        f"{time.perf_counter() - t0:.1f} s; cross K/V {slot} B a state slot "
        f"({len(store.state_leaves)} leaves)")
    steps = record_chunks(runner)
    walls = timed_dispatches(runner)
    rng = np.random.default_rng(7)
    frames = [bf16_rows(rng, (cfg.n_audio_ctx, cfg.d_model), 1.0) for _ in range(8)]
    modality_traffic(engine, rng, 8, (16, 64), 32,
                     lambda i: {"audio_frames": frames[i]})
    metrics, dt, counts = run_served(engine, COUNTERS, paged=False)
    fresh = sum(any(st == 0 for st, _ in s) for s in steps)
    assert counts["flash_prefill"] == cfg.num_layers * fresh > 0, (counts, fresh)
    assert all(n == 0 for k, n in counts.items() if k != "flash_prefill"), counts
    assert engine.host_copy_bytes == state_host_bytes(engine, steps)
    rows = sum(len(s) for s in steps)
    gen = sum(m.num_generated for m in metrics)
    log(f"[9 serve] {cfg.name} whole, gathered backend: 8 requests, "
        f"{sum(m.num_prompt for m in metrics)} prompt + {gen} generated tokens in "
        f"{dt:.2f} s = {gen / dt:.1f} generated tok/s, TTFT p50 "
        f"{statistics.median(m.ttft for m in metrics) * 1e3:.0f} ms, {engine.steps} steps "
        f"in {runner.steps} dispatches ({fresh} with a fresh row: the encoder's); "
        f"flash_prefill {counts['flash_prefill']} launches (= {cfg.num_layers} x {fresh}, "
        f"{fmod.kernel_route(model.dtype, cfg.head_dim)}); cross K/V {slot / 1e6:.1f} MB a "
        f"row each way, {2 * rows * slot / 1e9:.2f} GB over {rows} dispatched rows; "
        f"host_copy_bytes {engine.host_copy_bytes} (= formula; "
        f"{engine.host_copy_bytes / engine.steps / 1e6:.1f} MB a step); window upload "
        f"{runner.window_upload_bytes} B")
    log("  " + dispatch_walls("gathered", walls))
    check_flash_served(model, steps)
    B, S = most_common_fresh(steps)
    timing = time_flash_shape(card, f"{cfg.name} fresh rows (the serve's most common)",
                              B, cfg.num_heads, cfg.num_kv_heads, S, cfg.head_dim)
    # one decode step (B = 8, C = 1) over a 448-slot window and 1500 cross rows
    cache = model.init_cache(8, 448)
    tok = torch.randint(2, cfg.vocab_size, (8, 1), device="cuda")
    cl = torch.tensor([40 + 45 * i for i in range(8)], dtype=torch.int32, device="cuda")
    device_profile(f"{cfg.name} decode step B=8 (extend C=1, cross over "
                   f"{cfg.n_audio_ctx} frames) bf16",
                   lambda: model.extend(params, tok, cache, cl)[0])
    del engine, model, params, cache
    return counts, timing


def phase_serve_internvl(card):
    """internvl2-2b at its published width and depth (24 layers, d_model
    2048, 16 heads over 8 KV heads x 128, d_ff 8192, vocab 92553), random
    bf16 weights from seed 0, on ``auto``: 8 requests, each with 256 random
    image rows (bf16-rounded, scale 0.02) ahead of a prompt of 128-512
    tokens, 32 greedy tokens, block 16, max_model_len 1024, prefill_chunk
    256, 512 batched tokens a step. The image's chunk [0, 256) runs
    gathered in a group of its own (flash_prefill: 24 launches per such
    dispatch, H 16 over KV 8, D 128), every other chunk and every decode
    paged (paged_attention: 24 per paged dispatch, G = 2). Both kernels held
    against their plain versions at the serve's shapes; one decode_paged
    step (B = 8) profiled. Returns (launches, the flash timing)."""
    cfg = configs.get_config(INTERNVL)
    free_device(INTERNVL)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    nparam = sum(x.numel() for x in _leaves(params))
    log(f"[9 serve] {cfg.name}: published width and depth ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{cfg.num_image_tokens} image rows): {nparam} params, {nparam * 2 / 1e9:.2f} GB "
        f"bf16, built in {time.perf_counter() - t0:.1f} s")
    engine = LLMEngine(model, params, EngineConfig(
        block_size=16, num_blocks=640, max_model_len=1024, device="cuda", seed=0,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=512,
                                  prefill_chunk=256)))
    runner, paged = engine.runner, engine.paged_runner
    assert paged is not None and engine.prefix_cache is not None
    gsteps = record_chunks(runner)
    gwalls, pwalls = timed_dispatches(runner), timed_dispatches(paged)
    rng = np.random.default_rng(7)
    images = [bf16_rows(rng, (cfg.num_image_tokens, cfg.d_model), 0.02) for _ in range(8)]
    modality_traffic(engine, rng, 8, (128, 512), 32,
                     lambda i: {"vision_embeds": images[i]})
    calls, patch = record_paged_calls()
    with patch:
        metrics, dt, counts = run_served(engine, COUNTERS, paged=None)
    fresh = sum(any(st == 0 for st, _ in s) for s in gsteps)
    assert all(st < cfg.num_image_tokens for s in gsteps for st, _ in s), gsteps
    assert counts["flash_prefill"] == cfg.num_layers * fresh > 0, (counts, fresh)
    assert counts["paged_attention"] == cfg.num_layers * engine.paged_steps == len(calls), \
        (counts, engine.paged_steps, len(calls))
    assert all(n == 0 for k, n in counts.items()
               if k not in ("flash_prefill", "paged_attention")), counts
    pc = engine.prefix_cache.stats
    assert pc.lookups == 0 and pc.inserted_blocks == 0, (pc.lookups, pc.inserted_blocks)
    snap = engine.metrics_snapshot()
    decode = sum(kind == "decode" for kind, *_ in calls) // cfg.num_layers
    gen = sum(m.num_generated for m in metrics)
    log(f"[9 serve] {cfg.name} published width, auto: 8 requests, "
        f"{sum(m.num_prompt for m in metrics)} prompt positions (256 image rows each) + "
        f"{gen} generated tokens in {dt:.2f} s = {gen / dt:.1f} generated tok/s, TTFT p50 "
        f"{statistics.median(m.ttft for m in metrics) * 1e3:.0f} ms, {engine.steps} steps: "
        f"{runner.steps} gathered dispatches (the images, {fresh} with a fresh row) and "
        f"{engine.paged_steps} paged ({decode} decode); flash_prefill "
        f"{counts['flash_prefill']} launches (= {cfg.num_layers} x {fresh}), "
        f"paged_attention {counts['paged_attention']} (= {cfg.num_layers} x "
        f"{engine.paged_steps}); dispatch counters gathered "
        f"{snap['engine.dispatch.gathered']} paged {snap['engine.dispatch.paged']}; "
        f"host_copy_bytes {engine.host_copy_bytes} (the image dispatches' windows); "
        f"prefix cache: 0 lookups, 0 blocks registered")
    log("  " + dispatch_walls("gathered (image)", gwalls) + "; "
        + dispatch_walls("paged", pwalls))
    check_flash_served(model, gsteps)
    check_paged_served(calls)
    B, S = most_common_fresh(gsteps)
    timing = time_flash_shape(card, f"{cfg.name} image chunk (the serve's most common)",
                              B, cfg.num_heads, cfg.num_kv_heads, S, cfg.head_dim)
    # one decode_paged step (B = 8) over 16-slot pages, rows at 400-750
    NB, P = 8 * 64, 16
    pages = model.init_pages(NB, P)
    tables = torch.arange(NB, dtype=torch.int32, device="cuda").reshape(8, 64)
    lengths = torch.tensor([400 + 50 * i for i in range(8)], dtype=torch.int32,
                           device="cuda")
    tok = torch.randint(2, cfg.vocab_size, (8, 1), device="cuda")
    device_profile(f"{cfg.name} decode_paged step B=8 bf16",
                   lambda: model.decode_paged(params, tok, pages, tables, lengths)[0],
                   focus=PAGED_FOCUS)
    del engine, model, params, pages
    return counts, timing


def smoke_serve_extras(arch, params, device):
    """The smoke config of ``arch`` in f32 on ``device`` with the given CPU
    weights: 4 greedy requests with random extras (audio frames, or image
    rows ahead of the text) over 8-token chunks, so an image straddles a
    chunk boundary. Returns (streams, engine)."""
    model = build_model(configs.smoke_config(arch), device=device)
    cfg = model.cfg
    eng = LLMEngine(model, _to_device(params, device), EngineConfig(
        block_size=8, num_blocks=128, max_model_len=128, device=device,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=64,
                                  prefill_chunk=6)))
    rng = np.random.default_rng(4)
    key, rows = (("audio_frames", cfg.n_audio_ctx) if cfg.family == "audio"
                 else ("vision_embeds", cfg.num_image_tokens))
    extras = [rng.normal(size=(rows, cfg.d_model)).astype(np.float32) for _ in range(4)]
    modality_traffic(eng, rng, 4, (12, 40), 12, lambda i: {key: extras[i]})
    eng.run()
    return {rid: s.generated for rid, s in eng.seqs.items()}, eng


def phase_modality_twins():
    """The f32 smoke twins of both families: the same weights and extras
    served on the CPU (plain versions) and on the card (kernels) give equal
    greedy streams."""
    for arch in (WHISPER, INTERNVL):
        params = build_model(configs.smoke_config(arch), device="cpu").init(0)
        cpu, _ = smoke_serve_extras(arch, params, "cpu")
        before = (FLASH.launches, KERNEL.launches)
        gpu, eng = smoke_serve_extras(arch, params, "cuda")
        same, total = equal_share(gpu, cpu)
        ok = gpu == cpu
        log(f"[9 serve] {arch} smoke f32 with extras: card vs CPU streams {same} of "
            f"{total} tokens equal, {eng.steps} steps ({eng.runner.steps} gathered, "
            f"{eng.paged_steps} paged dispatches), flash_prefill "
            f"{FLASH.launches - before[0]} / paged_attention {KERNEL.launches - before[1]} "
            f"launches: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{arch} smoke: the card's streams differ from the CPU's")


REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention/paged_attention.py:73",
    "paged_attention_quant": "src/repro/kernels/paged_attention/paged_attention.py:183",
    "quantize_pages": "src/repro/kernels/kv_quant/kv_quant.py:30",
    "dequantize_pages": "src/repro/kernels/kv_quant/kv_quant.py:60",
    "bgmv": "src/repro/kernels/lora/lora.py:35",
    "flash_prefill": "src/repro/kernels/flash_attention/flash_attention.py:73",
}


def main() -> None:
    name, card = phase_device()
    phase_build()
    phase_kernel()
    phase_kernel_quant()
    phase_kernel_verify()
    phase_kernel_kv_quant()
    phase_kernel_gathered_window()
    phase_kernel_lora()
    phase_kernel_flash()
    timing = {"paged_attention": phase_timing(card), **phase_timing_quant(card),
              **phase_timing_kv_quant(card), "bgmv": phase_timing_lora(card),
              "flash_prefill": phase_timing_flash(card)}
    model, params = build_olmo()
    phase_model(model, params)
    phase_model_quant(model, params)
    phase_model_lora(model, params)
    del model, params
    torch.cuda.empty_cache()
    fp_counts, fp_rate, fp_ttft, fp_streams = phase_serve()
    torch.cuda.empty_cache()
    q_counts, q_streams = phase_serve_quant()
    torch.cuda.empty_cache()
    lora_counts, lora_streams = phase_serve_lora(fp_rate, fp_ttft)
    torch.cuda.empty_cache()
    fp_ref = {"fp serve": fp_streams}
    for label, refs, kw in (
            ("self-speculation, fp pages", fp_ref, dict(traced=True)),
            ("hostile draft (olmo-1b at seed 1)", fp_ref,
             dict(draft_seed=1, min_acceptance=0.5, window=64)),
            ("self-speculation, KIVI 8-bit pages", dict(fp_ref, **{"KIVI serve": q_streams}),
             dict(kv_quant=QuantConfig(bits=8), plain_packs=q_counts["quantize_pages"])),
            ("self-speculation, LoRA rank 8 x 4 adapters over 2 slots",
             dict(fp_ref, **{"LoRA serve": lora_streams}),
             dict(lora=LoRAConfig(rank=8, alpha=16.0, max_loaded_adapters=2)))):
        phase_serve_spec(label, refs, fp_rate, **kw)
        torch.cuda.empty_cache()
    phase_serve_spec_lora_f32()
    torch.cuda.empty_cache()
    model, params = olmo_model("bfloat16")
    fp_bytes = phase_disagg(model, params, "the fp serve", fp_streams)
    phase_interference(model, params)
    phase_disagg(model, params, "the KIVI serve", q_streams, kv_quant=QuantConfig(bits=8),
                 fp_bytes=fp_bytes)
    phase_fleet(model, params)
    del model, params
    torch.cuda.empty_cache()
    model, params = olmo_model("float32")
    phase_disagg_f32(model, params)
    phase_fleet(model, params, f32=True)
    del model, params
    torch.cuda.empty_cache()
    phase_model_starcoder()
    sc_counts, sc_rate, sc_ttft = phase_serve_starcoder()
    torch.cuda.empty_cache()
    scq_counts = phase_serve_starcoder_quant(sc_rate, sc_ttft)
    torch.cuda.empty_cache()
    phase_model_llama4(card)
    torch.cuda.empty_cache()
    phase_serve_llama4()
    torch.cuda.empty_cache()
    model, params = phase_model_deepseek()
    ds_streams = phase_serve_deepseek(model, params)
    phase_serve_deepseek(model, params, kv_quant=QuantConfig(bits=8), ref=ds_streams)
    phase_deepseek_f32(model, params)
    del model, params
    torch.cuda.empty_cache()
    model, params = phase_model_jamba()
    jamba = phase_serve_jamba(model, params)
    phase_serve_jamba(model, params, kv_quant=QuantConfig(bits=8), fp=jamba[1:])
    phase_jamba_f32(model, params)
    del model, params
    model, params = phase_model_xlstm()
    phase_serve_xlstm(model, params)
    del model, params
    free_device("the smoke twins")
    phase_smoke_twins()
    phase_recycled_slot()
    w_counts, _ = phase_serve_whisper(card)
    torch.cuda.empty_cache()
    v_counts, _ = phase_serve_internvl(card)
    torch.cuda.empty_cache()
    phase_modality_twins()
    # each kernel's launches on the path it serves: fp pages for
    # paged_attention, KIVI pages for paged_attention_quant and
    # quantize_pages, the gathered KIVI starcoder2-3b serve for
    # dequantize_pages (its window), the LoRA serve for bgmv, the gathered
    # starcoder2-3b serve for flash_prefill
    launches = dict(q_counts, paged_attention=fp_counts["paged_attention"],
                    dequantize_pages=scq_counts["dequantize_pages"],
                    bgmv=lora_counts["bgmv"], flash_prefill=sc_counts["flash_prefill"])
    sources = {"paged_attention": kmod.SOURCE, "paged_attention_quant": qmod.SOURCE,
               "quantize_pages": kvmod.SOURCE, "dequantize_pages": kvmod.SOURCE,
               "bgmv": bgmod.SOURCE, "flash_prefill": fmod.SOURCE}
    # and each path's own count (set to 0 just before it, read just after)
    paths = {"olmo-1b paged fp": fp_counts, "olmo-1b paged KIVI": q_counts,
             "olmo-1b paged LoRA": lora_counts, "starcoder2-3b gathered": sc_counts,
             "starcoder2-3b gathered KIVI": scq_counts, "jamba block gathered": jamba[0],
             "whisper-base gathered": w_counts, "internvl2-2b auto": v_counts}
    kernels = [dict(name=k, route="cuda", source=os.path.relpath(sources[k], ROOT),
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=timing[k]["max_abs_err"], ms=timing[k]["ms"],
                    plain_ms=timing[k]["plain_ms"], bound_ms=timing[k]["bound_ms"],
                    bound_by=timing[k]["bound_by"], library_ms=timing[k]["library_ms"],
                    launches_by_path={p: c[k] for p, c in paths.items() if c.get(k)})
               for k in REPLACES]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
