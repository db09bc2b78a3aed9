"""Continuous batching + chunked prefill scheduler (survey §IV.A).

One scheduler step assembles a *unified* token batch (DeepSpeed-FastGen
SplitFuse / Sarathi-Serve stall-free batching): every running decode sequence
contributes 1 token, and remaining token budget is given to prompt chunks of
prefilling sequences, so decodes are never stalled behind long prompts.

Policies (pluggable orderings over the admission/chunk queues):
  * fcfs — arrival order (Orca)
  * vtc  — least-served user first (fairness, survey §VI.C)
  * qoe  — earliest token-deadline first (Andes, survey §V.B)
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.core.metrics import VTCCounter
from repro_torch.core.request import Request, SeqState, SeqStatus


@dataclasses.dataclass
class SchedulerConfig:
    max_batch_slots: int = 8  # max sequences per step
    max_batched_tokens: int = 256  # SplitFuse token budget per step
    prefill_chunk: int = 64  # Sarathi chunk size
    policy: str = "fcfs"  # fcfs | vtc | qoe
    enable_chunked_prefill: bool = True
    exact_chunks: bool = False  # state-mixer models: chunks must be exact
    # speculative decoding: each decode chunk really costs 1 + k tokens of
    # model work (the input token + k drafted positions verified together),
    # so the SplitFuse budget must charge it that way or a spec step blows
    # past max_batched_tokens (k+1)x. 0 = speculation off.
    speculative_tokens: int = 0
    # multi-tenant LoRA (docs/lora.md): max DISTINCT adapters one step may
    # reference. Caps the adapter working set the store must keep resident
    # for the batch (the engine clamps it to the device table capacity);
    # sequences whose adapter would exceed it simply wait a step. 0 = no
    # cap. Requests without an adapter never count.
    max_adapters_per_batch: int = 0


@dataclasses.dataclass
class ChunkWork:
    seq: SeqState
    start: int  # token index into prompt+generated where this chunk begins
    length: int


@dataclasses.dataclass
class StepPlan:
    """One step's work, split by work kind (docs/scheduling.md).

    ``decode`` chunks (length 1, sequence past prefill) and ``prefill``
    chunks (prompt or recompute spans) both run straight off the paged KV
    stores on a paged-capable backend — ``chunks``, the unified decode-first
    view (SplitFuse order), is what the engine marshals into ONE fused
    ragged batch per step (``model.extend_paged``; ``model.decode_paged``
    when every chunk is length 1). The split still matters to the
    speculative backend, which takes the decode group through draft–verify
    and leaves prefill chunks to the plain paged path, and to gathered-only
    model families, which run ``chunks`` through ``model.extend``."""
    decode: List[ChunkWork] = dataclasses.field(default_factory=list)
    prefill: List[ChunkWork] = dataclasses.field(default_factory=list)
    # tokens of speculative headroom budgeted per decode chunk (0 = none);
    # the executor may still verify fewer near the context-window edge
    spec_tokens: int = 0

    @property
    def chunks(self) -> List[ChunkWork]:
        return self.decode + self.prefill

    @property
    def num_tokens(self) -> int:
        return sum(c.length for c in self.chunks)

    @property
    def num_seqs(self) -> int:
        return len(self.chunks)


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class Scheduler:
    def __init__(self, config: SchedulerConfig, vtc: Optional[VTCCounter] = None):
        self.cfg = config
        self.waiting: Deque[SeqState] = deque()
        self.running: List[SeqState] = []
        self.vtc = vtc or VTCCounter()

    # ------------------------------------------------------------------
    def add(self, seq: SeqState) -> None:
        seq.status = SeqStatus.WAITING
        self.waiting.append(seq)

    def preempt(self, seq: SeqState) -> None:
        """Victim loses its KV; it will recompute via prefill when re-admitted
        (SpotServe-style recompute-recovery; generated tokens are kept)."""
        if seq in self.running:
            self.running.remove(seq)
        seq.status = SeqStatus.PREEMPTED
        seq.num_computed = 0
        seq.preemptions += 1
        self.waiting.appendleft(seq)

    def finish(self, seq: SeqState) -> None:
        if seq in self.running:
            self.running.remove(seq)
        seq.status = SeqStatus.FINISHED

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------
    def _order_key(self, now: float) -> Callable[[SeqState], tuple]:
        if self.cfg.policy == "vtc":
            return lambda s: (self.vtc.service(s.request.user_id),
                              s.request.arrival_time)
        if self.cfg.policy == "qoe":
            # urgency: next-token deadline = arrival + expected_ttft + n/tds
            return lambda s: (s.request.arrival_time +
                              (1.0 + len(s.generated) / 10.0), s.request.arrival_time)
        return lambda s: (s.request.arrival_time,)

    def plan(self, now: float = 0.0) -> StepPlan:
        cfg = self.cfg
        decode_chunks: List[ChunkWork] = []
        chunks: List[ChunkWork] = []
        budget = cfg.max_batched_tokens
        slots = cfg.max_batch_slots
        key = self._order_key(now)

        # adapter grouping (multi-tenant LoRA): one step references at most
        # max_adapters_per_batch DISTINCT adapters; a sequence whose adapter
        # would blow the cap is skipped this step (it stays runnable), so
        # the batch groups around the adapters already admitted
        adapters: set = set()

        def adapter_fits(s: SeqState) -> bool:
            aid = s.request.adapter_id
            return (aid is None or aid in adapters
                    or not cfg.max_adapters_per_batch
                    or len(adapters) < cfg.max_adapters_per_batch)

        def note_adapter(s: SeqState) -> None:
            if s.request.adapter_id is not None:
                adapters.add(s.request.adapter_id)

        # 1) decodes first — stall-free: every running decoded seq advances
        # a decoding seq's next input is its last generated token, at position
        # num_computed (== total_len - 1)
        decoding = sorted([s for s in self.running if not s.in_prefill], key=key)
        cost = 1 + cfg.speculative_tokens
        for s in decoding:
            if slots <= 0:
                break
            if cfg.speculative_tokens and budget < cost and decode_chunks:
                break  # a speculating decode charges k+1 tokens of budget
            if not adapter_fits(s):
                continue
            note_adapter(s)
            decode_chunks.append(ChunkWork(s, s.num_computed, 1))
            budget -= cost
            slots -= 1

        # 2) ongoing chunked prefills
        prefilling = sorted([s for s in self.running if s.in_prefill], key=key)

        # 3) admit waiting requests while there is room
        admitted: List[SeqState] = []
        waiting_sorted = sorted(self.waiting, key=key)
        for s in waiting_sorted:
            if slots - len(prefilling) - len(admitted) <= 0 or budget <= 0:
                break
            admitted.append(s)
        for s in admitted:
            self.waiting.remove(s)
            s.status = SeqStatus.RUNNING
            self.running.append(s)
        prefilling = prefilling + admitted

        for s in prefilling:
            if slots <= 0 or budget <= 0:
                break
            if not adapter_fits(s):
                continue
            want = min(s.remaining_prefill(), cfg.prefill_chunk, budget)
            if not cfg.enable_chunked_prefill:
                # Orca-style: whole prompt or nothing
                if s.remaining_prefill() > budget:
                    continue
                want = s.remaining_prefill()
            if cfg.exact_chunks and want < s.remaining_prefill():
                # state-mixer models: keep chunk lengths pow2 so the jit cache
                # stays small while every chunk is exact (no padded recurrence)
                want = _pow2_floor(want)
            if want <= 0:
                continue
            note_adapter(s)
            chunks.append(ChunkWork(s, s.num_computed, want))
            budget -= want
            slots -= 1
        return StepPlan(decode=decode_chunks, prefill=chunks,
                        spec_tokens=cfg.speculative_tokens)
