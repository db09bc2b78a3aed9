"""LLMEngine: continuous-batching serving engine over paged KV storage.

The port of ``repro.core.engine`` for the paged fp configuration. This
module is the *policy* layer — admission, scheduling, block allocation,
copy-on-write, prefix caching, preemption, sampling, metrics; the
``PagedRunner`` is the mechanism: every step (pure decode, prompt chunks,
mixed SplitFuse steps) runs straight off block-indexed page stores through
``model.decode_paged`` / ``model.extend_paged`` and the CUDA paged-
attention kernel on the card.

The engine runs on ``EngineConfig.device`` (``cuda`` by default; ``cpu``
for the tests) and raises when CUDA is asked for and absent. Only the paged
backend exists: ``execution_backend`` "gathered" and "speculative" raise
``NotImplementedError`` naming their ROADMAP item. Sampling randomness
comes from one ``torch.Generator`` seeded from ``EngineConfig.seed``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.block_manager import BlockManager, OutOfBlocks
from repro_torch.core.executor import PagedModelState, PagedRunner, marshal_batch
from repro_torch.core.executor.base import ModelRunner
from repro_torch.core.metrics import RequestMetrics, VTCCounter, finalize_request
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.request import Request, SeqState, SeqStatus
from repro_torch.core.sampling import greedy_token_host, sample_token
from repro_torch.core.scheduler import ChunkWork, Scheduler, SchedulerConfig
from repro_torch.core.telemetry import NULL_TRACER, MetricsRegistry
from repro_torch.models.model import resolve_device

_NOT_PORTED = {
    "gathered": "ROADMAP queue A.3 (GatheredRunner)",
    "speculative": "ROADMAP queue A.6 (speculative decoding)",
}


@dataclasses.dataclass
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 512
    max_model_len: int = 256  # marshalled table width = max_model_len // block_size
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    enable_prefix_cache: bool = True
    host_cache_blocks: int = 0  # AttentionStore host tier (0 = off)
    execution_backend: str = "auto"  # auto | paged
    device: str = "cuda"  # where the model, the page mirror and the kernels run
    seed: int = 0


class LLMEngine:
    def __init__(self, model, params, engine_cfg: Optional[EngineConfig] = None):
        self.model = model
        self.params = params
        self.cfg = engine_cfg or EngineConfig()
        backend = self.cfg.execution_backend
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"execution_backend={backend!r} is not ported yet: "
                f"{_NOT_PORTED[backend]}")
        if backend not in ("auto", "paged"):
            raise ValueError(f"unknown execution_backend: {backend!r}")
        if resolve_device(self.cfg.device).type != model.device.type:
            raise ValueError(f"EngineConfig.device={self.cfg.device!r} but the "
                             f"model lives on {model.device}")
        self.device = model.device
        self.vtc = VTCCounter()
        self.scheduler = Scheduler(self.cfg.scheduler, self.vtc)
        self.bm = BlockManager(self.cfg.num_blocks, self.cfg.block_size)
        self.store = PagedModelState(model.cfg, self.cfg)
        self.paged_runner = PagedRunner(model, params, self.cfg, self.store)
        self.runner: ModelRunner = self.paged_runner
        # sacrificial page: ragged-chunk padding writes land here — reserved
        # up front so it can never be a member of a real block table
        self.paged_runner.scratch_block = self.bm.allocate(1)[0]
        self.prefix_cache = PrefixCache(self.bm,
                                        host_capacity_blocks=self.cfg.host_cache_blocks) \
            if self.cfg.enable_prefix_cache else None
        self.seqs: Dict[str, SeqState] = {}
        self.finished: List[RequestMetrics] = []
        self._gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.host_transfer_bytes = 0
        self.steps = 0
        self._step_inflight: Optional[set] = None
        # observability: the registry always exists; ``trace`` is the shared
        # no-op until a caller installs a StepTracer (on engine and runner)
        self.trace = NULL_TRACER
        self.metrics = MetricsRegistry()
        self._dispatch_counters = {
            self.runner.name: self.metrics.counter(
                f"engine.dispatch.{self.runner.name}")}
        self._preempt_counter = self.metrics.counter("engine.preemptions")
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Back the registry with the subsystems' own stats objects — gauges
        read them live at snapshot time."""
        reg, bm = self.metrics, self.bm
        reg.gauge("engine.steps", lambda: self.steps)
        reg.gauge("engine.host_copy_bytes", lambda: self.store.host_copy_bytes)
        reg.gauge("engine.host_transfer_bytes", lambda: self.host_transfer_bytes)
        reg.gauge("block_manager.num_blocks", lambda: bm.num_blocks)
        reg.gauge("block_manager.used_blocks", lambda: bm.used_blocks)
        reg.gauge("block_manager.utilization", bm.utilization)
        s = bm.stats
        reg.gauge("block_manager.allocated_blocks", lambda: s.allocated_blocks)
        reg.gauge("block_manager.freed_blocks", lambda: s.freed_blocks)
        reg.gauge("block_manager.cow_copies", lambda: s.cow_copies)
        reg.gauge("block_manager.peak_used", lambda: s.peak_used)
        if self.prefix_cache is not None:
            p = self.prefix_cache.stats
            reg.gauge("prefix_cache.lookups", lambda: p.lookups)
            reg.gauge("prefix_cache.hit_blocks", lambda: p.hit_blocks)
            reg.gauge("prefix_cache.host_hit_blocks", lambda: p.host_hit_blocks)
            reg.gauge("prefix_cache.miss_blocks", lambda: p.miss_blocks)
            reg.gauge("prefix_cache.inserted_blocks", lambda: p.inserted_blocks)
            reg.gauge("prefix_cache.evicted_blocks", lambda: p.evicted_blocks)
            reg.gauge("prefix_cache.demoted_blocks", lambda: p.demoted_blocks)
            reg.gauge("prefix_cache.hit_rate", lambda: p.hit_rate)
        r = self.paged_runner
        reg.gauge("runner.paged.steps", lambda: r.steps)
        reg.gauge("runner.paged.mirror_upload_bytes", lambda: r.mirror_upload_bytes)
        reg.gauge("runner.paged.writeback_bytes", lambda: r.writeback_bytes)

    def metrics_snapshot(self) -> Dict[str, float]:
        """Flat name -> value dict over every registered instrument."""
        return self.metrics.snapshot()

    @property
    def host_copy_bytes(self) -> int:
        """Gather/scatter window-staging traffic (0 on the paged path)."""
        return self.store.host_copy_bytes

    @property
    def paged_steps(self) -> int:
        """Batches executed on the paged backend."""
        return self.paged_runner.steps

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> SeqState:
        if req.extras or req.adapter_id is not None:
            raise NotImplementedError(
                f"request {req.request_id!r}: modality extras and LoRA "
                "adapters are not ported yet (ROADMAP queue A.8, A.11)")
        if req.arrival_time == 0.0:
            req.arrival_time = time.time()
        seq = SeqState(request=req)
        self.seqs[req.request_id] = seq
        self._prefix_lookup(seq)
        self.scheduler.add(seq)
        return seq

    def _prefix_lookup(self, seq: SeqState) -> None:
        """Prefix-cache lookup at admission and again while the request
        waits in queue (a burst of same-prefix requests can hit blocks
        inserted by whichever of them prefilled first)."""
        req = seq.request
        if self.prefix_cache is not None and len(req.prompt) > self.cfg.block_size:
            t0 = self.trace.now()
            dev_blocks, host_hashes, matched = self.prefix_cache.lookup(req.prompt)
            matched = min(matched, len(req.prompt) - 1)  # recompute >=1 token for logits
            usable = matched // self.cfg.block_size * self.cfg.block_size
            keep = usable // self.cfg.block_size
            if len(dev_blocks) > keep:
                self.bm.free(dev_blocks[keep:])  # drop refs the cap excluded
            dev_blocks = dev_blocks[:keep]
            seq.block_table.extend(dev_blocks)
            # host-tier restores: copy payloads into fresh blocks (bytes counted)
            for h in host_hashes[: max(0, usable // self.cfg.block_size - len(dev_blocks))]:
                payload = self.prefix_cache.host_payload(h)
                if payload is None:
                    break
                try:
                    nb = self.bm.allocate(1)[0]
                except OutOfBlocks:
                    break
                self.host_transfer_bytes += self.store.restore_block(nb, payload)
                seq.block_table.append(nb)
            seq.num_computed = len(seq.block_table) * self.cfg.block_size
            seq.prefix_hit_tokens = seq.num_computed
            if self.trace.enabled:
                self.trace.record("prefix_lookup", "prefix_cache", t0,
                                  self.trace.now() - t0, seq=req.request_id,
                                  hit_tokens=seq.prefix_hit_tokens)

    # ------------------------------------------------------------------
    def _alloc_for(self, seq: SeqState, target_tokens: int,
                   protected: Optional[set] = None) -> None:
        """Grow seq's block table; on pressure, evict prefix-cache blocks then
        preempt running sequences — but never one in the current batch group
        (``protected``), whose pages this step will read."""
        while True:
            try:
                self.bm.ensure_capacity(seq.block_table, target_tokens)
                return
            except OutOfBlocks:
                if not self._relieve_pressure(protected or {seq.request_id}):
                    raise

    def _relieve_pressure(self, protected: set) -> bool:
        """One rung of the memory-pressure ladder: evict prefix-cache blocks,
        else preempt a sequence outside ``protected``. False = nothing left."""
        if self.prefix_cache is not None and self.prefix_cache.evict(
                4, demote_payload_fn=(self.store.block_payload
                                      if self.cfg.host_cache_blocks else None)):
            return True
        victim = self._pick_victim(protected)
        if victim is None:
            return False
        self._do_preempt(victim)
        return True

    def _pick_victim(self, protected: set) -> Optional[SeqState]:
        cands = [s for s in self.scheduler.running
                 if s.request_id not in protected and s.block_table]
        if not cands:
            return None
        # preempt the most recently arrived (FCFS-preserving)
        return max(cands, key=lambda s: s.request.arrival_time)

    def _do_preempt(self, seq: SeqState) -> None:
        self._preempt_counter.inc()
        if self.trace.enabled:
            self.trace.event("preempt", seq=seq.request_id,
                             computed=seq.num_computed)
        self._free_seq_memory(seq)
        self.scheduler.preempt(seq)

    def _free_seq_memory(self, seq: SeqState) -> None:
        if seq.block_table:
            self.bm.free(seq.block_table)
            seq.block_table = []

    # ------------------------------------------------------------------
    def _run_group(self, chunks: List[ChunkWork], runner: ModelRunner) -> None:
        """Allocate for a group of chunks, execute it on ``runner``, sample."""
        # allocation pass first: a preemption victim must never be a sequence
        # whose pages this step is about to read
        inflight = self._step_inflight or {c.seq.request_id for c in chunks}
        ready: List[ChunkWork] = []
        for ch in chunks:
            if ch.seq.status is not SeqStatus.RUNNING:
                continue  # preempted by an earlier chunk of this step
            try:
                self._alloc_for(ch.seq, ch.start + ch.length, protected=inflight)
                self._handle_cow(ch.seq, ch)
                ready.append(ch)
            except OutOfBlocks:
                # cannot fit this chunk even after evictions: self-preempt and
                # let the scheduler retry once memory frees up
                self._do_preempt(ch.seq)
        if not ready:
            return
        tr = self.trace
        with tr.span("marshal"):
            batch = marshal_batch(ready, self.cfg.block_size,
                                  self.cfg.max_model_len)
        self._dispatch_counters[runner.name].inc()
        if tr.enabled:
            with tr.span("dispatch", track="executor",
                         **self._dispatch_args(ready, runner)):
                logits_np = runner.execute(batch)
            with tr.span("postprocess"):
                self._postprocess(ready, logits_np)
        else:
            logits_np = runner.execute(batch)
            self._postprocess(ready, logits_np)

    def _dispatch_args(self, chunks: List[ChunkWork],
                       runner: ModelRunner) -> dict:
        """Span args for one dispatch (tracing-on path only)."""
        ntok = sum(c.length for c in chunks)
        return {"backend": runner.name, "batch": len(chunks), "tokens": ntok,
                "phase": "decode" if ntok == len(chunks) else "prefill"}

    def _postprocess(self, chunks: List[ChunkWork], logits_np: np.ndarray) -> None:
        """Sampling, prefix-cache publication, accounting, stop conditions."""
        bs = self.cfg.block_size
        now = time.time()
        for b, ch in enumerate(chunks):
            seq = ch.seq
            seq.num_computed = max(seq.num_computed, ch.start + ch.length)
            end = ch.start + ch.length
            # publish completed full prompt blocks immediately so concurrent
            # same-prefix requests can reuse them (vLLM-style eager insert)
            if self.prefix_cache is not None and seq.num_computed >= bs:
                prompt_computed = min(seq.num_computed, seq.prompt_len)
                nfull = prompt_computed // bs
                self.prefix_cache.insert(seq.request.prompt[: nfull * bs],
                                         seq.block_table[:nfull])
            prompt_overlap = max(0, min(end, seq.prompt_len) - ch.start)
            if end < seq.total_len:
                # prefill chunk (or recompute of generated tokens after
                # preemption): no token emitted
                self.vtc.charge(seq.request.user_id, input_tokens=prompt_overlap)
                continue
            self.vtc.charge(seq.request.user_id, input_tokens=prompt_overlap,
                            output_tokens=1)
            last = logits_np[b, ch.length - 1]
            if seq.request.sampling.temperature <= 0.0:
                tok = greedy_token_host(last)
            else:
                logits = torch.from_numpy(last[None]).to(self.device)
                tok = int(sample_token(self._gen, logits,
                                       seq.request.sampling)[0])
            if self._append_token(seq, tok, now):
                self._finish(seq, now)

    def _append_token(self, seq: SeqState, tok: int, now: float) -> bool:
        """Emit one token; returns True when the sequence must stop."""
        if seq.first_token_time is None:
            seq.first_token_time = now
        seq.token_times.append(now)
        seq.generated.append(tok)
        sp = seq.request.sampling
        return (sp.stop_token is not None and tok == sp.stop_token) or \
            len(seq.generated) >= sp.max_new_tokens or \
            seq.total_len >= self.cfg.max_model_len - 1

    def _handle_cow(self, seq: SeqState, ch: ChunkWork) -> None:
        """Copy-on-write for shared blocks the chunk will write into."""
        bs = self.cfg.block_size
        first_blk = ch.start // bs
        last_blk = (ch.start + ch.length - 1) // bs
        for i in range(first_blk, min(last_blk + 1, len(seq.block_table))):
            blk = seq.block_table[i]
            new = self.bm.copy_on_write(blk)
            if new is not None:
                self.store.copy_block(blk, new)
                seq.block_table[i] = new

    def _finish(self, seq: SeqState, now: float) -> None:
        seq.finish_time = now
        if self.prefix_cache is not None:
            self.prefix_cache.insert(seq.all_tokens, seq.block_table)
        self.scheduler.finish(seq)
        self._free_seq_memory(seq)
        self.finished.append(finalize_request(seq))

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration; returns number of tokens processed."""
        # late prefix lookups: queued requests may hit blocks a sibling request
        # inserted after they were admitted (burst of same-system-prompt reqs)
        if self.prefix_cache is not None:
            for seq in list(self.scheduler.waiting)[:8]:
                if seq.num_computed == 0 and not seq.generated and \
                        not seq.block_table:
                    self._prefix_lookup(seq)
        with self.trace.span("schedule", track="scheduler"):
            plan = self.scheduler.plan(time.time())
        if not plan.chunks:
            return 0
        self.steps += 1
        if self.trace.enabled:
            self.trace.event("step", step=self.steps, num_tokens=plan.num_tokens,
                             decode=len(plan.decode), prefill=len(plan.prefill))
        self._step_inflight = {c.seq.request_id for c in plan.chunks}
        try:
            # the whole ragged plan — decodes AND prompt chunks — fuses into
            # ONE paged dispatch (decode_paged when all lengths are 1)
            self._run_group(plan.chunks, self.runner)
        finally:
            self._step_inflight = None
        return plan.num_tokens

    def run(self, max_steps: int = 10_000) -> List[RequestMetrics]:
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                break
            self.step()
        return self.finished
