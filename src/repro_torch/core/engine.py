"""LLMEngine: continuous-batching serving engine over paged KV storage.

The port of ``repro.core.engine``. This module is the *policy* layer —
admission, scheduling, block allocation, copy-on-write, prefix caching,
preemption, sampling, metrics; a runner is the mechanism
(``executor.make_runners``). On a pure global-attention stack the
``PagedRunner`` runs every step (pure decode, prompt chunks, mixed
SplitFuse steps) straight off block-indexed page stores through
``model.decode_paged`` / ``model.extend_paged`` and the CUDA paged-
attention kernel on the card. Stacks without a paged family (sliding-
window attention: starcoder2-3b; chunked attention: llama4-scout; MLA:
deepseek-v3; state mixers: jamba-v0.1-52b, xlstm-1.3b; whisper-base's
encoder-decoder), ``kv_quant``
configs the quantized pages cannot hold, and any stack under
``execution_backend="gathered"``, run on the ``GatheredRunner``: pages
gathered into dense windows, ``model.extend``, the written slots scattered
back, every prompt's first chunk through the CUDA ``flash_prefill``
kernel.

A stack with a state mixer (Mamba, mLSTM, sLSTM) also holds one
fixed-size *state slot* per sequence, from a slab of
``EngineConfig.num_state_slots`` apart from the KV blocks (the block
manager's state slots, the survey's paged memory applied to a model
without a KV cache). As in the reference, such an engine schedules exact
chunk groups (one dispatch per chunk length, so no state runs over
padding) and turns prefix reuse off (a state is not content-addressable
per block). Unlike the reference, a slot is reset to the model's empty
history whenever ``_alloc_for`` hands it out: the reference reuses a freed
slot as it was left, so a recycled or re-allocated slot (after a finish
or a preemption) starts from its previous owner's final state there
(ROADMAP C).

Requests may carry modality extras (``Request.extras``): whisper's
``audio_frames`` and internvl's ``vision_embeds``. Every chunk that carries
them (``executor.base.chunk_carries_extras``: a request's first chunk, and
any chunk over an image position) runs gathered, in a group of its own, on
both the exact-chunks and the fused path; any batch a runner cannot take
(``ModelRunner.supports``) falls back to the gathered one. whisper's
encoder runs on the first chunk and its cross K/V stay in the request's
state slot (the reference counts an audio stack's cross K/V as state, so
prefix reuse is off and chunks are exact). An image's N rows own KV
positions [0, N) ahead of the text (``SeqState.image_len``): block tables,
the token budget, chunk boundaries and ``max_model_len`` count them, the
first token is sampled at position N + len(prompt) - 1, and the prefix
cache neither looks up nor registers such a request (its placeholder
tokens would match another image's pages). The reference's engine
delivers the image with the first chunk but keeps the text's positions
(ROADMAP C): the port serves what the reference's model gives.

The engine runs on ``EngineConfig.device`` (``cuda`` by default; ``cpu``
for the tests) and raises when CUDA is asked for and absent.
``execution_backend="speculative"`` (or ``EngineConfig.speculative`` under
"auto") layers a ``SpeculativeRunner`` on the paged backend: decode groups
go through draft–verify (k draft tokens, k + 1 positions verified in one
target forward, ``core.sampling.rejection_sample`` on the device), prompt
chunks stay on the paged path; greedy output equals plain paged decoding
for any draft (over KIVI pages up to the reference's own divergence: a
verify chunk reads the page it has just filled through the fp tail).
``EngineConfig.kv_quant`` with the KIVI axes and no GEAR residual, on an
attention K/V store, stores KIVI-quantized pages (uint8 codes + f16
scale/zero planes) that the quantized CUDA kernel reads on the paged
backend, and that the gathered backend dequantizes on the device; any other
``QuantConfig`` (or MLA latents) keeps fp pages, serves on the gathered
backend and stores each written value's quantize–dequantize round trip, as
the reference does. ``EngineConfig.lora`` (global-
attention stacks, either backend) serves many LoRA adapters of the one
base model in the same batch: each request names its ``adapter_id``, the
``PagedAdapterStore`` faults adapters into device tables by renting
KV-pool pages, and every step applies each row's deltas through the
``bgmv`` kernel. Sampling randomness comes from one
``torch.Generator`` seeded from ``EngineConfig.seed``.
``EngineConfig.telemetry`` turns on the step tracer, whose paged decode
dispatch spans carry the card's roofline bound (``launch/roofline.py``).
``export_seq`` / ``import_seq`` move a sequence's tokens and KV pages
(fp, or KIVI codes, planes and a still-filling page's staging) and its
state slot between engines: the primitive of ``core.disagg`` and
``core.fleet``. A payload holds the model's global pages (every KV head)
whatever either engine's layout, as the reference's global host store
gives them, so a sequence moves between engines of any model axes.

With ``EngineConfig.sharding`` asking for more than one rank, the paged
slot holds a ``ShardedPagedRunner`` (``executor/sharded.py``): the engine
is one rank of a ``(data, model)`` mesh of processes, every rank runs the
same engine on the same requests, and the paged calls run the shard-local
model with one all-reduce per layer over the rank's model group. Its page
store holds the rank's KV heads (all of them under the replicated-KV
fallback), and ``host_copy_bytes`` stays 0 as on the single-device paged
path. Where its KV heads are cut (``kv_group``), ``export_seq`` gathers a
sequence's pages over the model group in one all-gather and
``import_seq`` keeps the rank's contiguous cut of global pages; the
prefix cache's host tier stays rank-local (no collective). The gathered
backend is single-device, so such an engine builds no
gathered runner (``self.runner`` is None) and refuses a stack without a
paged family and requests with modality extras. It takes the rank's
parameters (``executor.sharded.rank_params`` / ``shard_params``), and
speculation on it takes its whole draft from the ``SpeculativeConfig``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.block_manager import BlockManager, OutOfBlocks
from repro_torch.core.executor import PagedModelState, make_runners, marshal_batch
from repro_torch.core.executor.base import ModelRunner, chunk_carries_extras
from repro_torch.core.executor.sharded import paged_layout
from repro_torch.core.executor.state import map_page, page_bytes, page_tensors
from repro_torch.core.executor.speculative import SpeculativeRunner
from repro_torch.core.kv_quant import QuantConfig
from repro_torch.core.lora import LoRAConfig, PagedAdapterStore
from repro_torch.core.metrics import (RequestMetrics, SpeculativeStats, VTCCounter,
                                      finalize_request)
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.request import Request, SeqState, SeqStatus
from repro_torch.core.sampling import (SamplingParams, greedy_token_host,
                                       rejection_sample, sample_token)
from repro_torch.core.scheduler import ChunkWork, Scheduler, SchedulerConfig
from repro_torch.core.telemetry import (NULL_TRACER, MetricsRegistry, StepTracer,
                                        TelemetryConfig)
from repro_torch.models.model import STATE_MIXERS, resolve_device
from repro_torch.sharding import ShardingConfig

@dataclasses.dataclass
class SpeculativeConfig:
    """Draft–verify speculative decoding (survey §II.B).

    ``draft_model`` / ``draft_params``: a built ``Model`` on the engine's
    device and its params, sharing the target's vocabulary, with a paged
    decode path. None = self-speculation (the target drafts for itself:
    the correctness harness, every draft accepted in exact arithmetic); a
    sharded engine holds only its rank's slices of the target, so it is
    given the whole draft, the target's own model and tree for
    self-speculation.
    ``num_draft_tokens``: k tokens proposed and verified per decode step.
    Auto-disable: once the rolling window holds >= ``window`` proposals and
    their acceptance rate is below ``min_acceptance``, the engine falls
    back to plain paged decode for good. 0 disables the check."""
    num_draft_tokens: int = 4
    draft_model: Any = None
    draft_params: Any = None
    min_acceptance: float = 0.0
    window: int = 64


@dataclasses.dataclass
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 512
    num_state_slots: int = 32  # per-sequence state slots of state-mixer stacks
    max_model_len: int = 256  # marshalled table width = max_model_len // block_size
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    enable_prefix_cache: bool = True
    host_cache_blocks: int = 0  # AttentionStore host tier (0 = off)
    execution_backend: str = "auto"  # auto | gathered | paged | speculative
    device: str = "cuda"  # where the model, the page mirror and the kernels run
    seed: int = 0
    kv_quant: Optional[QuantConfig] = None  # KIVI pages at rest
    lora: Optional[LoRAConfig] = None  # multi-tenant LoRA serving
    speculative: Optional[SpeculativeConfig] = None  # draft–verify decode
    # step tracing + roofline annotation; the metrics registry is on
    # regardless — None only disables the tracer
    telemetry: Optional[TelemetryConfig] = None
    # tensor-parallel paged serving on a (data, model) mesh of ranks; None or
    # a 1x1 config keeps every backend single-device
    sharding: Optional[ShardingConfig] = None


def _has_state_mixer(cfg) -> bool:
    """Whether the stack carries per-sequence state (Mamba, mLSTM, sLSTM
    layers; the reference counts an audio stack's cross-attention KV too)."""
    return any(s.mixer in STATE_MIXERS
               for p, _ in cfg.stages for s in p) or cfg.family == "audio"


class LLMEngine:
    def __init__(self, model, params, engine_cfg: Optional[EngineConfig] = None):
        self.model = model
        self.params = params
        self.cfg = engine_cfg or EngineConfig()
        if _has_state_mixer(model.cfg):
            # one dispatch per chunk length, and no prefix reuse: cached
            # blocks determine neither a recurrent state nor a cross K/V
            self.cfg = dataclasses.replace(
                self.cfg, enable_prefix_cache=False, scheduler=dataclasses.replace(
                    self.cfg.scheduler, exact_chunks=True))
        backend = self.cfg.execution_backend
        if resolve_device(self.cfg.device).type != model.device.type:
            raise ValueError(f"EngineConfig.device={self.cfg.device!r} but the "
                             f"model lives on {model.device}")
        self.device = model.device
        self.vtc = VTCCounter()
        self.scheduler = Scheduler(self.cfg.scheduler, self.vtc)
        self.bm = BlockManager(self.cfg.num_blocks, self.cfg.block_size,
                               self.cfg.num_state_slots)
        # a rank of a sharded engine stores the KV heads it serves: the page
        # store takes the shard-local config (a stack without a paged family
        # keeps its own, and make_runners refuses it)
        sh = self.cfg.sharding
        self.sharded = sh is not None and sh.num_devices > 1
        if self.sharded and (backend == "speculative" or self.cfg.speculative is not None) \
                and (self.cfg.speculative is None or self.cfg.speculative.draft_model is None):
            raise ValueError(
                "a sharded engine holds its rank's slices of the target: give "
                "speculation its whole draft (SpeculativeConfig.draft_model and "
                "draft_params; the target's model and whole tree to self-speculate)")
        store_cfg, kv_div = model.cfg, 1
        if self.sharded and model.decode_paged is not None:
            layout = paged_layout(model.cfg, sh.model_axis)
            store_cfg, kv_div = layout.local_cfg, sh.model_axis if layout.kv_sharded else 1
        self.store = PagedModelState(store_cfg, self.cfg, device=self.device)
        self.runner, self.paged_runner = make_runners(model, params, self.cfg,
                                                      self.store)
        # the model group the store's KV heads are cut over; None where it
        # holds every KV head (one device, the replicated-KV fallback)
        self.kv_group = self.paged_runner.tp if kv_div > 1 else None
        if self.paged_runner is not None:
            # sacrificial page: ragged-chunk padding writes land here —
            # reserved up front so it can never be a member of a real table
            self.paged_runner.scratch_block = self.bm.allocate(1)[0]
        # multi-tenant LoRA: the store rents KV pool pages, so resident
        # adapters and cache trade off under one memory budget
        self.adapters: Optional[PagedAdapterStore] = None
        if self.cfg.lora is not None:
            if model.decode_paged is None:
                raise ValueError(
                    "EngineConfig.lora needs a pure global-attention stack "
                    "(the LoRA sites assume the paged-capable layer layout)")
            # adapters rent pages at the whole block's bytes, every KV head
            # counted, as on one device: every rank takes the same decisions
            self.adapters = PagedAdapterStore(
                model.cfg, self.cfg.lora, self.bm,
                self.store.kv_bytes_per_block() * kv_div, device=self.device)
            # one step can never reference more adapters than the device
            # table holds resident — or than the pool-page cap can rent at
            # once (a step's working set is protected from eviction, so an
            # over-cap plan would walk the pressure ladder destructively
            # and still fail) — clamp the scheduler's grouping cap to both
            cap = self.cfg.lora.max_loaded_adapters
            if self.cfg.lora.pool_pages:
                cap = min(cap, self.cfg.lora.pool_pages
                          // self.adapters.pages_per_adapter)
            per_batch = self.scheduler.cfg.max_adapters_per_batch or cap
            self.scheduler.cfg = dataclasses.replace(
                self.scheduler.cfg, max_adapters_per_batch=min(per_batch, cap))
        # speculative decoding layers on the paged backend: "auto" turns it
        # on when a SpeculativeConfig is given, "speculative" without one
        # means self-speculation
        self.spec_runner: Optional[SpeculativeRunner] = None
        self.spec_stats = SpeculativeStats()
        self.spec_cfg = self.cfg.speculative
        self._spec_active = False
        self._spec_window: Deque[Tuple[int, int]] = deque()
        if backend == "speculative" and self.spec_cfg is None:
            self.spec_cfg = SpeculativeConfig()
        if self.spec_cfg is not None and self.paged_runner is not None and \
                backend in ("auto", "speculative"):
            draft_model, draft_params = model, params
            if self.spec_cfg.draft_model is not None:
                draft_model = self.spec_cfg.draft_model
                draft_params = self.spec_cfg.draft_params
            self.spec_runner = SpeculativeRunner(
                self.paged_runner, draft_model, draft_params,
                self.spec_cfg.num_draft_tokens)
            self._spec_active = True
            self.scheduler.cfg = dataclasses.replace(
                self.scheduler.cfg,
                speculative_tokens=self.spec_cfg.num_draft_tokens)
        self.prefix_cache = PrefixCache(self.bm,
                                        host_capacity_blocks=self.cfg.host_cache_blocks) \
            if self.cfg.enable_prefix_cache else None
        self.seqs: Dict[str, SeqState] = {}
        self.finished: List[RequestMetrics] = []
        self._gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.host_transfer_bytes = 0
        self.steps = 0
        self._step_inflight: Optional[set] = None
        self._step_adapters: Optional[set] = None
        # observability: the registry always exists; the tracer is the real
        # thing only when configured — otherwise the shared NULL_TRACER makes
        # every span site a no-op
        tcfg = self.cfg.telemetry
        self.trace = StepTracer(tcfg.trace_capacity) \
            if tcfg is not None and tcfg.trace else NULL_TRACER
        for part in (self.runner, self.paged_runner, self.spec_runner, self.adapters):
            if part is not None:
                part.trace = self.trace
        self.metrics = MetricsRegistry()
        self._dispatch_counters = {
            name: self.metrics.counter(f"engine.dispatch.{name}")
            for name in ("gathered", "paged", "speculative")}
        if self.paged_runner is not None:
            # the sharded runner reports under its own name
            self._dispatch_counters.setdefault(
                self.paged_runner.name,
                self.metrics.counter(f"engine.dispatch.{self.paged_runner.name}"))
        self._preempt_counter = self.metrics.counter("engine.preemptions")
        self._bound_cache: Dict[Tuple[int, int], float] = {}
        self.last_import_bytes = 0
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Back the registry with the subsystems' own stats objects — gauges
        read them live at snapshot time."""
        reg, bm = self.metrics, self.bm
        reg.gauge("engine.steps", lambda: self.steps)
        reg.gauge("engine.host_copy_bytes", lambda: self.store.host_copy_bytes)
        reg.gauge("store.pack_transfer_bytes", lambda: self.store.pack_transfer_bytes)
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
        g = self.runner
        if g is not None:
            reg.gauge("runner.gathered.steps", lambda: g.steps)
            reg.gauge("runner.gathered.prefill_steps", lambda: g.prefill_steps)
        if self.paged_runner is not None:
            r = self.paged_runner
            reg.gauge("runner.paged.steps", lambda: r.steps)
            reg.gauge("runner.paged.mirror_upload_bytes",
                      lambda: r.mirror_upload_bytes)
            reg.gauge("runner.paged.writeback_bytes", lambda: r.writeback_bytes)
            reg.gauge("runner.paged.tail_upload_bytes", lambda: r.tail_upload_bytes)
        if self.adapters is not None:
            a = self.adapters
            reg.gauge("lora.hits", lambda: a.stats.hits)
            reg.gauge("lora.misses", lambda: a.stats.misses)
            reg.gauge("lora.evictions", lambda: a.stats.evictions)
            reg.gauge("lora.loads", lambda: a.stats.loads)
            reg.gauge("lora.load_bytes", lambda: a.stats.load_bytes)
            reg.gauge("lora.rented_pages", lambda: a.rented_pages)
        if self.spec_runner is not None:
            st, sr = self.spec_stats, self.spec_runner
            reg.gauge("spec.steps", lambda: st.steps)
            reg.gauge("spec.proposed", lambda: st.proposed)
            reg.gauge("spec.accepted", lambda: st.accepted)
            reg.gauge("spec.emitted", lambda: st.emitted)
            reg.gauge("spec.acceptance_rate", lambda: st.acceptance_rate)
            reg.gauge("spec.tokens_per_step", lambda: st.tokens_per_step)
            reg.gauge("runner.spec.draft_catchup_tokens",
                      lambda: sr.draft_catchup_tokens)
            reg.gauge("runner.spec.draft_resets", lambda: sr.draft_resets)

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
        return self.paged_runner.steps if self.paged_runner is not None else 0

    # ------------------------------------------------------------------
    def register_adapter(self, adapter_id: str, weights) -> None:
        """Make a LoRA adapter servable (host-side registry; the paged store
        faults it onto the device on first use). ``weights``: the stage tree
        ``core.lora.make_adapter`` produces."""
        if self.adapters is None:
            raise ValueError("EngineConfig.lora is not configured")
        self.adapters.registry.register(adapter_id, weights)

    def add_request(self, req: Request) -> SeqState:
        if req.adapter_id is not None and self.adapters is None:
            # refuse rather than silently serve the tenant base weights
            raise ValueError(
                f"request {req.request_id!r} carries "
                f"adapter_id={req.adapter_id!r} but EngineConfig.lora is "
                "not configured on this engine")
        if req.extras:
            if self.sharded:
                raise ValueError(f"request {req.request_id!r}: modality extras run on "
                                 "the gathered backend, which is single-device; a "
                                 "sharded engine cannot serve them")
            self._check_extras(req)
        if req.arrival_time == 0.0:
            req.arrival_time = time.time()
        seq = SeqState(request=req)
        self.seqs[req.request_id] = seq
        self._prefix_lookup(seq)
        self.scheduler.add(seq)
        return seq

    def _check_extras(self, req: Request) -> None:
        """Refuse extras the model has no use for, or of another shape than
        the stubbed frontend's: ``audio_frames`` (n_audio_ctx, d_model) on an
        audio stack, ``vision_embeds`` (num_image_tokens, d_model) on a VLM;
        and images on a speculative engine, whose draft has no image
        splice."""
        cfg = self.model.cfg
        want = {"audio": ("audio_frames", cfg.n_audio_ctx),
                "vlm": ("vision_embeds", cfg.num_image_tokens)}.get(cfg.family)
        for k, v in req.extras.items():
            if want is None or (k, np.shape(v)) != (want[0], (want[1], cfg.d_model)):
                raise ValueError(
                    f"request {req.request_id!r}: extras {k!r} of shape {np.shape(v)} "
                    f"on {cfg.name} (family {cfg.family!r}), which takes "
                    + (f"{want[0]!r} of shape {(want[1], cfg.d_model)}" if want
                       else "none"))
        if "vision_embeds" in req.extras and self.spec_runner is not None:
            raise ValueError(f"request {req.request_id!r}: an image on a speculative "
                             "engine (its draft does not splice the image)")

    def _prefix_lookup(self, seq: SeqState) -> None:
        """Prefix-cache lookup at admission and again while the request
        waits in queue (a burst of same-prefix requests can hit blocks
        inserted by whichever of them prefilled first). None for a request
        with an image: its placeholder tokens do not name its pages."""
        req = seq.request
        if self.prefix_cache is not None and len(req.prompt) > self.cfg.block_size \
                and not seq.image_len:
            t0 = self.trace.now()
            # namespaced by adapter: a tenant's KV embeds its adapter's k/v
            # deltas, so identical token prefixes under different adapters
            # are NOT the same bytes and must never share blocks
            dev_blocks, host_hashes, matched = self.prefix_cache.lookup(
                req.prompt, namespace=req.adapter_id)
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
        """Grow seq's block table, and give a sequence of a state stack its
        state slot, reset to the empty history; on pressure, evict
        prefix-cache blocks then preempt running sequences — but never one
        in the current batch group (``protected``), whose pages this step
        will read."""
        while True:
            try:
                self.bm.ensure_capacity(seq.block_table, target_tokens)
                if seq.state_slot is None and self.store.state_leaves:
                    seq.state_slot = self.bm.allocate_state_slot()
                    self.store.reset_state(seq.state_slot)
                return
            except OutOfBlocks:
                if not self._relieve_pressure(protected or {seq.request_id}):
                    raise

    def _relieve_pressure(self, protected: set) -> bool:
        """One rung of the shared memory-pressure ladder (KV allocation and
        adapter fault-in walk the same ladder): evict prefix-cache blocks,
        else evict an idle LoRA adapter (never one the current step
        references), else preempt a sequence outside ``protected``.
        False = nothing left."""
        if self.prefix_cache is not None and self.prefix_cache.evict(
                4, demote_payload_fn=(self.store.block_payload
                                      if self.cfg.host_cache_blocks else None)):
            return True
        if self.adapters is not None and self.adapters.evict_one(
                self._step_adapters or set()):
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
        if self.spec_runner is not None:
            self.spec_runner.forget(seq.request_id)

    def _free_seq_memory(self, seq: SeqState) -> None:
        if seq.block_table:
            self.bm.free(seq.block_table)
            seq.block_table = []
        if seq.state_slot is not None:
            self.bm.free_state_slot(seq.state_slot)
            seq.state_slot = None

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
        ready, lora = self._ensure_lora(ready, inflight)
        if not ready:
            return
        tr = self.trace
        with tr.span("marshal"):
            batch = marshal_batch(ready, self.cfg.block_size,
                                  self.cfg.max_model_len)
            batch.lora = lora
        if not runner.supports(batch):
            runner = self.runner  # the gathered fallback (modality extras)
        self._dispatch_counters[runner.name].inc()
        if tr.enabled:
            with tr.span("dispatch", track="executor",
                         **self._dispatch_args(ready, runner)):
                logits_np = runner.execute(batch)
            self._chunk_spans(ready)
            with tr.span("postprocess"):
                self._postprocess(ready, logits_np)
        else:
            logits_np = runner.execute(batch)
            self._postprocess(ready, logits_np)

    def _ensure_lora(self, chunks: List[ChunkWork], inflight: set):
        """Fault the group's adapters into the paged store; returns the
        (possibly reduced) chunk list plus the per-row slot ids and device
        tables to attach to the marshalled batch. Loading rents pool pages,
        so it walks the shared memory-pressure ladder; if even that cannot
        rent the pages, adapter-bearing chunks self-preempt out of the
        group (youngest first, the recovery of a failed KV allocation)."""
        if self.adapters is None:
            return chunks, None
        while True:
            want = {c.seq.request.adapter_id for c in chunks
                    if c.seq.request.adapter_id is not None}
            try:
                self.adapters.ensure(want)
                break
            except OutOfBlocks:
                if self._relieve_pressure(inflight):
                    continue
                shed = [c for c in chunks if c.seq.request.adapter_id is not None]
                if not shed:
                    raise
                drop = max(shed, key=lambda c: c.seq.request.arrival_time)
                self._do_preempt(drop.seq)
                chunks = [c for c in chunks if c is not drop]
                if not chunks:
                    return [], None
        return chunks, self.adapters.marshal(
            [c.seq.request.adapter_id for c in chunks])

    def _dispatch_args(self, chunks: List[ChunkWork],
                       runner: ModelRunner) -> dict:
        """Span args for one dispatch (tracing-on path only). Decode
        dispatches on the paged backends carry the analytic
        ``decode_step_bound`` tokens/s so ``tools/trace_summary.py`` can
        report the live-vs-roofline fraction; sharded runners annotate their
        mesh shape."""
        ntok = sum(c.length for c in chunks)
        phase = "decode" if ntok == len(chunks) else "prefill"
        args = {"backend": runner.name, "batch": len(chunks), "tokens": ntok,
                "phase": phase}
        mesh = getattr(runner, "mesh", None)
        if mesh is not None:
            args["mesh"] = "x".join(f"{ax}={n}" for ax, n in mesh.shape.items())
            args["kv_sharded"] = bool(runner.kv_sharded)
        if phase == "decode" and runner is not self.runner:
            seq_len = max(c.start + c.length for c in chunks)
            bound = self._decode_bound(len(chunks), seq_len)
            if bound is not None:
                args["bound_tokens_per_s"] = bound
        return args

    def _decode_bound(self, batch: int, seq_len: int) -> Optional[float]:
        """Cached analytic roofline (``launch/roofline.py``) of one paged
        decode step on this engine's card — the data-sheet row of the CUDA
        device's name (an unknown card raises), the SXM H100's on the CPU.
        seq_len buckets to the next power of two so the cache stays small
        over a run. The import is lazy: the launch layer loads only when
        tracing asks for the bound."""
        tcfg = self.cfg.telemetry
        if tcfg is None or not tcfg.roofline:
            return None
        bucket = max(16, 1 << (max(seq_len, 2) - 1).bit_length())
        key = (batch, bucket)
        if key not in self._bound_cache:
            from repro_torch.launch.roofline import H100_SXM, card_for, decode_step_bound
            name = torch.cuda.get_device_name(self.device) \
                if self.device.type == "cuda" else H100_SXM
            sh, r = self.cfg.sharding, self.paged_runner
            out = decode_step_bound(self.model.cfg, batch=batch, seq_len=bucket,
                                    model_shards=sh.model_axis if sh is not None else 1,
                                    kv_sharded=bool(getattr(r, "kv_sharded", True)),
                                    ff_sharded=bool(getattr(r, "ff_sharded", False)),
                                    card=card_for(name))
            self._bound_cache[key] = float(out["tokens_per_s"])
        return self._bound_cache[key]

    def _chunk_spans(self, chunks: List[ChunkWork]) -> None:
        """Synthesize per-chunk prefill/decode spans under the dispatch
        just recorded (one track per batch row, seq/adapter ids in args)."""
        tcfg = self.cfg.telemetry
        if tcfg is None or not tcfg.chunk_spans or not self.trace.events:
            return
        ev = self.trace.events[-1]  # the dispatch span just appended
        for b, ch in enumerate(chunks):
            self.trace.record(
                "decode" if ch.length == 1 else "prefill",
                f"batch.row{b}", ev.ts, ev.dur, seq=ch.seq.request_id,
                start=ch.start, len=ch.length,
                adapter=ch.seq.request.adapter_id)

    def _postprocess(self, chunks: List[ChunkWork], logits_np: np.ndarray) -> None:
        """Sampling, prefix-cache publication, accounting, stop conditions."""
        bs = self.cfg.block_size
        now = time.time()
        for b, ch in enumerate(chunks):
            seq = ch.seq
            seq.num_computed = max(seq.num_computed, ch.start + ch.length)
            end = ch.start + ch.length
            # publish completed full prompt blocks immediately so concurrent
            # same-prefix requests can reuse them (vLLM-style eager insert);
            # none of a request with an image
            if self.prefix_cache is not None and seq.num_computed >= bs \
                    and not seq.image_len:
                prompt_computed = min(seq.num_computed, seq.prompt_len)
                nfull = prompt_computed // bs
                self.prefix_cache.insert(seq.request.prompt[: nfull * bs],
                                         seq.block_table[:nfull],
                                         namespace=seq.request.adapter_id)
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

    # ------------------------------------------------------------------
    # speculative decoding (survey §II.B)
    # ------------------------------------------------------------------
    def _run_spec_group(self, chunks: List[ChunkWork], k: int) -> None:
        """Draft k, verify k + 1, rejection-sample, emit 1..k+1 tokens per
        sequence. ``k`` is the plan's ``spec_tokens``: what the scheduler
        charged the token budget for."""
        if k < 1:
            self._run_group(chunks, self.paged_runner)
            return
        inflight = self._step_inflight or {c.seq.request_id for c in chunks}
        # verify writes positions [start, start + k], which must stay inside
        # the table and the model window: sequences at the edge peel off to
        # plain paged decode, and k stays the same for the rest
        lim = self.cfg.max_model_len - 2 - k
        edge = [c for c in chunks if c.start > lim]
        chunks = [c for c in chunks if c.start <= lim]
        if edge:
            self._run_group(edge, self.paged_runner)
        ready: List[ChunkWork] = []
        for ch in chunks:
            if ch.seq.status is not SeqStatus.RUNNING:
                continue
            try:
                self._alloc_for(ch.seq, ch.start + 1 + k, protected=inflight)
                # the whole speculative range is written: CoW all of it
                self._handle_cow(ch.seq, dataclasses.replace(ch, length=1 + k))
                ready.append(ch)
            except OutOfBlocks:
                self._do_preempt(ch.seq)
        # one draft / rejection pass per (temperature, top_k)
        groups: Dict[tuple, List[ChunkWork]] = {}
        for ch in ready:
            sp = ch.seq.request.sampling
            groups.setdefault((sp.temperature, sp.top_k), []).append(ch)
        tr = self.trace
        for (temp, topk), group in groups.items():
            sp = SamplingParams(temperature=temp, top_k=topk)
            group, lora = self._ensure_lora(group, inflight)
            if not group:
                continue
            with tr.span("marshal"):
                batch = marshal_batch(group, self.cfg.block_size,
                                      self.cfg.max_model_len)
                batch.lora = lora
            self._dispatch_counters["speculative"].inc()
            if tr.enabled:
                args = self._dispatch_args(group, self.spec_runner)
                args["k"] = k
                # a spec step emits up to k + 1 tokens per row; the per-token
                # decode bound would misread, so the summary gets acceptance
                # events instead of a roofline fraction for these spans
                args.pop("bound_tokens_per_s", None)
                with tr.span("dispatch", track="executor", **args):
                    d_toks, d_logits, t_logits = self.spec_runner.execute_spec(
                        batch, k, sp, self._gen)
                self._chunk_spans(group)
            else:
                d_toks, d_logits, t_logits = self.spec_runner.execute_spec(
                    batch, k, sp, self._gen)
            # the logits stay on the device; only (B, k+1) tokens come back
            tokens, n_acc = rejection_sample(self._gen, d_toks, d_logits,
                                             t_logits, sp)
            tokens, n_acc = tokens.cpu().numpy(), n_acc.cpu().numpy()
            now = time.time()
            with tr.span("postprocess"):
                for b, ch in enumerate(group):
                    self._emit_spec(ch, tokens[b], int(n_acc[b]), k, now)
            accepted = int(n_acc.sum())
            self.spec_stats.steps += 1
            self.spec_stats.proposed += k * len(group)
            self.spec_stats.accepted += accepted
            if tr.enabled:
                tr.event("spec_accept", batch=len(group), k=k,
                         proposed=k * len(group), accepted=accepted)
            if self.spec_cfg.min_acceptance > 0:  # else the window never drains
                self._spec_window.append((k * len(group), accepted))
        self.spec_runner.clear_pending()
        self._maybe_disable_spec()

    def _emit_spec(self, ch: ChunkWork, row: np.ndarray, n_acc: int, k: int,
                   now: float) -> None:
        """Append one sequence's accepted run through ``_append_token`` (a
        stop inside the run truncates it), commit its KIVI writes, then
        roll back the speculative tail."""
        seq = ch.seq
        emitted = 0
        stop = False
        for tok in row[: n_acc + 1]:
            self.vtc.charge(seq.request.user_id, output_tokens=1)
            stop = self._append_token(seq, int(tok), now)
            emitted += 1
            if stop:
                break
        # positions [start, start + emitted) now hold real tokens' KV;
        # everything past them is dead (masked by length, rewritten later)
        seq.num_computed = ch.start + emitted
        self.spec_stats.emitted += emitted
        # KIVI stores: stage exactly the emitted tokens now that acceptance
        # is known (no-op on fp stores), before rollback and finish so the
        # prefix cache publishes complete pages
        self.spec_runner.commit_writes(seq.request_id, emitted)
        if stop:
            self._finish(seq, now)
            return
        # free the blocks past what the accepted tokens (and the next step's
        # input) need
        keep = self.bm.blocks_needed(seq.total_len)
        if len(seq.block_table) > keep:
            self.bm.free(seq.block_table[keep:])
            del seq.block_table[keep:]
        self.spec_runner.commit(seq, ch.start, k, n_acc)

    def _maybe_disable_spec(self) -> None:
        """Turn speculation off for good once the rolling window's
        acceptance rate falls below ``min_acceptance``; the scheduler's
        budget goes back to 1 token per decode."""
        spec = self.spec_cfg
        if not self._spec_active or spec.min_acceptance <= 0:
            return
        wp = sum(p for p, _ in self._spec_window)
        while self._spec_window and wp - self._spec_window[0][0] >= spec.window:
            wp -= self._spec_window.popleft()[0]
        if wp < spec.window:
            return
        wa = sum(a for _, a in self._spec_window)
        if wa / wp < spec.min_acceptance:
            self._spec_active = False
            self.spec_stats.disabled_at_step = self.steps
            self.scheduler.cfg = dataclasses.replace(self.scheduler.cfg,
                                                     speculative_tokens=0)

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
        if self.prefix_cache is not None and not seq.image_len:
            self.prefix_cache.insert(seq.all_tokens, seq.block_table,
                                     namespace=seq.request.adapter_id)
        self.scheduler.finish(seq)
        self._free_seq_memory(seq)
        if self.spec_runner is not None:
            self.spec_runner.forget(seq.request_id)
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
        self._step_adapters = {c.seq.request.adapter_id for c in plan.chunks
                               if c.seq.request.adapter_id is not None}
        try:
            runner = self.paged_runner or self.runner
            rest = plan.chunks
            if self._spec_active and plan.decode:
                # speculative decode for the decode chunks; prompt chunks
                # take the paged path below
                self._run_spec_group(plan.decode, plan.spec_tokens)
                rest = plan.prefill
            # chunks carrying modality extras run gathered as a group of
            # their own on both paths: fused with others they would lose
            # their extras (marshal_batch raises)
            carry = [chunk_carries_extras(c) for c in rest]
            parts = [([c for c, f in zip(rest, carry) if f], self.runner),
                     ([c for c, f in zip(rest, carry) if not f], runner)]
            if self.scheduler.cfg.exact_chunks:
                # exact-chunk scheduling: one dispatch per chunk length, in
                # ascending order, extras groups first
                for part, part_runner in parts:
                    by_len: Dict[int, List[ChunkWork]] = {}
                    for c in part:
                        by_len.setdefault(c.length, []).append(c)
                    for _, group in sorted(by_len.items()):
                        self._run_group(group, part_runner)
            else:
                # the rest of the ragged plan — decodes AND prompt chunks —
                # fuses into ONE dispatch: paged when the backend exists
                # (decode_paged when all lengths are 1, extend_paged
                # otherwise), gathered otherwise
                for part, part_runner in parts:
                    if part:
                        self._run_group(part, part_runner)
        finally:
            self._step_inflight = None
            self._step_adapters = None
        return plan.num_tokens

    def run(self, max_steps: int = 10_000) -> List[RequestMetrics]:
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                break
            self.step()
        return self.finished

    # ------------------------------------------------------------------
    # KV migration (disaggregated prefill/decode, survey §IV.B; also the
    # Llumnix live-migration primitive from §V.A)
    # ------------------------------------------------------------------
    def export_seq(self, request_id: str) -> dict:
        """Extract a sequence's tokens, pages and state slot (``"state"``:
        the slot's leaves, or None without one) and release it locally.
        ``"blocks"`` are the model's global pages, every KV head in the
        model's order, whatever this engine's layout: a rank of a sharded
        engine gathers its blocks' pages over its model group in one
        all-gather, which every rank makes at once (they export the same
        sequence in lockstep)."""
        seq = self.seqs[request_id]
        pages = [self.store.block_payload(b) for b in seq.block_table]
        if self.kv_group is not None and pages:
            pages = self.store.gather_payloads(pages, self.kv_group, self.device)
        del self.seqs[request_id]
        if self.spec_runner is not None:
            self.spec_runner.forget(request_id)
        payload = {
            "request": seq.request,
            "generated": list(seq.generated),
            "num_computed": seq.num_computed,
            "prefix_hit_tokens": seq.prefix_hit_tokens,
            "first_token_time": seq.first_token_time,
            "token_times": list(seq.token_times),
            "blocks": pages,
            "state": (self.store.state_payload(seq.state_slot)
                      if seq.state_slot is not None else None),
        }
        if seq in self.scheduler.running:
            self.scheduler.running.remove(seq)
        self._free_seq_memory(seq)
        if self.trace.enabled:
            self.trace.event("migrate_out", seq=request_id,
                             blocks=len(payload["blocks"]))
        return payload

    def _local_page(self, rid: str, page: list) -> list:
        """A migrated block's pages as this store holds them: as they come
        when they hold the store's KV heads, this rank's contiguous cut of
        them when they hold the whole model's (``kv_group``); raises
        otherwise."""
        local = [s.shape[0] for s in self.store.stores]
        entries = [e for e in page if not isinstance(e, bool)]
        if len(entries) != len(local):
            raise ValueError(f"migrated request {rid!r} carries pages of {len(entries)} "
                             f"leaves for a store of {len(local)}")
        got = [page_tensors([e])[0].shape[0] for e in entries]
        if got == local:
            return page
        div = self.kv_group.size if self.kv_group is not None else 1
        if got == [n * div for n in local]:
            i = self.kv_group.index
            return map_page(page, lambda t: t.narrow(0, i * t.shape[0] // div,
                                                     t.shape[0] // div))
        raise ValueError(
            f"migrated request {rid!r} carries pages of {got[0]} KV heads: neither the "
            f"model's {local[0] * div} nor the {local[0]} this engine's store holds")

    def import_seq(self, payload: dict) -> SeqState:
        """Admit a migrated sequence; the bytes it carried (pages and state)
        are left in ``last_import_bytes``: a payload's global pages count
        whole, as the reference counts them, and a rank of a sharded engine
        restores its cut of them. Restored blocks are dirty, so the paged
        runner's device mirror uploads them at its next sync. A state
        payload lands in a fresh slot as it was exported (no reset)."""
        req = payload["request"]
        if req.adapter_id is not None and self.adapters is None:
            raise ValueError(
                f"migrated request {req.request_id!r} is bound to adapter "
                f"{req.adapter_id!r} but this engine has no EngineConfig.lora")
        carries, holds = payload["state"] is not None, bool(self.store.state_leaves)
        if carries != holds:
            raise ValueError(
                f"migrated request {req.request_id!r} "
                f"{'carries' if carries else 'has no'} state slot but this "
                f"engine's model ({self.model.cfg.name}) "
                f"{'has' if holds else 'has no'} state leaves")
        seq = SeqState(request=req, status=SeqStatus.RUNNING,
                       generated=list(payload["generated"]),
                       num_computed=payload["num_computed"],
                       prefix_hit_tokens=payload["prefix_hit_tokens"],
                       first_token_time=payload["first_token_time"],
                       token_times=list(payload["token_times"]))
        pages = [self._local_page(req.request_id, page) for page in payload["blocks"]]
        nbytes = sum(page_bytes(page) for page in payload["blocks"])
        blocks = self.bm.allocate(len(pages))
        for b, page in zip(blocks, pages):
            self.store.restore_block(b, page)
        seq.block_table = blocks
        if payload["state"] is not None:
            seq.state_slot = self.bm.allocate_state_slot()
            nbytes += self.store.restore_state(seq.state_slot, payload["state"])
        self.seqs[req.request_id] = seq
        self.scheduler.running.append(seq)
        self.last_import_bytes = nbytes
        if self.trace.enabled:
            self.trace.event("migrate_in", seq=req.request_id,
                             bytes=nbytes, blocks=len(blocks))
        return seq
