"""SpeculativeRunner: draft–verify decode on paged KV (survey §II.B).

The port of ``repro.core.executor.speculative``. One speculative step per
decode group: a draft model proposes k tokens per sequence (k + 1
``decode_paged`` launches from Python, the last only writing the last
proposal's K/V), then the target scores all k + 1 positions in one
``model.verify_paged`` forward over its own page stores, borrowed from the
``PagedRunner`` (``PagedRunner.verify``: on CUDA bf16 / f16 the paged
kernel's native chunked path at ``rows_per_seq = k + 1``). The engine's
rejection sampler (``core.sampling.rejection_sample``) accepts a prefix and
emits one corrected or bonus token, so greedy speculative output equals
plain paged decoding for ANY draft (over KIVI pages up to the reference's
own divergence: a verify chunk reads the page it has just filled through
the fp tail, where plain decoding reads it packed).

State owned here:
  * the TARGET side is the paged runner's device mirror, sync and host
    writeback; verify writes k + 1 tokens per sequence instead of 1. On
    KIVI stores the verify K/V is held (``_pending_writes``) until the
    engine knows acceptance, and ``commit_writes`` stages only the emitted
    tokens, so a page fill packs only accepted tokens.
  * the DRAFT side is a device-only fp page store (same block ids and block
    size as the target: the engine's block tables index both) in the
    draft's activation dtype, even over KIVI target pages, plus a
    per-sequence ``draft_computed`` watermark. Draft KV is derived state: it
    is rebuilt by chunked ``verify_paged`` catch-up when a sequence is first
    seen, after preemption, or when the block-table prefix under the
    watermark changed (copy-on-write, re-allocation), detected by comparing
    a snapshot of the table.

Rollback: pages at positions >= ``num_computed`` are dead by construction
(every reader masks by length, every writer appends at ``num_computed``),
so rejected tokens need no erase. Rolling back is the engine freeing
over-allocated tail blocks and ``commit`` clamping the draft watermark.

Batches are not padded: the reference pads to a power of two only to bound
its jit cache, so no row here writes the scratch page.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor.base import ExecBatch, lora_arg
from repro_torch.core.executor.paged import PagedRunner
from repro_torch.core.sampling import SamplingParams, sample_token
from repro_torch.core.telemetry import NULL_TRACER


class SpeculativeRunner:
    name = "speculative"  # the engine's dispatch spans read it

    def __init__(self, paged: PagedRunner, draft_model, draft_params,
                 num_draft_tokens: int):
        self.paged = paged
        self.model = paged.model
        self.cfg = paged.cfg
        self.store = paged.store
        self.device = paged.device
        if num_draft_tokens < 1:
            raise ValueError("speculative decoding needs k >= 1 draft tokens")
        if draft_model.decode_paged is None:
            raise ValueError(
                f"draft {draft_model.cfg.name} has no paged decode path (needs "
                "a pure global-attention stack)")
        if draft_model.cfg.vocab_size != self.model.cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if draft_model.device != self.device:
            raise ValueError(f"draft on {draft_model.device}, target on {self.device}")
        self.draft_model = draft_model
        self.draft_params = draft_params
        # multi-tenant LoRA: the draft applies the target's adapter rows when
        # its config is the target's (self-speculation, same-arch drafts);
        # another draft runs base-only, and rejection sampling keeps the
        # output the target's either way
        self.draft_lora_ok = draft_model.cfg == self.model.cfg
        self._draft_pages = draft_model.init_pages(self.cfg.num_blocks,
                                                   self.cfg.block_size)
        # per-sequence draft-KV watermark and the block-table prefix it was
        # computed under (checked before reuse; a mismatch recomputes)
        self._draft_computed: Dict[str, int] = {}
        self._draft_tables: Dict[str, List[int]] = {}
        self._catchup_chunk = 32
        self.trace = NULL_TRACER  # the engine installs its tracer
        self.steps = 0
        self.draft_catchup_tokens = 0
        self.draft_catchup_calls = 0
        self.draft_resets = 0
        # KIVI stores: the verify K/V of the last step (host copy), the rows
        # by request id, and the table / length snapshot, until commit_writes
        self._pending_writes: Optional[Tuple] = None

    # ------------------------------------------------------------------
    def _reset_draft(self) -> None:
        """Drop every draft watermark (a draft call failed part-way, so any
        page it touched is suspect): all draft KV is rebuilt by catch-up."""
        self._draft_computed.clear()
        self._draft_tables.clear()
        self.draft_resets += 1

    def forget(self, request_id: str) -> None:
        """Engine hook: the sequence finished or was preempted."""
        self._draft_computed.pop(request_id, None)
        self._draft_tables.pop(request_id, None)

    # ------------------------------------------------------------------
    def _sync_draft(self, seq, tables_row: np.ndarray, lora=None) -> None:
        """Bring the draft KV of ``seq`` up to ``seq.num_computed`` positions
        with B=1 ``verify_paged`` chunks of power-of-two lengths up to
        ``_catchup_chunk``. In steady state this does nothing: the propose
        loop advances the watermark."""
        rid = seq.request_id
        bs = self.cfg.block_size
        upto = seq.num_computed
        dc = self._draft_computed.get(rid, 0)
        if dc:
            # the block-table prefix changed under the watermark (CoW wrote a
            # shared block, preemption re-allocated): draft KV from the first
            # diverged block on is stale, everything before it still stands
            snap, table = self._draft_tables.get(rid, []), seq.block_table
            diverged = next((i for i in range(-(-dc // bs))
                             if i >= len(snap) or i >= len(table)
                             or snap[i] != table[i]), None)
            if diverged is not None:
                dc = diverged * bs
                self.draft_resets += 1
        if dc < upto:
            toks = seq.all_tokens
            table = self.paged._dev(tables_row[None])
            while dc < upto:
                c = 1
                while c * 2 <= min(upto - dc, self._catchup_chunk):
                    c *= 2
                chunk = self.paged._dev(np.asarray(toks[dc: dc + c], np.int64)[None])
                try:
                    self.draft_model.verify_paged(
                        self.draft_params, chunk, self._draft_pages, table,
                        self.paged._dev(np.asarray([dc], np.int32)), lora=lora)
                except Exception:
                    self._reset_draft()
                    raise
                self.draft_catchup_tokens += c
                self.draft_catchup_calls += 1
                dc += c
        self._draft_computed[rid] = dc
        self._draft_tables[rid] = list(seq.block_table)

    def _propose(self, tok0, tables, lengths, k: int, sp: SamplingParams,
                 generator, lora):
        """k + 1 draft ``decode_paged`` steps: k proposals, then one step
        that only writes the last proposal's K/V (without it the all-
        accepted steady state would be one draft position short and pay a
        catch-up call per sequence every step). Returns (tokens (B, k),
        logits (B, k, V)), both on the device."""
        dm, dp = self.draft_model, self.draft_params
        x = tok0  # (B, 1): the step's input token, at position lengths
        toks, qlogits = [], []
        for j in range(k + 1):
            logits, _, _ = dm.decode_paged(dp, x, self._draft_pages, tables,
                                           lengths + j, lora=lora)
            if j == k:
                break  # the K/V of proposal k is written; its logits unused
            lg = logits[:, -1]
            qlogits.append(lg)
            if sp.temperature <= 0.0:
                nxt = torch.argmax(lg, dim=-1)
            else:
                nxt = sample_token(generator, lg, sp)
            toks.append(nxt)
            x = nxt[:, None]
        return torch.stack(toks, 1), torch.stack(qlogits, 1)

    # ------------------------------------------------------------------
    def execute_spec(self, batch: ExecBatch, k: int, sp: SamplingParams,
                     generator: torch.Generator):
        """Draft k tokens and verify k + 1 positions on the target, one step.

        Returns (draft_tokens (B, k), draft_logits (B, k, V), target_logits
        (B, k + 1, V)), all on the device: the engine's rejection sampler
        reads them there, and only its tokens come to the host. The engine
        then calls ``commit_writes`` (KIVI stores) and ``commit`` for each
        sequence once acceptance is known."""
        tr = self.trace
        self.paged.sync()
        lengths = batch.cache_lens.astype(np.int32)
        draft_lora = batch.lora if self.draft_lora_ok else None
        t0, c0 = tr.now(), self.draft_catchup_tokens
        for b, ch in enumerate(batch.chunks):
            row = None
            if draft_lora is not None:
                row = lora_arg({"ids": draft_lora["ids"][b: b + 1],
                                "layers": draft_lora["layers"]}, device=self.device)
            self._sync_draft(ch.seq, batch.tables[b], lora=row)
        if tr.enabled and self.draft_catchup_tokens > c0:
            tr.record("draft_catchup", "executor", t0, tr.now() - t0,
                      tokens=self.draft_catchup_tokens - c0)
        B = len(batch.chunks)
        tables = self.paged._dev(batch.tables)
        lens = self.paged._dev(lengths)
        tok0 = self.paged._dev(batch.tokens.astype(np.int64))  # (B, 1)
        t0 = tr.now()
        try:
            d_toks, d_logits = self._propose(
                tok0, tables, lens, k, sp, generator,
                lora_arg(draft_lora, device=self.device))
        except Exception:
            self._reset_draft()
            raise
        if tr.enabled:
            tr.record("spec_propose", "executor", t0, tr.now() - t0, batch=B, k=k)
        t0 = tr.now()
        t_logits, writes = self.paged.verify(torch.cat([tok0, d_toks], dim=1),
                                             batch.tables, lengths, batch.lora)
        if tr.enabled:
            tr.record("spec_verify", "executor", t0, tr.now() - t0, batch=B,
                      positions=k + 1)
        if self.store.quantized:
            # writeback deferred to commit_writes: only emitted tokens may
            # join a page's quantization groups. One copy of every leaf.
            stacked = torch.stack([writes[layer][name]
                                   for layer, name, _ in self.paged.leaves]).cpu()
            self._pending_writes = (
                stacked, {ch.seq.request_id: b for b, ch in enumerate(batch.chunks)},
                batch.tables.copy(), batch.cache_lens.astype(np.int64))
        else:
            self.paged.writeback_bytes += self.paged.writeback_tokens(
                batch.tables, batch.cache_lens, k + 1, writes, B)
        self.steps += 1
        return d_toks, d_logits, t_logits

    # ------------------------------------------------------------------
    def commit_writes(self, request_id: str, emitted: int) -> None:
        """KIVI stores: stage the ACCEPTED run of one sequence on the host.

        Verify computed K/V for the fed tokens at positions [start, start +
        k]; the first ``emitted`` became real tokens (the corrected or bonus
        token's K/V is the next step's write). They go to the fp staging
        store, and a page they fill packs here. Had a rejected token been
        written too, a page could pack with garbage in its group statistics,
        which plain paged decoding never produces. No-op on fp stores (they
        wrote back inside ``execute_spec``). The engine calls this before
        rollback and finish, so the prefix cache publishes complete pages."""
        if not self.store.quantized or self._pending_writes is None or emitted <= 0:
            return
        stacked, rows, tables, lens = self._pending_writes
        b = rows.get(request_id)
        if b is None:
            return
        bs = self.cfg.block_size
        pos = lens[b] + np.arange(emitted)
        blk = torch.from_numpy(tables[b].astype(np.int64)[pos // bs])
        off = torch.from_numpy(pos % bs)
        self.paged.writeback_bytes += self.store.write_token_group(
            [idx for _, _, idx in self.paged.leaves], blk, off,
            list(stacked[:, b, :emitted]))

    def clear_pending(self) -> None:
        """Release the held verify K/V once a step's emits are committed."""
        self._pending_writes = None

    def commit(self, seq, start: int, k: int, accepted: int) -> None:
        """Draft rollback for one sequence after acceptance. Propose wrote
        draft KV at [start, start + k] for the fed tokens [t_start, d_1, ...,
        d_k]; position start + j holds a real token's KV iff draft j was
        accepted, so the watermark clamps to the accepted prefix (all
        accepted: the next step proposes with no catch-up). The table
        snapshot is taken after the engine's tail-block rollback."""
        rid = seq.request_id
        self._draft_computed[rid] = start + 1 + min(accepted, k)
        self._draft_tables[rid] = list(seq.block_table)
