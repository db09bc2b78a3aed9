"""PagedRunner: decode AND chunked prefill straight on block-indexed page
stores (no gather) — the port of ``repro.core.executor.paged``, fp pages.

A pure-decode step passes block tables + lengths into
``model.decode_paged``, which runs the paged-attention op per layer (the
CUDA kernel on the card) against a device-resident mirror of the page
stores in kernel layout (KV, NB, P, D) and writes the new token's K/V into
it in place. Steps carrying prompt chunks — including mixed SplitFuse steps
— run ``model.extend_paged``: the ragged plan marshals into ONE (B, C)
batch (C pow2-padded), padded positions and padded rows write into the
engine-reserved ``scratch_block``. The only host traffic per step is the
O(tokens) K/V writeback that keeps the host store authoritative, and the
logits the engine samples from.

Mirror coherency: the mirror starts as zeros (like the host store); engine-
side page mutations (CoW copy, host-tier restore) bump ``store.version`` and
record dirty block ids; the next step re-uploads just those blocks with
``index_copy_`` (everything when most of the pool is dirty).

Quantized stores (``EngineConfig.kv_quant``) change two things. Mirror
leaves become {"codes", "scale", "zero"} uint8 + f16 triples in the same
layout, and the model does not write them: each step marshals every
sequence's still-filling page from the host staging store as a full-
precision TAIL (``call_pages``, counted in ``tail_upload_bytes``), the
quantized kernel attends packed pages + tail, and the writeback stages the
step's K/V on the host, where a page packs (and dirties the mirror) only
when its last slot fills.

Multi-tenant LoRA: the engine attaches the step's adapter operand to the
batch (``ExecBatch.lora``); both step kinds hand it to the model with the
per-row table slots as one int32 tensor on the device (``lora_arg``),
padding rows on the null slot 0.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.executor.base import ExecBatch, ModelRunner, lora_arg
from repro_torch.core.executor.state import PagedModelState, next_pow2
from repro_torch.core.telemetry import NULL_TRACER


class PagedRunner(ModelRunner):
    name = "paged"

    def __init__(self, model, params, engine_cfg, store: PagedModelState):
        self.model = model
        self.params = params
        self.cfg = engine_cfg
        self.store = store
        self.device = model.device
        self.leaves = store.attn_kv_leaves()
        # sacrificial page for ragged-chunk padding writes; the ENGINE
        # reserves it right after construction — never in a real table
        self.scratch_block: Optional[int] = None
        self._pages: Optional[List[dict]] = None
        self._synced_version = -1
        self._full_sync = False  # set when a failed step left the mirror suspect
        # the engine swaps in a live StepTracer to record device_sync spans
        self.trace = NULL_TRACER
        self.mirror_upload_bytes = 0
        self.writeback_bytes = 0
        # quantized stores only: the per-step fp tails (each sequence's
        # still-filling page plus C slots), host -> device
        self.tail_upload_bytes = 0
        self.steps = 0

    # ------------------------------------------------------------------
    def sync(self) -> None:
        """Bring the device mirror up to date with the host store."""
        if self._pages is not None and self._synced_version == self.store.version:
            return
        t0 = self.trace.now()
        b0 = self.mirror_upload_bytes
        dirty = sorted(self.store.dirty_blocks)
        if self._pages is None:
            # zeros equal a fresh host store; every mutation since is dirty
            self._pages = self.model.init_pages(self.cfg.num_blocks,
                                                self.cfg.block_size,
                                                quantized=self.store.quantized)
        full = self._full_sync or len(dirty) > self.cfg.num_blocks // 2
        if full:
            for src, dst in self._mirror_pairs():
                dst.copy_(src)
                self.mirror_upload_bytes += src.numel() * src.element_size()
        elif dirty:
            ids = torch.tensor(dirty, dtype=torch.long)
            ids_dev = ids.to(self.device)
            for src, dst in self._mirror_pairs():
                payload = src[:, ids]  # (KV, n, ...)
                dst.index_copy_(1, ids_dev, payload.to(self.device))
                self.mirror_upload_bytes += payload.numel() * payload.element_size()
        self.store.dirty_blocks.clear()
        self._full_sync = False
        self._synced_version = self.store.version
        if self.trace.enabled:
            self.trace.record("device_sync", "executor", t0,
                              self.trace.now() - t0, full=bool(full),
                              dirty_blocks=len(dirty),
                              upload_bytes=self.mirror_upload_bytes - b0)

    def _mirror_pairs(self):
        """(host tensor, mirror tensor) for every tensor the mirror holds:
        each fp page store, or a quantized leaf's codes and planes."""
        for layer, name, idx in self.leaves:
            dev = self._pages[layer][name]
            if idx in self.store.qplanes:
                yield self.store.stores[idx], dev["codes"]
                for pname, plane in self.store.qplanes[idx].items():
                    yield plane, dev[pname]
            else:
                yield self.store.stores[idx], dev

    # ------------------------------------------------------------------
    def call_pages(self, tables: np.ndarray, lengths: np.ndarray, C: int):
        """The pages argument of one quantized step: the mirror leaves plus
        a per-leaf fp TAIL (B, P + C, KV, D) — each sequence's still-filling
        page from the host staging store, then C empty slots the model fills
        with the step's own K/V. fp stores pass the mirror through."""
        if not self.store.quantized:
            return self._pages
        bs = self.cfg.block_size
        B = len(lengths)
        part = torch.from_numpy(np.take_along_axis(
            tables.astype(np.int64), (lengths.astype(np.int64) // bs)[:, None],
            axis=1)[:, 0])
        pages = [{name: dict(leaf) for name, leaf in pg.items()} for pg in self._pages]
        with self.trace.span("tail_upload", track="executor"):
            for layer, name, idx in self.leaves:
                # (KV, B, bs, D) -> (B, bs, KV, D)
                stage = self.store.qstage[idx][:, part].permute(1, 2, 0, 3)
                tail = torch.cat([stage, stage.new_zeros((B, C) + stage.shape[2:])],
                                 dim=1)
                self.tail_upload_bytes += tail.numel() * tail.element_size()
                pages[layer][name]["tail"] = tail.to(self.device)
        return pages

    def strip_tails(self, pages):
        """The mirror again from a step's pages: the per-step tails dropped,
        so sync's block-indexed updates only ever see (KV, NB, ...) leaves."""
        if not self.store.quantized:
            return pages
        return [{name: {k: v for k, v in leaf.items() if k != "tail"}
                 for name, leaf in pg.items()} for pg in pages]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def supports(self, batch: ExecBatch) -> bool:
        """Modality extras reach the model through ``extend`` only, on the
        gathered backend; everything else runs here."""
        return batch.extras is None

    def execute(self, batch: ExecBatch) -> np.ndarray:
        assert self.supports(batch)
        self.sync()
        lengths = batch.cache_lens  # chunk start == tokens already cached
        try:
            if all(c.length == 1 for c in batch.chunks):
                return self._execute_decode(batch, lengths)
            return self._execute_extend(batch, lengths)
        except Exception:
            # the model may have written part of the step into the mirror;
            # rebuild it from the authoritative host store next step
            self._full_sync = True
            self._synced_version = -1
            raise

    def _execute_decode(self, batch: ExecBatch, lengths: np.ndarray) -> np.ndarray:
        logits, pages, writes = self.model.decode_paged(
            self.params, self._dev(batch.tokens),
            self.call_pages(batch.tables, lengths, 1),
            self._dev(batch.tables), self._dev(lengths),
            lora=lora_arg(batch.lora, device=self.device))
        self._pages = self.strip_tails(pages)
        # O(token) writeback keeps the host store authoritative; the device
        # mirror already holds the same write (quantized stores instead
        # stage it on the host until the page fills)
        self.writeback_bytes += self.writeback_tokens(
            batch.tables, lengths, 1, writes, len(batch.chunks))
        self.steps += 1
        return logits.float().cpu().numpy()

    def _execute_extend(self, batch: ExecBatch, lengths: np.ndarray) -> np.ndarray:
        """Chunked prefill / mixed SplitFuse step on the page stores: ONE
        ``model.extend_paged`` call for the whole ragged plan. Both batch
        axes pad to pow2, ``chunk_lens`` gives each row's real length, and
        padded positions/rows write into the scratch page."""
        assert self.scratch_block is not None, \
            "engine must reserve a scratch block before paged prefill"
        B, Cmax = batch.tokens.shape
        C = next_pow2(Cmax)
        tokens = np.zeros((B, C), batch.tokens.dtype)
        tokens[:, :Cmax] = batch.tokens
        chunk_lens = np.asarray([c.length for c in batch.chunks], np.int32)
        # trim the table width to the batch's live pow2 maximum: attention
        # only reads pages below lengths + chunk
        bs = self.cfg.block_size
        nb = next_pow2(-(-int(np.max(lengths + chunk_lens)) // bs))
        tables = batch.tables[:, : min(nb, batch.tables.shape[1])]
        # pow2 batch rows: padding rows aim every table entry at the scratch
        # page and declare chunk_len 0, so ALL their writes land there
        Bp = next_pow2(B)
        if Bp > B:
            pad = Bp - B
            tokens = np.concatenate([tokens, np.zeros((pad, C), tokens.dtype)])
            tables = np.concatenate([tables, np.full(
                (pad, tables.shape[1]), self.scratch_block, tables.dtype)])
            lengths = np.concatenate([lengths, np.repeat(lengths[:1], pad)])
            chunk_lens = np.concatenate([chunk_lens, np.zeros(pad, np.int32)])
        logits, pages, writes = self.model.extend_paged(
            self.params, self._dev(tokens), self.call_pages(tables, lengths, C),
            self._dev(tables), self._dev(lengths), self._dev(chunk_lens),
            self.scratch_block,
            lora=lora_arg(batch.lora, pad_rows=Bp - B, device=self.device))
        self._pages = self.strip_tails(pages)
        self.writeback_bytes += self.writeback_tokens(
            batch.tables, batch.cache_lens, C, writes, B,
            chunk_lens=chunk_lens[:B])
        self.steps += 1
        return logits[:B, :Cmax].float().cpu().numpy()

    def verify(self, tokens: torch.Tensor, tables: np.ndarray,
               lengths: np.ndarray, lora: Optional[dict] = None):
        """The target's C-position forward that the speculative runner
        borrows: ``model.verify_paged`` over the mirror (plus per-step fp
        tails on quantized stores), every position real. ``tokens`` (B, C)
        on the device. Returns (logits (B, C, V) on the device, writes with
        (B, C, KV, D) leaves); the caller writes back what it keeps. A
        failed call leaves the mirror suspect: it is rebuilt from the host
        store next step."""
        C = tokens.shape[1]
        try:
            logits, pages, writes = self.model.verify_paged(
                self.params, tokens, self.call_pages(tables, lengths, C),
                self._dev(tables), self._dev(lengths),
                lora=lora_arg(lora, device=self.device))
        except Exception:
            self._full_sync = True
            self._synced_version = -1
            raise
        self._pages = self.strip_tails(pages)
        return logits, writes

    def writeback_tokens(self, tables: np.ndarray, lengths: np.ndarray,
                         C: int, writes, B: int,
                         chunk_lens: Optional[np.ndarray] = None) -> int:
        """O(tokens) host-store writeback of the per-token K/V returned by
        ``decode_paged`` (C == 1, leaves (B, KV, D)), ``verify_paged`` (leaves
        (B, C, KV, D)) or ``extend_paged`` (the same, ragged); shared by the
        paged and speculative backends. Rows past ``B`` and positions past a
        row's ``chunk_lens`` only ever lived in the scratch page and never
        reach the host store. All leaves cross to the host in one copy.
        Returns bytes written."""
        bs = self.cfg.block_size
        if chunk_lens is None:
            chunk_lens = np.full(B, C, np.int64)
        rows = [lengths[b].astype(np.int64) + np.arange(chunk_lens[b])
                for b in range(B)]
        pos = np.concatenate(rows)
        blk = np.concatenate([tables[b].astype(np.int64)[p // bs]
                              for b, p in enumerate(rows)])
        off = pos % bs
        real = np.arange(C)[None, :] < np.asarray(chunk_lens)[:, None]  # (B, C)
        # the span covers the copy to the host and, on quantized stores, the
        # staging writes and the packs of filled pages
        with self.trace.span("writeback", track="executor"):
            stacked = torch.stack([writes[layer][name] for layer, name, _ in self.leaves])
            stacked = stacked[:, :B].reshape((len(self.leaves), B, C) + stacked.shape[-2:])
            host = stacked[:, torch.from_numpy(real).to(stacked.device)].cpu()
            return self.store.write_token_group(
                [idx for _, _, idx in self.leaves], torch.from_numpy(blk),
                torch.from_numpy(off), list(host))
