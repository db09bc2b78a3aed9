"""S-LoRA-style paged adapter store: adapter weights rent KV pool pages.

The port of ``repro.core.lora.store``. The store owns device tables on the
engine's device, one pair per (layer, site): ``a`` (T, Din, rank) and ``b``
(T, rank, Dout), f32, with a fixed slot capacity ``T``, and an LRU cache of
which registry adapters occupy which slot. Slot 0 is the reserved null
adapter (zeros): requests without an adapter ride every ``bgmv`` call with
a delta of exactly 0.

Unified memory (the S-LoRA idea): loading an adapter RENTS pages from the
engine's ``BlockManager`` — ``ceil(adapter_bytes / kv_block_bytes)`` of
them — so adapter weights and KV cache trade off under one budget.
``BlockManager.used_blocks`` therefore counts resident adapters too, which
is what makes preemption pressure see them; evicting an adapter frees real
KV capacity. The rented ids are never entered in any sequence's block
table: they are an accounting charge, the bytes live in the tables above.

Faulting is demand-driven: the engine calls ``ensure`` with the step's
adapter set before each batch; misses load from the registry (the scale
``alpha / rank`` folded into B at upload), evicting LRU adapters the
current step does not protect. ``stats`` counts hits / misses / evictions
/ load bytes for the serving report.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.block_manager import BlockManager, OutOfBlocks
from repro_torch.core.lora.config import LoRAConfig
from repro_torch.core.lora.registry import (AdapterRegistry, adapter_nbytes,
                                            lora_layer_sites)
from repro_torch.core.telemetry import NULL_TRACER
from repro_torch.models.convert import convert_adapter


@dataclasses.dataclass
class AdapterStoreStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    loads: int = 0
    load_bytes: int = 0


class PagedAdapterStore:
    def __init__(self, model_cfg, lora: LoRAConfig, bm: BlockManager,
                 kv_block_bytes: int,
                 registry: Optional[AdapterRegistry] = None, *,
                 device="cuda"):
        self.cfg = model_cfg
        self.lora = lora
        self.bm = bm
        self.registry = registry or AdapterRegistry(model_cfg, lora)
        self.nbytes_per_adapter = adapter_nbytes(model_cfg, lora)
        self.pages_per_adapter = max(
            1, -(-self.nbytes_per_adapter // max(1, kv_block_bytes)))
        if lora.pool_pages and lora.pool_pages < self.pages_per_adapter:
            # fail at construction, not mid-serving: a cap below one
            # adapter's rent can never be satisfied by any eviction
            raise ValueError(
                f"LoRAConfig.pool_pages={lora.pool_pages} cannot hold even "
                f"one adapter ({self.pages_per_adapter} pages at rank "
                f"{lora.rank})")
        # JAX pads the capacity to a power of two to keep one jit shape;
        # eager PyTorch has no compile cache to bound, so the tables hold
        # exactly the usable slots plus the null slot 0
        self.capacity = lora.max_loaded_adapters + 1
        self.stats = AdapterStoreStats()
        self.trace = NULL_TRACER  # the engine swaps in its live tracer
        self._slot_of: Dict[str, int] = {}
        self._pages_of: Dict[str, List[int]] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._free_slots: List[int] = list(range(lora.max_loaded_adapters, 0, -1))
        r = lora.rank
        self.tables = [
            {name: {"a": torch.zeros((self.capacity, din, r), dtype=torch.float32,
                                     device=device),
                    "b": torch.zeros((self.capacity, r, dout), dtype=torch.float32,
                                     device=device)}
             for name, din, dout in lora_layer_sites(model_cfg, spec)}
            for spec in model_cfg.layer_specs()]

    # ------------------------------------------------------------------
    @property
    def loaded(self) -> List[str]:
        return list(self._lru)

    @property
    def rented_pages(self) -> int:
        return self.pages_per_adapter * len(self._slot_of)

    def is_loaded(self, adapter_id: str) -> bool:
        return adapter_id in self._slot_of

    def slot(self, adapter_id: Optional[str]) -> int:
        """Table slot for a (possibly absent) adapter; None -> null slot 0."""
        return 0 if adapter_id is None else self._slot_of[adapter_id]

    # ------------------------------------------------------------------
    def ensure(self, adapter_ids: Iterable[str],
               protected: Iterable[str] = ()) -> None:
        """Fault the given adapters in; LRU-evict unprotected residents on
        slot or page pressure. The requested set is implicitly protected —
        one step's adapters can never evict each other. Raises
        ``OutOfBlocks`` when the pool cannot fit the set even after
        evicting everything evictable (the engine responds with its
        pressure ladder: prefix-cache eviction, then preemption)."""
        want = list(dict.fromkeys(adapter_ids))
        keep = set(want) | set(protected)
        for aid in want:
            if aid in self._slot_of:
                self.stats.hits += 1
                self._lru.move_to_end(aid)
            else:
                self.stats.misses += 1
                self._fault_in(aid, keep)

    def _fault_in(self, adapter_id: str, keep) -> None:
        t0 = self.trace.now()
        weights = self.registry.get(adapter_id)
        need = self.pages_per_adapter
        while not self._free_slots or (
                self.lora.pool_pages
                and self.rented_pages + need > self.lora.pool_pages):
            if not self.evict_one(keep):
                raise OutOfBlocks(
                    f"adapter store cannot fit {adapter_id!r}: "
                    f"{len(self._slot_of)} resident, all protected")
        while True:
            try:
                pages = self.bm.allocate(need)
                break
            except OutOfBlocks:
                if not self.evict_one(keep):
                    raise
        slot = self._free_slots.pop()
        self._upload(slot, weights)
        self._slot_of[adapter_id] = slot
        self._pages_of[adapter_id] = pages
        self._lru[adapter_id] = None
        self.stats.loads += 1
        self.stats.load_bytes += self.nbytes_per_adapter
        if self.trace.enabled:
            self.trace.record("lora_fault", "lora", t0,
                              self.trace.now() - t0, adapter=adapter_id,
                              bytes=self.nbytes_per_adapter, pages=need)

    def _upload(self, slot: int, weights) -> None:
        """Write one slot of every table in place. The scale folds into B
        here, in numpy f32 as in the JAX store, so the tables hold the same
        bytes as JAX's."""
        scale = self.lora.alpha / self.lora.rank
        for table, sites in zip(self.tables, convert_adapter(self.cfg, weights)):
            for name, w in sites.items():
                table[name]["a"][slot].copy_(torch.from_numpy(np.asarray(w["a"])))
                table[name]["b"][slot].copy_(torch.from_numpy(np.asarray(w["b"] * scale)))
        # a new list object on every fault-in, as the reference's store makes
        # a new table tuple: a holder of a copy derived from the tables (the
        # sharded runner's per-rank slices) tells by identity that it is stale
        self.tables = list(self.tables)

    def evict_one(self, protected: Iterable[str] = ()) -> bool:
        """Drop the least-recently-used unprotected adapter and return its
        rented pages to the block pool. The freed slot's table bytes are
        left as they are: ``marshal`` only emits resident slots (and the
        null slot 0), and ``_upload`` overwrites the whole slot before it
        is handed out again."""
        protected = set(protected)
        victim = next((aid for aid in self._lru if aid not in protected), None)
        if victim is None:
            return False
        slot = self._slot_of.pop(victim)
        self.bm.free(self._pages_of.pop(victim))
        del self._lru[victim]
        self._free_slots.append(slot)
        self.stats.evictions += 1
        if self.trace.enabled:
            self.trace.event("lora_evict", track="lora", adapter=victim,
                             pages=self.pages_per_adapter)
        return True

    # ------------------------------------------------------------------
    def marshal(self, adapter_ids: List[Optional[str]]) -> dict:
        """Per-row table slots + the device tables: the runners' lora
        operand. Every id must already be resident (``ensure`` ran)."""
        slots = np.asarray([self.slot(a) for a in adapter_ids], np.int32)
        return {"ids": slots, "layers": self.tables}
