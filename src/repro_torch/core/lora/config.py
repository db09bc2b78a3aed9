"""Multi-tenant LoRA serving configuration (a copy of ``repro.core.lora.config``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LoRAConfig:
    """Serve many fine-tuned adapters of ONE base model (S-LoRA / Punica /
    dLoRA line, survey §VI): base weights stay resident once, adapter
    deltas are paged like KV blocks, and requests for *different* adapters
    batch into a single step.

    ``rank``/``alpha``: the adapter shape; the effective scale
    ``alpha / rank`` is folded into the B table at load time so the hot
    path never multiplies by it.
    ``max_loaded_adapters``: device adapter-table capacity (resident
    adapters, plus the reserved null slot 0). Loading past it LRU-evicts.
    ``pool_pages``: cap on the KV-pool pages the adapter store may rent
    from the engine's ``BlockManager`` (0 = no cap beyond the pool itself).
    Adapter weights and KV cache trade off under ONE memory budget — a
    loaded adapter makes the engine measurably "fuller" for preemption
    pressure."""
    rank: int = 8
    alpha: float = 16.0
    max_loaded_adapters: int = 8
    pool_pages: int = 0
