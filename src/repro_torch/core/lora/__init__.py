"""Multi-tenant LoRA serving (S-LoRA / Punica line, survey §VI), the port of
``repro.core.lora``.

One base model, many fine-tuned tenants: the registry holds adapter
weights host-side, the paged store rents KV-pool pages to keep a bounded
LRU working set resident in fixed-capacity device tables, and the
``kernels/lora`` batched grouped matmul applies per-row adapter deltas so
one engine step serves a heterogeneous-adapter batch.
"""
from repro_torch.core.lora.config import LoRAConfig  # noqa: F401
from repro_torch.core.lora.registry import (AdapterRegistry, adapter_nbytes,  # noqa: F401
                                            lora_layer_sites, make_adapter,
                                            merge_adapter)
from repro_torch.core.lora.store import AdapterStoreStats, PagedAdapterStore  # noqa: F401
