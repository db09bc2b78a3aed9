"""Host-authoritative page stores backing the serving engine (fp pages).

The fp subset of ``repro.core.executor.state``. ``PagedModelState`` owns
one CPU tensor per (layer, k/v) in the cache dtype (numpy has no bfloat16)
and in the paged-attention kernel's layout (KV, NB, P, D), so a device
mirror syncs blocks with one ``index_copy_`` per leaf and no transpose.
Shapes come from the model config.

The paged path reads pages on the device through block tables and writes
each chunk's own K/V back here (O(tokens), ``write_token_group``), which
keeps this store authoritative for copy-on-write, prefix-cache payloads and
host-tier restores. Engine-side mutations (CoW copies, restores) bump
``version`` and record the block ids in ``dirty_blocks`` so the runner's
device mirror re-syncs just those blocks. ``host_copy_bytes`` counts
gather/scatter window staging, which only a gathered backend does: the
paged path keeps it at 0.
"""
from __future__ import annotations

from typing import List, Set, Tuple

import torch

from repro_torch.models.model import DTYPES


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — the bucketing rule for ragged extend
    batches and marshalled table widths."""
    p = 1
    while p < n:
        p *= 2
    return p


class PagedModelState:
    """Per-layer K/V page stores, host side."""

    def __init__(self, model_cfg, engine_cfg):
        self.cfg = engine_cfg
        self.dtype = DTYPES[model_cfg.dtype]
        shape = (model_cfg.num_kv_heads, engine_cfg.num_blocks,
                 engine_cfg.block_size, model_cfg.head_dim)
        self._leaves: List[Tuple[int, str, int]] = []
        self.stores: List[torch.Tensor] = []
        for layer in range(model_cfg.num_layers):
            for name in ("k", "v"):
                self._leaves.append((layer, name, len(self.stores)))
                self.stores.append(torch.zeros(shape, dtype=self.dtype))
        self.host_copy_bytes = 0
        self.version = 0
        self.dirty_blocks: Set[int] = set()

    def _touch(self, blocks) -> None:
        self.version += 1
        self.dirty_blocks.update(int(b) for b in blocks)

    def attn_kv_leaves(self) -> List[Tuple[int, str, int]]:
        """(layer, "k"/"v", leaf index) for every page store."""
        return list(self._leaves)

    def write_token_group(self, leaf_idxs: List[int], blocks: torch.Tensor,
                          offsets: torch.Tensor,
                          payloads: List[torch.Tensor]) -> int:
        """Paged-path writeback: token values ``payloads[j]`` (n, KV, D)
        into store ``leaf_idxs[j]`` at (blocks, offsets), both (n,). Does
        NOT dirty the mirror — the device mirror already holds the same
        write (applied in place by the model). Returns bytes written."""
        nbytes = 0
        for idx, payload in zip(leaf_idxs, payloads):
            self.stores[idx][:, blocks, offsets] = payload.transpose(0, 1)
            nbytes += payload.numel() * payload.element_size()
        return nbytes

    def copy_block(self, src: int, dst: int) -> None:
        for store in self.stores:
            store[:, dst] = store[:, src]
        self._touch([dst])

    def block_payload(self, block: int) -> List[torch.Tensor]:
        """One block's pages across layers (host-tier demotion)."""
        return [store[:, block].clone() for store in self.stores]

    def restore_block(self, block: int, payload: List[torch.Tensor]) -> int:
        nbytes = 0
        for store, page in zip(self.stores, payload):
            store[:, block] = page
            nbytes += page.numel() * page.element_size()
        self._touch([block])
        return nbytes

    def kv_bytes_per_block(self) -> int:
        """Bytes one block occupies across layers."""
        return sum(s[:, 0].numel() * s.element_size() for s in self.stores)
