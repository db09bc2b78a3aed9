"""Hash-chained prefix cache with an optional host tier.

Survey §III.A (Prompt Cache, AttentionStore) and §VI.A (RAGCache, CacheBlend):
full KV blocks are content-addressed by the hash chain
``h_i = H(h_{i-1}, tokens_in_block_i)`` so any request sharing a token prefix
reuses the cached blocks without recomputing their KV. Blocks with refcount 0
stay cached (LRU) until evicted for capacity; evicted blocks can be demoted to a
slower *host tier* (AttentionStore's HBM->DRAM offload) from which they are
restored on hit instead of recomputed — the engine accounts the transfer bytes.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.block_manager import BlockManager


def chain_hashes(tokens: List[int], block_size: int,
                 namespace=None) -> List[Tuple[int, Tuple[int, ...]]]:
    """Hash chain over *full* blocks only.

    ``namespace`` seeds the chain: KV is only content-addressable by token
    ids when the weights that produced it are identical, so requests bound
    to different LoRA adapters (whose k/v projections carry per-tenant
    deltas — docs/lora.md) hash into disjoint chains. None = base model,
    which keeps the seed at 0."""
    out = []
    h = 0 if namespace is None else hash(("ns", namespace))
    for i in range(0, len(tokens) // block_size * block_size, block_size):
        blk = tuple(tokens[i: i + block_size])
        h = hash((h, blk))
        out.append((h, blk))
    return out


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hit_blocks: int = 0
    host_hit_blocks: int = 0
    miss_blocks: int = 0
    inserted_blocks: int = 0
    evicted_blocks: int = 0
    demoted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hit_blocks + self.host_hit_blocks + self.miss_blocks
        return (self.hit_blocks + self.host_hit_blocks) / total if total else 0.0


class PrefixCache:
    """Maps chain-hash -> physical block id (device tier) or payload (host tier)."""

    def __init__(self, block_manager: BlockManager, *, host_capacity_blocks: int = 0):
        self.bm = block_manager
        self._device: "collections.OrderedDict[int, int]" = collections.OrderedDict()
        self._host: "collections.OrderedDict[int, object]" = collections.OrderedDict()
        self.host_capacity = host_capacity_blocks
        self.stats = PrefixCacheStats()

    # ------------------------------------------------------------------
    def lookup(self, tokens: List[int],
               namespace=None) -> Tuple[List[int], List[int], int]:
        """Longest cached prefix of ``tokens`` (within ``namespace`` — the
        request's LoRA adapter id, or None for the base model).

        Returns (device_block_ids_shared, host_hashes, matched_tokens). Device
        blocks come back with their refcount already incremented. ``host_hashes``
        are chain hashes whose payload must be restored via ``restore_host``.
        """
        self.stats.lookups += 1
        device_blocks: List[int] = []
        host_hashes: List[int] = []
        matched = 0
        for h, _blk in chain_hashes(tokens, self.bm.block_size, namespace):
            if host_hashes:  # once we fall to host tier, stay there
                if h in self._host:
                    self._host.move_to_end(h)
                    host_hashes.append(h)
                    matched += self.bm.block_size
                    self.stats.host_hit_blocks += 1
                    continue
                break
            if h in self._device:
                self._device.move_to_end(h)
                device_blocks.append(self.bm.share(self._device[h]))
                matched += self.bm.block_size
                self.stats.hit_blocks += 1
            elif h in self._host:
                self._host.move_to_end(h)
                host_hashes.append(h)
                matched += self.bm.block_size
                self.stats.host_hit_blocks += 1
            else:
                self.stats.miss_blocks += 1
                break
        return device_blocks, host_hashes, matched

    def host_payload(self, h: int):
        return self._host.get(h)

    # ------------------------------------------------------------------
    def insert(self, tokens: List[int], block_table: List[int],
               namespace=None) -> None:
        """Register a finished/prefilled sequence's full blocks for reuse."""
        for i, (h, _blk) in enumerate(chain_hashes(tokens, self.bm.block_size,
                                                   namespace)):
            if i >= len(block_table):
                break
            if h in self._device:
                continue
            self._device[h] = self.bm.share(block_table[i])
            self.stats.inserted_blocks += 1

    # ------------------------------------------------------------------
    def evict(self, n_blocks: int, *, demote_payload_fn=None) -> int:
        """Evict up to n least-recently-used cache-only blocks (refcount==1).

        ``demote_payload_fn(block_id) -> payload``: if given and host tier has
        capacity, the page payload is demoted to the host tier (AttentionStore).
        Returns number of device blocks actually evicted.
        """
        evicted = 0
        for h in list(self._device.keys()):
            if evicted >= n_blocks:
                break
            b = self._device[h]
            if self.bm.ref(b) != 1:
                continue  # shared with a live sequence; not evictable
            if demote_payload_fn is not None and self.host_capacity:
                while len(self._host) >= self.host_capacity:
                    self._host.popitem(last=False)
                self._host[h] = demote_payload_fn(b)
                self.stats.demoted_blocks += 1
            del self._device[h]
            self.bm.free([b])
            self.stats.evicted_blocks += 1
            evicted += 1
        return evicted

    def cached_device_blocks(self) -> int:
        return len(self._device)
