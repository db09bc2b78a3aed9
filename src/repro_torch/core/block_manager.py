"""Paged KV block manager (PagedAttention, survey §III.A) + SSM state slots.

Physical KV memory is a pool of fixed-size blocks (``block_size`` tokens).
Sequences own lists of block ids; blocks are reference-counted so full blocks
can be shared (prefix cache, fork for parallel sampling) with copy-on-write on
the writable tail. Recurrent mixers (Mamba/xLSTM) have no KV — they get
fixed-size *state slots* from a separate slab, which is the paged-memory idea
degenerated to page-count == 1 per sequence (DESIGN §4).

This object is pure host-side accounting: it never touches device memory. The
physical pages live in the engine's ``PagedModelState`` (host) and the paged
runner's device mirror; the CUDA paged-attention kernel consumes the same
block tables (kernels/paged_attention).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class OutOfBlocks(Exception):
    pass


@dataclasses.dataclass
class BlockManagerStats:
    allocated_blocks: int = 0
    freed_blocks: int = 0
    cow_copies: int = 0
    peak_used: int = 0


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, num_state_slots: int = 0):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._free_slots: List[int] = list(range(num_state_slots - 1, -1, -1))
        self.stats = BlockManagerStats()

    # ------------------------------------------------------------------ blocks
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.stats.allocated_blocks += n
        self.stats.peak_used = max(self.stats.peak_used, self.used_blocks)
        return out

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def share(self, block: int) -> int:
        """Increment refcount (prefix-cache hit / fork)."""
        assert self._ref.get(block, 0) > 0, f"block {block} not live"
        self._ref[block] += 1
        return block

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            r = self._ref.get(b, 0)
            assert r > 0, f"double free of block {b}"
            if r == 1:
                del self._ref[b]
                self._free.append(b)
                self.stats.freed_blocks += 1
            else:
                self._ref[b] = r - 1

    def copy_on_write(self, block: int) -> Optional[int]:
        """If ``block`` is shared, allocate a private copy target and drop one ref.

        Returns the new block id (caller must copy page contents), or None if the
        block was already exclusively owned.
        """
        if self._ref.get(block, 0) <= 1:
            return None
        new = self.allocate(1)[0]
        self._ref[block] -= 1
        self.stats.cow_copies += 1
        return new

    def ensure_capacity(self, table: List[int], num_tokens: int) -> List[int]:
        """Grow ``table`` (in place) to cover num_tokens; returns newly added ids."""
        need = self.blocks_needed(num_tokens) - len(table)
        if need <= 0:
            return []
        new = self.allocate(need)
        table.extend(new)
        return new

    # --------------------------------------------------------------- state slots
    @property
    def free_state_slots(self) -> int:
        return len(self._free_slots)

    def allocate_state_slot(self) -> int:
        if not self._free_slots:
            raise OutOfBlocks("no free state slots")
        return self._free_slots.pop()

    def free_state_slot(self, slot: int) -> None:
        self._free_slots.append(slot)

    # --------------------------------------------------------------- utilization
    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def waste_last_block(self, table: List[int], num_tokens: int) -> int:
        """Internal fragmentation: unused token slots in the final block."""
        if not table:
            return 0
        return len(table) * self.block_size - num_tokens
