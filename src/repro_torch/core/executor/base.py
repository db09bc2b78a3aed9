"""ModelRunner: the execution-backend interface of the serving engine.

A copy of ``repro.core.executor.base`` for the port's text-only paged
path. The engine owns *policy* — admission, scheduling, block allocation,
CoW, prefix caching, sampling, metrics. A runner owns *mechanism*: given a
batch of scheduled chunks whose blocks are already allocated, execute the
model and return per-chunk logits. The port has one backend so far,
``PagedRunner``; the gathered and speculative runners are queued in
ROADMAP.md.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import List

import numpy as np

from repro_torch.core.scheduler import ChunkWork


@dataclasses.dataclass
class ExecBatch:
    """Marshalled per-step batch shared by runners.

    tokens: (B, C) int32; cache_lens: (B,) tokens already cached per seq;
    tables: (B, nmax) block ids."""
    chunks: List[ChunkWork]
    tokens: np.ndarray
    cache_lens: np.ndarray
    tables: np.ndarray


def marshal_batch(chunks: List[ChunkWork], block_size: int,
                  max_model_len: int) -> ExecBatch:
    """Pack scheduled chunks into dense host arrays."""
    B = len(chunks)
    C = max(c.length for c in chunks)
    nmax = max_model_len // block_size
    tokens = np.zeros((B, C), np.int32)
    cache_lens = np.zeros((B,), np.int32)
    tables = np.zeros((B, nmax), np.int64)
    for b, ch in enumerate(chunks):
        seq = ch.seq
        toks = seq.all_tokens
        tokens[b, : ch.length] = toks[ch.start: ch.start + ch.length]
        cache_lens[b] = ch.start
        tb = seq.block_table[:nmax]
        tables[b, : len(tb)] = tb
    return ExecBatch(chunks=chunks, tokens=tokens, cache_lens=cache_lens,
                     tables=tables)


class ModelRunner(abc.ABC):
    """Executes one marshalled batch; returns logits (B, C, V) float32."""

    name: str = "base"

    @abc.abstractmethod
    def execute(self, batch: ExecBatch) -> np.ndarray:
        ...
