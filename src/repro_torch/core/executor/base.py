"""ModelRunner: the execution-backend interface of the serving engine.

A copy of ``repro.core.executor.base`` for the port's text-only paths.
The engine owns *policy* — admission, scheduling, block allocation, CoW,
prefix caching, sampling, metrics. A runner owns *mechanism*: given a
batch of scheduled chunks whose blocks are already allocated, execute the
model and return per-chunk logits. The port has the reference's three
backends: ``PagedRunner``, ``GatheredRunner`` and the ``SpeculativeRunner``
layered on the paged one.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.scheduler import ChunkWork


@dataclasses.dataclass
class ExecBatch:
    """Marshalled per-step batch shared by runners.

    tokens: (B, C) int32; cache_lens: (B,) tokens already cached per seq;
    tables: (B, nmax) block ids; slots: (B,) state slots (0 where a
    sequence has none: stacks without state mixers). ``lora`` is attached
    by the ENGINE after
    marshaling (it owns the adapter store): {"ids": (B,) adapter-table
    slots, "layers": device adapter tables} — see core/lora/store.py."""
    chunks: List[ChunkWork]
    tokens: np.ndarray
    cache_lens: np.ndarray
    tables: np.ndarray
    slots: np.ndarray
    lora: Optional[dict] = None


def lora_arg(batch_lora: Optional[dict], pad_rows: int = 0, *, device):
    """The model-facing lora operand of a marshalled batch's attachment:
    padding rows (pow2 batch bucketing) get the NULL adapter slot 0 — their
    logits are sliced off and their writes land in the scratch page — and
    the ids go to ``device`` as one int32 tensor."""
    if batch_lora is None:
        return None
    ids = batch_lora["ids"]
    if pad_rows:
        ids = np.concatenate([ids, np.zeros(pad_rows, ids.dtype)])
    return {"ids": torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(device),
            "layers": batch_lora["layers"]}


def marshal_batch(chunks: List[ChunkWork], block_size: int,
                  max_model_len: int) -> ExecBatch:
    """Pack scheduled chunks into dense host arrays."""
    B = len(chunks)
    C = max(c.length for c in chunks)
    nmax = max_model_len // block_size
    tokens = np.zeros((B, C), np.int32)
    cache_lens = np.zeros((B,), np.int32)
    tables = np.zeros((B, nmax), np.int64)
    slots = np.zeros((B,), np.int64)
    for b, ch in enumerate(chunks):
        seq = ch.seq
        toks = seq.all_tokens
        tokens[b, : ch.length] = toks[ch.start: ch.start + ch.length]
        cache_lens[b] = ch.start
        tb = seq.block_table[:nmax]
        tables[b, : len(tb)] = tb
        slots[b] = seq.state_slot if seq.state_slot is not None else 0
    return ExecBatch(chunks=chunks, tokens=tokens, cache_lens=cache_lens,
                     tables=tables, slots=slots)


class ModelRunner(abc.ABC):
    """Executes one marshalled batch; returns logits (B, C, V) float32."""

    name: str = "base"

    @abc.abstractmethod
    def execute(self, batch: ExecBatch) -> np.ndarray:
        ...
