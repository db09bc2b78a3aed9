"""ModelRunner: the execution-backend interface of the serving engine.

A copy of ``repro.core.executor.base``. The engine owns *policy* — admission, scheduling, block allocation, CoW,
prefix caching, sampling, metrics. A runner owns *mechanism*: given a
batch of scheduled chunks whose blocks are already allocated, execute the
model and return per-chunk logits. The port has the reference's three
backends: ``PagedRunner``, ``GatheredRunner`` and the ``SpeculativeRunner``
layered on the paged one. Modality extras (audio frames, image
embeddings) reach the model on the gathered backend only
(``ModelRunner.supports``).
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
    sequence has none: stacks without state mixers). ``extras``: each
    extras key stacked over the rows, (B,) + the payload's shape, when
    every chunk carries extras (``chunk_carries_extras``), else None.
    ``lora`` is attached by the ENGINE after
    marshaling (it owns the adapter store): {"ids": (B,) adapter-table
    slots, "layers": device adapter tables} — see core/lora/store.py."""
    chunks: List[ChunkWork]
    tokens: np.ndarray
    cache_lens: np.ndarray
    tables: np.ndarray
    slots: np.ndarray
    extras: Optional[dict] = None
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


def chunk_carries_extras(ch: ChunkWork) -> bool:
    """Whether this chunk must deliver its request's modality extras to the
    model: a request's first chunk (audio frames: the encoder runs there
    and its cross K/V stay in the state slot), and every chunk that covers
    an image position (``start < seq.image_len``; the reference's engine
    delivers only the first chunk and knows no image positions). The one
    definition of the condition: it decides what ``marshal_batch``
    attaches and which chunks the engine runs gathered as their own
    groups."""
    return bool(ch.seq.request.extras) and (ch.start == 0 or ch.start < ch.seq.image_len)


def marshal_batch(chunks: List[ChunkWork], block_size: int,
                  max_model_len: int) -> ExecBatch:
    """Pack scheduled chunks into dense host arrays. A batch whose chunks
    all carry extras (``chunk_carries_extras``; one model's extras share
    their shape, ``LLMEngine._check_extras``) stacks them per key; a batch
    that mixes carrying and other chunks raises, where the reference drops
    the extras."""
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
    carry = [chunk_carries_extras(ch) for ch in chunks]
    extras = None
    if any(carry):
        if not all(carry):
            raise ValueError("a batch must carry modality extras in every chunk or "
                             "in none")
        extras = {k: np.stack([np.asarray(ch.seq.request.extras[k]) for ch in chunks])
                  for k in chunks[0].seq.request.extras}
    return ExecBatch(chunks=chunks, tokens=tokens, cache_lens=cache_lens,
                     tables=tables, slots=slots, extras=extras)


class ModelRunner(abc.ABC):
    """Executes one marshalled batch; returns logits (B, C, V) float32."""

    name: str = "base"

    @abc.abstractmethod
    def execute(self, batch: ExecBatch) -> np.ndarray:
        ...

    def supports(self, batch: ExecBatch) -> bool:
        """Whether this runner can execute the batch (checked at dispatch)."""
        return True
