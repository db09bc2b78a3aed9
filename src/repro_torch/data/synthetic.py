"""Deterministic synthetic LM data pipeline.

Sequences mix (i) Zipf-distributed unigrams, (ii) copied spans (induction heads
have signal to learn), and (iii) fixed "system prompt" prefixes shared across a
fraction of sequences — the latter gives the prefix-cache benchmark a realistic
hit distribution (survey §III.A Prompt Cache / §VI.A RAG reuse).

Everything is generated from a seeded ``numpy.random.Generator``; the pipeline
is fully reproducible and cheap enough to never bottleneck a training step.
A copy of ``repro.data.synthetic`` (numpy only): the same seed gives
byte-equal batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    copy_frac: float = 0.5  # fraction of sequence that is copied spans
    zipf_a: float = 1.3
    shared_prefix_len: int = 0  # >0: first tokens shared across prefix_groups
    prefix_groups: int = 4

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        self._prefixes = self._rng.integers(2, v, size=(max(self.prefix_groups, 1),
                                                        max(self.shared_prefix_len, 1)))

    def sample_tokens(self, n: int) -> np.ndarray:
        z = self._rng.zipf(self.zipf_a, size=n).astype(np.int64)
        return np.minimum(z, self.vocab_size - 1)

    def sequence(self, length: Optional[int] = None) -> np.ndarray:
        S = self.seq_len if length is None else length
        out = np.empty(S, np.int64)
        pos = 0
        if self.shared_prefix_len:
            g = int(self._rng.integers(0, self.prefix_groups))
            L = min(self.shared_prefix_len, S)
            out[:L] = self._prefixes[g][:L]
            pos = L
        while pos < S:
            if self._rng.random() < self.copy_frac and pos > 8:
                span = int(self._rng.integers(4, min(32, pos)))
                start = int(self._rng.integers(0, pos - span + 1))
                take = min(span, S - pos)
                out[pos: pos + take] = out[start: start + take]
                pos += take
            else:
                take = min(int(self._rng.integers(4, 64)), S - pos)
                out[pos: pos + take] = self.sample_tokens(take)
                pos += take
        return out

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        toks = np.stack([self.sequence(self.seq_len + 1) for _ in range(batch_size)])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def make_batches(dataset: SyntheticLM, batch_size: int, steps: int,
                 extras: Optional[dict] = None) -> Iterator[Dict[str, np.ndarray]]:
    """extras: static arrays merged into every batch (e.g. stubbed vision embeds)."""
    for _ in range(steps):
        b = dataset.batch(batch_size)
        # +1 consumed by the label shift, so regenerate at seq_len+1
        if extras:
            b.update(extras)
        yield b
