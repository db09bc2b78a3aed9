"""Token sampling (greedy / temperature / top-k) on torch tensors.

The PyTorch twin of ``repro.core.sampling``. Randomness comes from an
explicit ``torch.Generator`` the caller owns (the engine seeds one from
``EngineConfig.seed``); it draws other bits than ``jax.random`` for the
same seed, so cross-framework parity is checked under greedy sampling only.
The speculative rejection sampler arrives with the speculative slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filter
    max_new_tokens: int = 64
    stop_token: Optional[int] = None


def _filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask everything strictly below the kth-largest logit; ties AT the kth
    value are all kept, and ``top_k >= vocab_size`` is a no-op (the same
    rule as the JAX sampler)."""
    V = logits.shape[-1]
    if top_k <= 0 or top_k >= V:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def sample_token(generator: torch.Generator, logits: torch.Tensor,
                 params: SamplingParams) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 token ids. ``generator`` must live on
    ``logits``' device."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_top_k(logits.float() / params.temperature, params.top_k)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def greedy_token_host(logits_row) -> int:
    """Host-side greedy pick for ONE row of host-resident logits (np.argmax
    and torch.argmax both break ties at the first maximum). The engine's
    per-token fast path; lives here so sampling policy stays in one module."""
    return int(np.argmax(logits_row))
