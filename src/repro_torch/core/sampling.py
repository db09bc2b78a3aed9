"""Token sampling (greedy / temperature / top-k) on torch tensors.

The PyTorch twin of ``repro.core.sampling``. Randomness comes from an
explicit ``torch.Generator`` the caller owns (the engine seeds one from
``EngineConfig.seed``) on the logits' device; it draws other bits than
``jax.random`` for the same seed, so cross-framework parity is checked under
greedy sampling only.

Also home of the speculative-decoding rejection sampler (draft–verify,
survey §II.B): ``rejection_sample`` accepts a prefix of draft tokens and
resamples the first rejected position from the clipped residual
``max(p - q, 0)``, so every emitted token is exactly target-distributed
whatever the draft.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def sampling_probs(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """The distribution ``sample_token`` draws from: (..., V) f32 probs.
    Greedy is the one-hot argmax. The rejection sampler compares draft and
    target under the same temperature / top-k, or its output is no longer
    the target's distribution."""
    if params.temperature <= 0.0:
        return F.one_hot(torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    logits = _filter_top_k(logits.float() / params.temperature, params.top_k)
    return torch.softmax(logits, dim=-1)


def rejection_sample(generator: torch.Generator, draft_tokens: torch.Tensor,
                     draft_logits: torch.Tensor, target_logits: torch.Tensor,
                     params: SamplingParams):
    """Draft–verify rejection sampling, batched, on the logits' device.

    draft_tokens (B, k), drawn from ``sampling_probs(draft_logits)``;
    draft_logits (B, k, V); target_logits (B, k+1, V): position i scores
    the token proposed at i, position k is the bonus distribution.
    ``generator`` lives on the logits' device; greedy draws nothing from it.

    Returns (tokens (B, k+1) int64, num_accepted (B,) int64):
    ``tokens[b, :num_accepted[b] + 1]`` is the emitted run, the accepted
    prefix plus one token from the residual ``normalize(max(p - q, 0))`` at
    the first rejection, or from the bonus distribution when all k were
    accepted. Greedy reduces to "accept iff argmax matches, then emit the
    target argmax"."""
    B, k = draft_tokens.shape
    p = sampling_probs(target_logits, params)  # (B, k+1, V)
    q = sampling_probs(draft_logits, params)  # (B, k, V)
    dt = draft_tokens.long()[..., None]
    p_d = p[:, :k].gather(-1, dt)[..., 0]
    q_d = q.gather(-1, dt)[..., 0]
    ratio = torch.clamp(p_d / torch.clamp_min(q_d, 1e-30), max=1.0)
    if params.temperature <= 0.0:
        accept = ratio > 0.0  # the ratio is 0 or 1: u ~ U[0, 1) decides nothing
    else:
        accept = torch.rand((B, k), generator=generator,
                            device=p.device) < ratio
    # accepted prefix length: the leading run of True
    na = torch.cumprod(accept.long(), dim=-1).sum(dim=-1)
    # residual at each candidate rejection; p == q makes it identically
    # zero (then the ratio is 1 and every draft is accepted), guarded anyway
    resid = torch.clamp_min(p[:, :k] - q, 0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rsum > 0.0, resid / torch.clamp_min(rsum, 1e-30), p[:, :k])
    dists = torch.cat([resid, p[:, k:]], dim=1)  # (B, k+1, V)
    final_dist = dists.gather(1, na[:, None, None].expand(B, 1, p.shape[-1]))[:, 0]
    if params.temperature <= 0.0:
        final = torch.argmax(final_dist, dim=-1)
    else:
        final = torch.multinomial(final_dist, 1, generator=generator)[:, 0]
    idx = torch.arange(k + 1, device=p.device)[None, :]
    draft_pad = F.pad(draft_tokens.long(), (0, 1))
    tokens = torch.where(idx < na[:, None], draft_pad, final[:, None])
    return tokens, na
