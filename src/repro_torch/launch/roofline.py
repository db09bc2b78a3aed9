"""Analytic decode-step roofline on an NVIDIA card (the port's twin of
``repro.launch.roofline``'s parameter counts and ``decode_step_bound``).

The reference's hardware model is a TPU's; here the card is a parameter:
a row of ``CARDS``, NVIDIA's data-sheet rates by card name. The bound of
one paged decode step is the reference's formula over that row:

    compute    = 2 * N_active * batch / mp / bf16 tensor-core rate
    memory     = (param_bytes / mp + kv_bytes / kv_div) / HBM bandwidth
    collective = psum payload / link bandwidth

The engine annotates every paged decode dispatch span with the implied
tokens/s (``LLMEngine._decode_bound``), and ``tools/trace_summary.py``
reports live tokens/s against it. ``model_flops``, ``analyze`` and the
report read XLA dry-run artifacts and have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import is_glu


class Card(NamedTuple):
    """One card's data-sheet rates: HBM bytes/s, fp32 FLOP/s outside the
    tensor cores, dense bf16 tensor-core FLOP/s, and the link bytes/s the
    collective term divides by (None where no figure is recorded)."""
    name: str
    hbm_bw: float
    fp32_flops: float
    bf16_flops: float
    link_bw: Optional[float] = None


# NVIDIA data sheets, dense rates without sparsity; a device name matches
# the first row whose name it contains, so the SXM H100 ("NVIDIA H100
# 80GB HBM3") comes after the PCIe and NVL parts. Its link figure is NVLink
# 4's 900 GB/s per GPU (H100 Tensor Core GPU data sheet, SXM form factor).
CARDS = (Card("H100 PCIe", 2.0e12, 51e12, 756e12),
         Card("H100 NVL", 3.9e12, 60e12, 835e12),
         Card("H200", 4.8e12, 67e12, 989e12),
         Card("H100", 3.35e12, 67e12, 989e12, 900e9))

H100_SXM = "NVIDIA H100 80GB HBM3"


def card_for(device_name: str) -> Card:
    """The row of ``CARDS`` for a device name as
    ``torch.cuda.get_device_name`` gives it; raises for an unknown card."""
    for card in CARDS:
        if card.name in device_name:
            return card
    raise ValueError(f"no data-sheet rates for {device_name!r}")


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------

def _mixer_params(cfg: ModelConfig, mixer: str) -> float:
    d = cfg.d_model
    if mixer == "attn":
        return d * cfg.num_heads * cfg.head_dim + 2 * d * cfg.kv_dim + \
            cfg.num_heads * cfg.head_dim * d
    if mixer == "mla":
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            n = d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * qk
        else:
            n = d * cfg.num_heads * qk
        n += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        n += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        return n + cfg.num_heads * cfg.v_head_dim * d
    if mixer == "mamba":
        di = cfg.ssm_expand * d
        dr = max(1, math.ceil(d / 16))
        N = cfg.ssm_d_state
        # in_proj, conv, x_proj, dt_proj, A_log, D, out_proj (biases uncounted)
        return d * 2 * di + cfg.ssm_d_conv * di + di * (dr + 2 * N) + dr * di + \
            di * N + di + di * d
    if mixer == "mlstm":
        di = int(cfg.mlstm_proj_factor * d)
        return d * 2 * di + 4 * di + 3 * di * di + di * 2 * cfg.num_heads + di * d
    if mixer == "slstm":
        dh = d // cfg.num_heads
        df = int(cfg.slstm_proj_factor * d)
        return d * 4 * d + cfg.num_heads * dh * 4 * dh + d * 2 * df + df * d
    raise ValueError(f"no parameter count for mixer {mixer!r}")


def _ff_params(cfg: ModelConfig, ff: str, active: bool) -> float:
    d = cfg.d_model
    glu = 2 if is_glu(cfg.activation) else 1
    if ff == "none":  # xLSTM blocks: no separate feed-forward
        return 0
    if ff == "mlp":
        return d * cfg.d_ff * glu + cfg.d_ff * d
    if ff == "moe":
        expert = d * cfg.moe_d_ff * glu + cfg.moe_d_ff * d
        n = d * cfg.num_experts  # router
        n += (cfg.top_k if active else cfg.num_experts) * expert
        n += cfg.num_shared_experts * expert
        return n
    raise ValueError(f"no parameter count for feed-forward {ff!r}")


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    total = active = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
        active += cfg.d_model * cfg.vocab_size
    for spec in cfg.layer_specs():
        m = _mixer_params(cfg, spec.mixer)
        total += m + _ff_params(cfg, spec.ff, active=False)
        active += m + _ff_params(cfg, spec.ff, active=True)
    # the learned position table and, for whisper, the bidirectional
    # encoder's attention + MLP layers and each decoder layer's
    # cross-attention (q, k, v, o at the decoder's heads); the reference's
    # count has the encoder only
    extra = cfg.learned_positions * cfg.d_model
    if cfg.encoder_layers:
        extra += cfg.encoder_layers * (_mixer_params(cfg, "attn") +
                                       _ff_params(cfg, "mlp", False))
        extra += cfg.num_layers * _mixer_params(cfg, "attn")
    total += extra
    active += extra
    return {"total": total, "active": active}


# ---------------------------------------------------------------------------
# analytic decode-step bound
# ---------------------------------------------------------------------------

def decode_step_bound(cfg: ModelConfig, *, batch: int, seq_len: int,
                      model_shards: int = 1, kv_sharded: bool = True,
                      ff_sharded: bool = False, dtype_bytes: int = 2,
                      kv_dtype_bytes: int = 2,
                      card: Card = card_for(H100_SXM)) -> Dict[str, float]:
    """Roofline bound for ONE (tensor-parallel) paged decode step on
    ``card``.

    The per-device terms (mp = ``model_shards``):

      compute    = 2 * N_active * batch / mp / card.bf16_flops
      memory     = (param_bytes / mp + kv_bytes / kv_div) / card.hbm_bw
                   (kv_div = mp when the KV heads shard, 1 when they are
                   replicated)
      collective = psum payload / card.link_bw, with one all-reduce per
                   layer after the attention output projection plus one
                   per MLP layer when the hidden axis is sharded; a ring
                   all-reduce moves 2*(mp-1)/mp * batch * d_model *
                   dtype_bytes per device.

    Returns the three terms, their combination ``t_step_s``
    (max(compute, memory) + collective) and the implied ``tokens_per_s``
    upper bound."""
    mp = max(1, model_shards)
    n = param_counts(cfg)["active"]
    flops = 2.0 * n * batch / mp  # the head matmul included
    t_compute = flops / card.bf16_flops
    param_bytes = n * dtype_bytes / mp
    n_attn = sum(1 for s in cfg.layer_specs() if s.mixer == "attn")
    kv_div = mp if kv_sharded else 1
    kv_bytes = (2 * n_attn * cfg.kv_dim * seq_len * batch *
                kv_dtype_bytes) / kv_div
    t_memory = (param_bytes + kv_bytes) / card.hbm_bw
    t_coll = 0.0
    if mp > 1:
        if card.link_bw is None:
            raise ValueError(f"no link bandwidth recorded for {card.name}")
        payload = 2.0 * (mp - 1) / mp * batch * cfg.d_model * dtype_bytes
        n_psum = n_attn + (sum(1 for s in cfg.layer_specs() if s.ff == "mlp")
                           if ff_sharded else 0)
        t_coll = n_psum * payload / card.link_bw
    t_step = max(t_compute, t_memory) + t_coll
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "t_step_s": t_step,
            "tokens_per_s": batch / t_step if t_step else float("inf")}
