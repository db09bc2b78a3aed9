"""Architecture config registry of the PyTorch port.

A copy of ``repro.configs`` restricted to the architectures the port serves
today: attention and multi-head latent attention (MLA) stacks with a dense
MLP or a routed MoE feed-forward, and the state mixers (Mamba, mLSTM,
sLSTM), and the modality families: whisper-base (an encoder-decoder with
cross-attention and learned positions) and internvl2-2b (a global GQA
decoder that takes image embeddings ahead of its text). olmo-1b, gemma-2b,
qwen2.5-32b and internvl2-2b (global attention, dense MLP) run on the
paged path (internvl2-2b's chunks that carry the image on the gathered
one); starcoder2-3b (sliding-window attention),
llama4-scout-17b-a16e (blocks of three chunked-attention layers and one
global NoPE layer, every feed-forward 16 routed experts at top-1 plus a
shared expert), deepseek-v3-671b (MLA, 3 dense then 58 MoE layers of 256
routed experts at top-8 plus a shared expert), jamba-v0.1-52b (blocks of 7
Mamba layers and one GQA attention layer, every other feed-forward 16
experts at top-2) and xlstm-1.3b (blocks of 7 mLSTM and one sLSTM layer,
no separate feed-forward) and whisper-base run on the gathered backend
only.
``get_config("<arch-id>")`` returns the exact published config;
``smoke_config("<arch-id>")`` the reduced variant the CPU tests use (2
layers, d_model <= 256, f32).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig, dense_stages  # noqa: F401

from repro_torch.configs import (deepseek_v3_671b, gemma_2b,  # noqa: E402
                                internvl2_2b, jamba_v0_1_52b, llama4_scout_17b_a16e,
                                olmo_1b, qwen2_5_32b, starcoder2_3b, whisper_base,
                                xlstm_1_3b)

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (qwen2_5_32b, gemma_2b, olmo_1b, starcoder2_3b,
                      llama4_scout_17b_a16e, deepseek_v3_671b, jamba_v0_1_52b,
                      xlstm_1_3b, whisper_base, internvl2_2b)}

ARCHS = tuple(sorted(REGISTRY))


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {list(REGISTRY)}")
    return REGISTRY[name]


def _smoke_stages(cfg: ModelConfig) -> tuple:
    """Reduce to 2 layers while preserving the family's layer diversity.

    We pick 2 *distinct* specs from the flattened stack when available (e.g. a
    mamba and an attn layer for Jamba; an mLSTM and an sLSTM for xLSTM; a dense
    and an MoE layer for DeepSeek) so smoke tests exercise every mixer type.
    """
    flat = cfg.layer_specs()
    first = flat[0]
    second = None
    # prefer a different mixer (covers jamba's attn layer, xlstm's sLSTM) ...
    for s in flat[1:]:
        if s.mixer != first.mixer:
            second = s
            break
    # ... else any spec differing in ff/attn_kind (deepseek dense->moe, llama4 chunked->global)
    if second is None:
        for s in flat[1:]:
            if (s.ff, s.attn_kind) != (first.ff, first.attn_kind):
                second = s
                break
    if second is None:
        second = first
    # if the arch has MoE but neither picked layer is MoE, force one (jamba: mamba+attn
    # would otherwise drop MoE coverage) -- swap `first` for its moe twin if present.
    if cfg.num_experts and first.ff != "moe" and second.ff != "moe":
        for s in flat:
            if s.ff == "moe" and s.mixer == first.mixer:
                first = s
                break
    return (((first, second), 1),)


def smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    d_model = min(cfg.d_model, 256)
    num_heads = min(cfg.num_heads, 4)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    # keep GQA ratio flavor: MQA stays MQA, MHA stays MHA
    if cfg.num_kv_heads == 1:
        num_kv = 1
    elif cfg.num_kv_heads == cfg.num_heads:
        num_kv = num_heads
    else:
        num_kv = max(1, num_heads // 2)
    head_dim = 64 if cfg.head_dim >= 64 else cfg.head_dim
    changes = dict(
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        stages=_smoke_stages(cfg),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        chunk_size=min(cfg.chunk_size, 16) if cfg.chunk_size else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else 0,
        q_lora_rank=min(cfg.q_lora_rank, 64) if cfg.q_lora_rank else 0,
        kv_lora_rank=min(cfg.kv_lora_rank, 32) if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=32 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=16 if cfg.qk_rope_head_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        n_audio_ctx=min(cfg.n_audio_ctx, 32) if cfg.n_audio_ctx else 0,
        num_image_tokens=min(cfg.num_image_tokens, 8) if cfg.num_image_tokens else 0,
        learned_positions=min(cfg.learned_positions, 128) if cfg.learned_positions else 0,
        mtp_depth=cfg.mtp_depth,
        dtype="float32",
        param_dtype="float32",
        name=cfg.name + "-smoke",
    )
    if cfg.use_mla:
        changes["head_dim"] = changes["qk_nope_head_dim"] + changes["qk_rope_head_dim"]
    return dataclasses.replace(cfg, **changes)
