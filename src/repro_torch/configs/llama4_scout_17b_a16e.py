"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E].

48 layers, d_model=5120, 40 heads / 8 KV heads (GQA), vocab=202048. Every layer is
MoE: 16 routed experts (top-1) + 1 shared expert, expert d_ff=8192. Attention
interleave: 3 chunked-attention layers (8192-token chunks, RoPE) followed by 1
global-attention layer (NoPE) — ``nope_on_global``. Chunked attention bounds the
KV working set -> long_500k eligible.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_c = LayerSpec(mixer="attn", ff="moe", attn_kind="chunked")
_g = LayerSpec(mixer="attn", ff="moe", attn_kind="global")

_block = (_c, _c, _c, _g)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    stages=((_block, 12),),
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    norm="rmsnorm",
    activation="silu_glu",
    use_rope=True,
    rope_theta=500_000.0,
    chunk_size=8192,
    nope_on_global=True,
    num_experts=16,
    top_k=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    router_aux_coef=0.001,
    long_context_ok=True,
)
