"""Jamba v0.1 52B [arXiv:2403.19887].

32 layers organized as 4 Jamba blocks of 8 layers: attention at in-block offset 4
(attn:mamba = 1:7), MoE replacing the MLP on every other layer (odd offsets),
16 experts top-2. d_model=4096, 32 heads / 8 KV heads (GQA), d_ff=14336,
vocab=65536. Mamba mixer: d_state=16, d_conv=4, expand=2. No positional
encodings (the Mamba layers carry position information). Hybrid -> long_500k
eligible (attention layers' KV is context-parallel sharded; Mamba state is O(1)).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_m_mlp = LayerSpec(mixer="mamba", ff="mlp")
_m_moe = LayerSpec(mixer="mamba", ff="moe")
_a_mlp = LayerSpec(mixer="attn", ff="mlp", attn_kind="global")

_block = (_m_mlp, _m_moe, _m_mlp, _m_moe, _a_mlp, _m_moe, _m_mlp, _m_moe)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    stages=((_block, 4),),
    citation="arXiv:2403.19887",
    norm="rmsnorm",
    activation="silu_glu",
    use_rope=False,  # Jamba uses no explicit positional encoding
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    router_aux_coef=0.001,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    long_context_ok=True,
)
