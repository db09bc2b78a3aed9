"""DeepSeek-V3 671B [arXiv:2412.19437].

61 layers (first 3 dense FFN, remaining 58 MoE), d_model=7168, 128 attention heads
with Multi-head Latent Attention (MLA): q_lora_rank=1536, kv_lora_rank=512,
qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128. MoE: 256 routed experts
(top-8, sigmoid router) + 1 shared expert, expert d_ff=2048 (assignment's d_ff);
dense-layer d_ff=18432 (paper value). vocab=129280. Multi-token prediction (MTP)
depth 1. Full (global) attention -> not eligible for long_500k.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_dense = LayerSpec(mixer="mla", ff="mlp", attn_kind="global")
_moe = LayerSpec(mixer="mla", ff="moe", attn_kind="global")

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,  # qk head dim = nope(128) + rope(64); v_head_dim below
    d_ff=18432,
    vocab_size=129280,
    stages=(((_dense,), 3), ((_moe,), 58)),
    citation="arXiv:2412.19437",
    norm="rmsnorm",
    activation="silu_glu",
    use_rope=True,
    rope_theta=10_000.0,
    num_experts=256,
    top_k=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    moe_sigmoid_router=True,
    router_aux_coef=0.0001,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    long_context_ok=False,
)
