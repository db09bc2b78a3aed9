"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B family card, 32B scale].

64 layers, d_model=5120, 40 heads / 8 KV heads (GQA), d_ff=27648, vocab=152064.
RMSNorm + SwiGLU, QKV bias (Qwen signature), RoPE theta=1e6. Full global
attention -> long_500k skipped (DESIGN §4).
"""
from repro_torch.configs.base import ModelConfig, dense_stages

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    stages=dense_stages(64),
    citation="hf:Qwen/Qwen2.5-0.5B",
    norm="rmsnorm",
    activation="silu_glu",
    qkv_bias=True,
    use_rope=True,
    rope_theta=1_000_000.0,
    long_context_ok=False,
)
