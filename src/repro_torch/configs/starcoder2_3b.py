"""StarCoder2-3B [arXiv:2402.19173].

30 layers, d_model=3072, 24 heads / 2 KV heads (GQA), d_ff=12288, vocab=49152.
LayerNorm + plain-GeLU MLP with biases, RoPE, sliding-window attention (4096).
Sliding window bounds the KV working set -> long_500k eligible.
"""
from repro_torch.configs.base import ModelConfig, dense_stages

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    stages=dense_stages(30, attn_kind="window"),
    citation="arXiv:2402.19173",
    norm="layernorm",
    activation="gelu",
    qkv_bias=True,
    mlp_bias=True,
    attn_out_bias=True,
    use_rope=True,
    rope_theta=999_999.4420358813,
    sliding_window=4096,
    tie_embeddings=True,
    long_context_ok=True,
)
