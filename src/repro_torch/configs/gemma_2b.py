"""Gemma 2B [arXiv:2403.08295].

18 layers, d_model=2048, 8 heads with MQA (1 KV head), head_dim=256, d_ff=16384,
vocab=256000. GeGLU MLPs, RMSNorm with (1 + w) scaling, embeddings scaled by
sqrt(d_model), tied embeddings, RoPE. Full global attention -> long_500k skipped.
MQA means the paged KV cache stores a single head per token — the block manager
benefits exactly as the survey's §III.A describes.
"""
from repro_torch.configs.base import ModelConfig, dense_stages

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    stages=dense_stages(18),
    citation="arXiv:2403.08295",
    norm="rmsnorm_p1",
    activation="gelu_glu",
    use_rope=True,
    rope_theta=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
    long_context_ok=False,
)
