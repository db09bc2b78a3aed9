"""OLMo 1B [arXiv:2402.00838].

16 layers, d_model=2048, 16 heads (MHA: kv=16), d_ff=8192, vocab=50304.
Non-parametric LayerNorm (no learned scale/bias — the OLMo signature), SwiGLU,
no biases anywhere, tied embeddings, RoPE. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, dense_stages

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    stages=dense_stages(16),
    citation="arXiv:2402.00838",
    norm="nonparam_ln",
    activation="silu_glu",
    use_rope=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context_ok=False,
)
