"""InternVL2-2B [arXiv:2404.16821].

Language backbone: InternLM2-1.8B — 24 layers, d_model=2048, 16 heads / 8 KV heads
(GQA), d_ff=8192, vocab=92553, RMSNorm + SwiGLU, RoPE theta=1e6.

Vision frontend (InternViT-300M + pixel-shuffle + MLP projector) is a STUB per the
assignment carve-out: ``input_specs()`` provides 256 pre-projected image-token
embeddings of dimension d_model which the backbone splices ahead of the text
tokens (early fusion). Full global attention -> long_500k skipped (DESIGN §4).
"""
from repro_torch.configs.base import ModelConfig, dense_stages

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    stages=dense_stages(24),
    citation="arXiv:2404.16821",
    norm="rmsnorm",
    activation="silu_glu",
    use_rope=True,
    rope_theta=1_000_000.0,
    num_image_tokens=256,
    long_context_ok=False,
)
