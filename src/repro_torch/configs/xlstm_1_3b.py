"""xLSTM 1.3B [arXiv:2405.04517].

48 residual blocks, d_model=2048, 4 heads. xLSTM[7:1] ratio: 7 mLSTM blocks per
1 sLSTM block (sLSTM at in-group offset 7). d_ff=0: xLSTM blocks are
pre-up-projection (mLSTM, proj factor 2.0) or post-up-projection with a gated FFN
(sLSTM, proj factor 4/3) rather than carrying a separate transformer FFN.
vocab=50304. Pure recurrent (no KV cache) -> long_500k eligible with O(1) state.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_m = LayerSpec(mixer="mlstm", ff="none")
_s = LayerSpec(mixer="slstm", ff="none")

_block = (_m, _m, _m, _m, _m, _m, _m, _s)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,  # d_model / num_heads
    d_ff=0,
    vocab_size=50304,
    stages=((_block, 6),),
    citation="arXiv:2405.04517",
    norm="layernorm",
    activation="gelu",
    use_rope=False,
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    long_context_ok=True,
)
