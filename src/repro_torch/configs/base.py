"""Model configuration dataclasses (a copy of ``repro.configs.base``).

Every assigned architecture is expressed as a ``ModelConfig``. Heterogeneous layer
stacks (hybrid SSM/attention, alternating MoE, chunked-attention interleave) are
described by ``stages``: a tuple of ``(pattern, repeats)`` where ``pattern`` is a
tuple of ``LayerSpec``. Total layers = sum(len(pattern) * repeats). The PyTorch
port runs every layer unrolled, in ``layer_specs()`` order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One transformer-block-level layer."""

    mixer: str = "attn"  # attn | mla | mamba | mlstm | slstm
    ff: str = "mlp"  # mlp | moe | none
    attn_kind: str = "global"  # global | window | chunked (only for attn/mla)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]
    citation: str = ""

    # --- norms / activations -------------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | rmsnorm_p1 (gemma (1+w)) | layernorm | nonparam_ln
    activation: str = "silu_glu"  # silu_glu | gelu_glu | gelu | relu
    qkv_bias: bool = False
    mlp_bias: bool = False
    attn_out_bias: bool = False

    # --- positions ------------------------------------------------------------
    use_rope: bool = True
    rope_theta: float = 10_000.0
    learned_positions: int = 0  # >0: learned absolute positions of this size
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma/whisper-style)
    tie_embeddings: bool = False

    # --- attention variants ----------------------------------------------------
    sliding_window: int = 0  # window size for attn_kind == "window"
    chunk_size: int = 0  # chunk size for attn_kind == "chunked"
    softmax_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    nope_on_global: bool = False  # llama4: global-attention layers skip RoPE
    long_context_ok: bool = False  # eligible for the long_500k decode shape (DESIGN §4)

    # --- MoE -------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    router_aux_coef: float = 0.001
    moe_sigmoid_router: bool = False  # deepseek-v3 uses sigmoid+bias-free top-k

    # --- MLA (deepseek) ----------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba) -------------------------------------------------------------
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2

    # --- xLSTM ---------------------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- enc-dec (whisper) -----------------------------------------------------------
    encoder_layers: int = 0
    n_audio_ctx: int = 0  # encoder sequence length (post-conv frames)
    n_mels: int = 0

    # --- VLM -----------------------------------------------------------------------
    num_image_tokens: int = 0  # stubbed frontend: embeddings provided by input_specs

    # --- MTP (deepseek multi-token prediction) -----------------------------------------
    mtp_depth: int = 0

    # --- numerics --------------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- tensor-parallel serving (docs/sharding.md) ----------------------------------
    # Set only on the shard-LOCAL config the sharded paged runner builds
    # (num_heads / num_kv_heads / d_ff already divided by the model-axis
    # size): tp_axis names the mesh axis to all-reduce over after the
    # attention output projection (and after MLP w2 when tp_ff_sharded).
    # None (the default for every registered arch) means single-device
    # semantics — no collective is ever traced.
    tp_axis: Optional[str] = None
    tp_ff_sharded: bool = False

    # ---------------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(len(p) * r for p, r in self.stages)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def has_decoder_kv(self) -> bool:
        return any(s.mixer in ("attn", "mla") for p, _ in self.stages for s in p)

    @property
    def is_subquadratic(self) -> bool:
        """True if every attention layer is windowed/chunked or the model is SSM-only.

        Determines eligibility for the ``long_500k`` shape (see DESIGN.md §4).
        """
        for p, _ in self.stages:
            for s in p:
                if s.mixer in ("attn", "mla") and s.attn_kind == "global":
                    return False
        return True

    def layer_specs(self):
        """Flat list of LayerSpec, length == num_layers."""
        out = []
        for pattern, reps in self.stages:
            out.extend(list(pattern) * reps)
        return out


def dense_stages(n: int, attn_kind: str = "global") -> tuple:
    return (((LayerSpec(mixer="attn", ff="mlp", attn_kind=attn_kind),), n),)
