"""Model factory of the PyTorch port: dense global-attention decoders on the
paged serving path.

The twin of the paged family of ``repro.models.model.build_model``:
``embed_tokens``, ``head``, ``decode_paged`` (one token) and
``extend_paged`` (chunked prefill / ragged mixed batches), over plain
parameter dicts. Parameters: ``{"embed": (V, d), "final_norm": {...},
["lm_head": {"w": (d, V)}], "layers": [layer, ...]}`` with one dict per
layer in ``cfg.layer_specs()`` order — the JAX package stacks repeats
along a leading axis instead; ``models/convert.py`` unstacks them.

Pages are a list over layers of ``{"k", "v"}`` tensors in kernel layout
(KV, NB, P, D), written in place. ``build_model(cfg, device=...)`` runs
on ``cuda`` unless asked for ``cpu`` and raises when CUDA is asked for and
absent.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, dense, glu_inner_act, is_glu,
                                       make_dense, make_norm, normal_init)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """The port's entry points take an explicit device: ``cuda`` (the
    default everywhere) must exist — there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def make_mlp_params(gen, cfg, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    out1 = 2 * f if is_glu(cfg.activation) else f
    return {"w1": make_dense(gen, d, out1, dtype, device, bias=cfg.mlp_bias),
            "w2": make_dense(gen, f, d, dtype, device, bias=cfg.mlp_bias,
                             scale=1.0 / math.sqrt(f))}


def mlp_apply(p, cfg, x):
    h = dense(p["w1"], x)
    if is_glu(cfg.activation):
        # u is the FIRST half of w1's output, the gate g the second
        u, g = torch.chunk(h, 2, dim=-1)
        h = glu_inner_act(cfg.activation)(g) * u
    else:
        h = glu_inner_act(cfg.activation)(h)
    return dense(p["w2"], h)


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def _layer_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device):
    if spec.mixer != "attn" or spec.ff != "mlp":
        raise NotImplementedError(
            f"layer {spec}: the port covers attn+mlp layers only "
            "(ROADMAP queue A.11: other model families)")
    return {"norm1": make_norm(cfg.norm, cfg.d_model, dtype, device),
            "mixer": attn.make_attention_params(gen, cfg, dtype, device),
            "norm2": make_norm(cfg.norm, cfg.d_model, dtype, device),
            "ff": make_mlp_params(gen, cfg, dtype, device)}


def _ff_branch(p, spec, cfg, x):
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + mlp_apply(p["ff"], cfg, h)


def _layer_decode_paged(p, spec, cfg, x, pages, block_tables, lengths):
    """One-token decode with attention running directly on page stores."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    y, pages, kv_new = attn.attn_decode_paged(p["mixer"], cfg, spec, h, pages,
                                              block_tables, lengths)
    return _ff_branch(p, spec, cfg, x + y), pages, kv_new


def _layer_extend_paged(p, spec, cfg, x, pages, block_tables, lengths, *,
                        chunk_lens=None, scratch_block=None):
    """C-token extend with attention running directly on page stores."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    y, pages, kv_new = attn.attn_extend_paged(
        p["mixer"], cfg, spec, h, pages, block_tables, lengths,
        chunk_lens=chunk_lens, scratch_block=scratch_block)
    return _ff_branch(p, spec, cfg, x + y), pages, kv_new


def paged_decode_supported(cfg: ModelConfig) -> bool:
    """Whether ``decode_paged`` covers this stack: every layer must be plain
    global attention with a dense MLP."""
    if cfg.family == "audio":
        return False
    return all(s.mixer == "attn" and s.attn_kind == "global" and s.ff == "mlp"
               for p, _ in cfg.stages for s in p)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Model:
    """Functions over a parameter dict for one config on one device."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if not paged_decode_supported(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the port serves pure global-attention dense "
                "stacks only (ROADMAP queue A.11: other model families)")
        if cfg.learned_positions or cfg.family == "audio":
            raise NotImplementedError(f"{cfg.name}: learned positions / "
                                      "enc-dec are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.pdtype = DTYPES[cfg.param_dtype]
        self.specs = cfg.layer_specs()

    # ---------------- init ---------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed`` on
        the model's device (JAX's init draws other bits for the same seed;
        parity tests convert the JAX weights instead)."""
        cfg, dev, pdt = self.cfg, self.device, self.pdtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": normal_init(gen, (cfg.vocab_size, d), pdt, d ** -0.5, dev),
            "final_norm": make_norm(cfg.norm, d, pdt, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = make_dense(gen, d, cfg.vocab_size, pdt, dev,
                                           scale=1.0 / math.sqrt(d))
        params["layers"] = [_layer_init(gen, spec, cfg, pdt, dev)
                            for spec in self.specs]
        return params

    def init_pages(self, num_blocks: int, block_size: int) -> List[Dict[str, torch.Tensor]]:
        """Zeroed page stores, one {"k", "v"} pair per layer, kernel layout
        (KV, NB, P, D) in the activation dtype, on the model's device."""
        cfg = self.cfg
        shape = (cfg.num_kv_heads, num_blocks, block_size, cfg.head_dim)
        return [{name: torch.zeros(shape, dtype=self.dtype, device=self.device)
                 for name in ("k", "v")} for _ in self.specs]

    # ---------------- shared helpers ----------------------------------------
    def embed_tokens(self, params, tokens):
        e = params["embed"][tokens.long()].to(self.dtype)
        if self.cfg.embed_scale:
            e = e * math.sqrt(self.cfg.d_model)
        return e

    def head(self, params, x):
        x = apply_norm(self.cfg.norm, params["final_norm"], x)
        w = params["embed"].t() if self.cfg.tie_embeddings \
            else params["lm_head"]["w"]
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))

    # ---------------- decode_paged (one token) --------------------------------
    @torch.no_grad()
    def decode_paged(self, params, tokens, pages, block_tables, lengths):
        """tokens: (B, 1); pages: list over layers of {"k", "v"} (KV, NB, P,
        D); block_tables: (B, NP) shared by every layer; lengths: (B,) valid
        tokens before this one. Returns (logits (B, 1, V), pages, writes)
        with one {"k", "v"} (B, KV, D) entry per layer: the new token's K/V
        for the host-authoritative store."""
        x = self.embed_tokens(params, tokens)
        writes = []
        for p, spec, pg in zip(params["layers"], self.specs, pages):
            x, _, (k_new, v_new) = _layer_decode_paged(
                p, spec, self.cfg, x, pg, block_tables, lengths)
            writes.append({"k": k_new, "v": v_new})
        return self.head(params, x), pages, writes

    # ---------------- extend_paged (C-token chunks) --------------------------
    @torch.no_grad()
    def extend_paged(self, params, tokens, pages, block_tables, lengths,
                     chunk_lens=None, scratch_block: Optional[int] = None):
        """tokens: (B, C) at positions [lengths, lengths + C); pages /
        tables / lengths as in ``decode_paged``. Ragged batches pass
        ``chunk_lens`` (B,) and a ``scratch_block`` for padded positions'
        writes; logits of padded positions are garbage the caller ignores.
        Returns (logits (B, C, V), pages, writes) with write leaves
        (B, C, KV, D)."""
        x = self.embed_tokens(params, tokens)
        writes = []
        for p, spec, pg in zip(params["layers"], self.specs, pages):
            x, _, (k_new, v_new) = _layer_extend_paged(
                p, spec, self.cfg, x, pg, block_tables, lengths,
                chunk_lens=chunk_lens, scratch_block=scratch_block)
            writes.append({"k": k_new, "v": v_new})
        return self.head(params, x), pages, writes


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
