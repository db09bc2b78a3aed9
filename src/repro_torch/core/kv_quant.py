"""KIVI-style asymmetric KV-cache quantization (survey §III.C, arXiv:2402.02750).

The port's copy of ``repro.core.kv_quant``, as plain functions on tensors.
Keys have outlier *channels*, so they are quantized per channel (groups
along the channel axis); values are token-local, so they are quantized per
token. Both use asymmetric min/max uniform quantization at 2-8 bits, codes
one byte each. A GEAR-style residual (a rank-r approximation of the key
quantization error, kept in fp) is available as an option.

The page kernels in ``kernels/kv_quant`` perform the same math per page; the
serving path uses those (``PagedModelState`` packs pages through them).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8
    key_axis: str = "channel"  # KIVI: keys per channel
    value_axis: str = "token"  # KIVI: values per token
    residual_rank: int = 0  # GEAR-style low-rank error correction


def _reduce_axes(ndim: int, axis_kind: str, token_axis: int,
                 channel_axis: int) -> Tuple[int, ...]:
    """Every axis EXCEPT the grouping one: per-token groups keep the token
    axis, per-channel groups the channel axis."""
    keep = token_axis if axis_kind == "token" else channel_axis
    return tuple(i for i in range(ndim) if i != keep)


def quantize(x: torch.Tensor, bits: int, axis_kind: str, *, token_axis: int = -2,
             channel_axis: int = -1):
    """x: (..., tokens, channels) -> (codes uint8, scale f32, zero f32).

    Asymmetric uniform quantization, grouped per token or per channel.
    Rounding is half to even (``torch.round``, like ``jnp.round``)."""
    token_axis %= x.dim()
    channel_axis %= x.dim()
    axes = _reduce_axes(x.dim(), axis_kind, token_axis, channel_axis)
    xf = x.float()
    lo = torch.amin(xf, dim=axes, keepdim=True)
    hi = torch.amax(xf, dim=axes, keepdim=True)
    qmax = float(2 ** bits - 1)
    # a tensor divisor: true division on every device (kernels/kv_quant/ref.py)
    scale = (hi - lo) / torch.full_like(hi, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round((xf - lo) / scale), 0, qmax).to(torch.uint8)
    return codes, scale, lo


def dequantize(codes, scale, zero) -> torch.Tensor:
    return codes.float() * scale + zero


def quantize_kv(k: torch.Tensor, v: torch.Tensor, qc: QuantConfig):
    """KIVI: K per channel, V per token. k/v: (..., tokens, channels).
    Returns (kq, vq, res): res is None, or the GEAR residual (u * s, vt) of
    rank ``qc.residual_rank`` over the trailing (tokens, channels) matrix."""
    kq = quantize(k, qc.bits, qc.key_axis)
    vq = quantize(v, qc.bits, qc.value_axis)
    res = None
    if qc.residual_rank:
        err = k.float() - dequantize(*kq)
        mat = err.reshape(-1, err.shape[-2], err.shape[-1])
        u, s, vt = torch.linalg.svd(mat, full_matrices=False)
        r = qc.residual_rank
        res = (u[..., :, :r] * s[..., None, :r], vt[..., :r, :])
    return kq, vq, res


def dequantize_kv(kq, vq, res=None):
    k = dequantize(*kq)
    v = dequantize(*vq)
    if res is not None:
        us, vt = res
        k = k + (us @ vt).reshape(k.shape)
    return k, v


def quant_error(x, bits: int, axis_kind: str) -> float:
    """Relative L2 error of a quantization round trip."""
    x = torch.as_tensor(x)
    xhat = dequantize(*quantize(x, bits, axis_kind))
    num = float(torch.linalg.vector_norm(xhat - x.float()))
    den = float(torch.linalg.vector_norm(x.float())) or 1.0
    return num / den


def compression_ratio(bits: int, residual_rank: int, tokens: int, channels: int,
                      axis: str = "channel", base_bits: int = 16,
                      scale_bits: int = 16) -> float:
    """Stored-bits ratio of fp caching vs quantized (codes + scale/zero).
    One (scale, zero) pair per GROUP: per-channel grouping has ``channels``
    groups, per-token grouping ``tokens``."""
    groups = channels if axis == "channel" else tokens
    base = tokens * channels * base_bits
    quant = tokens * channels * bits
    quant += 2 * scale_bits * groups
    quant += residual_rank * (tokens + channels) * 16
    return base / quant
