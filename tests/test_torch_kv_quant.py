"""The port's KIVI pieces vs the JAX package, on the CPU.

Same inputs (numpy, seeded) through ``repro`` (the Pallas kernels in
interpret mode and the jnp oracles) and ``repro_torch`` (the plain PyTorch
versions, which the port runs on CPU tensors):

  * the per-page pack and unpack (``kernels/kv_quant``): codes and f32
    planes EQUAL to the jnp oracle's for bits 2/4/8, both grouping axes, a
    constant page and exact .5 ties (rounding is half to even on both
    sides). Against the Pallas kernel in interpret mode the codes and the
    zero plane are equal and the scale within 1 ulp: under ``jit`` XLA turns
    the division by the constant ``qmax`` into a product with its reciprocal
    (and fuses the unpack's ``codes * scale + zero`` into one rounding),
    where the eager oracle, the port and its CUDA kernel round each step;
  * ``core/kv_quant.py``: quantize/dequantize equal, the GEAR residual's
    rank-r product within 1e-5, ``quant_error`` and ``compression_ratio``;
  * quantized paged attention (``paged_attention_quant_ref``, the chunked
    oracle, the model-layout ops): f32 atol 1e-5 (summation order only), with
    tails of 1, 4 and 17 slots, dequantization in f32 and bf16, a row with
    ``tail_start = 0`` and one with ``lengths == tail_start``, and page slots
    past ``tail_start`` and tail slots past ``lengths`` poisoned (codes 255,
    f16 planes at their limit, +-1e6, +-Inf).

The CUDA kernels run only on the card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_quant as jcore
from repro.kernels.kv_quant.kv_quant import dequantize_pages as jdequantize_pages
from repro.kernels.kv_quant.kv_quant import quantize_pages as jquantize_pages
from repro.kernels.kv_quant.ref import dequantize_pages_ref as jdequantize_pages_ref
from repro.kernels.kv_quant.ref import quantize_pages_ref as jquantize_pages_ref
from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro.kernels.paged_attention.paged_attention import \
    paged_attention_quant as jpaged_attention_quant
from repro_torch.core import kv_quant as tcore
from repro_torch.kernels import _build
from repro_torch.kernels import kv_quant as tkv
from repro_torch.kernels.kv_quant import kv_quant as tkv_kernel
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import paged_attention_quant as tq_kernel
from repro_torch.kernels.paged_attention import ref as tref

BITS = [2, 4, 8]
AXES = ["channel", "token"]


def _pack_input(bits, axis, NP=6, P=8, C=32, seed=0):
    """Random pages, with page 0 constant (scale 0 -> 1) and page 1 built
    so that every interior value sits on an exact .5 tie: each group holds
    0 and qmax (scale exactly 1) and k + 0.5 elsewhere."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NP, P, C)).astype(np.float32) * 3
    x[0] = 1.25
    qmax = 2 ** bits - 1
    t, c = np.meshgrid(np.arange(P), np.arange(C), indexing="ij")
    ties = ((t + c) % qmax + 0.5).astype(np.float32)
    if axis == "channel":  # groups are columns: tokens 0, 1 hold the range
        ties[0], ties[1] = 0, qmax
    else:  # groups are rows: channels 0, 1 hold the range
        ties[:, 0], ties[:, 1] = 0, qmax
    x[1] = ties
    return x


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", AXES)
def test_pack_equals_jax(bits, axis):
    x = _pack_input(bits, axis)
    want_kernel = jquantize_pages(jnp.asarray(x), bits=bits, axis=axis, interpret=True)
    want_ref = jquantize_pages_ref(jnp.asarray(x), bits=bits, axis=axis)
    got = tkv.quantize_pages_ref(torch.from_numpy(x), bits=bits, axis=axis)
    got_op = tkv.quantize_kv_pages(torch.from_numpy(x), bits=bits, axis=axis)
    for g, go, wr in zip(got, got_op, want_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wr))
        assert torch.equal(g, go)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_kernel[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_kernel[1]),
                               rtol=2 ** -23, atol=0)  # (hi - lo) * (1 / qmax)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_kernel[2]))
    codes, scale, zero = got
    assert codes.dtype == torch.uint8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == ((6, 1, 32) if axis == "channel" else (6, 8, 1))
    # the constant page: scale 1, codes 0; the tie page: both parities of k
    assert torch.all(scale[0] == 1) and torch.all(codes[0] == 0)
    inner = codes[1, 2:, :] if axis == "channel" else codes[1, :, 2:]
    ties = torch.from_numpy(_pack_input(bits, axis)[1])
    ties = ties[2:, :] if axis == "channel" else ties[:, 2:]
    # every tie k + 0.5 rounds to its even neighbour: half to even
    assert torch.equal(inner, torch.round(ties).to(torch.uint8))
    assert torch.all(inner % 2 == 0)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_unpack_equals_jax(axis, out_dtype):
    x = _pack_input(8, axis, seed=3)
    codes, scale, zero = jquantize_pages_ref(jnp.asarray(x), bits=8, axis=axis)
    jdt, tdt = jnp.dtype(out_dtype), getattr(torch, out_dtype)
    want = jdequantize_pages(codes, scale, zero, out_dtype=jdt, interpret=True)
    tc, ts, tz = (torch.from_numpy(np.array(a)) for a in (codes, scale, zero))
    got = tkv.dequantize_pages_ref(tc, ts, tz, out_dtype=tdt)
    got_op = tkv.dequantize_kv_pages(tc, ts, tz, out_dtype=tdt)
    assert got.dtype == tdt and torch.equal(got, got_op)
    np.testing.assert_array_equal(
        tkv.dequantize_pages_ref(tc, ts, tz).numpy(),
        np.asarray(jdequantize_pages_ref(codes, scale, zero)))
    # the interpret kernel fuses codes * scale + zero into one rounding: 1 ulp
    # of the product apart in f32 (|codes * scale| <= 6 here), which may flip
    # one bf16 rounding
    ulp = 2 ** -8 if out_dtype == "bfloat16" else 6 * 2 ** -23
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=ulp, atol=ulp)


@pytest.mark.parametrize("bits", [4, 8])
def test_core_kv_quant_matches_jax(bits):
    rng = np.random.default_rng(bits)
    k = rng.normal(size=(2, 3, 16, 32)).astype(np.float32)
    v = rng.normal(size=(2, 3, 16, 32)).astype(np.float32)
    for axis in AXES:
        for g, w in zip(tcore.quantize(torch.from_numpy(k), bits, axis),
                        jcore.quantize(jnp.asarray(k), bits, axis)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert tcore.quant_error(k, bits, axis) == pytest.approx(
            jcore.quant_error(k, bits, axis), rel=1e-5)
    qc_t = tcore.QuantConfig(bits=bits, residual_rank=2)
    qc_j = jcore.QuantConfig(bits=bits, residual_rank=2)
    kq, vq, res = tcore.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qc_t)
    jkq, jvq, jres = jcore.quantize_kv(jnp.asarray(k), jnp.asarray(v), qc_j)
    # singular vectors are unique up to sign: compare the rank-r product
    np.testing.assert_allclose((res[0] @ res[1]).numpy(),
                               np.asarray(jres[0] @ jres[1]), atol=1e-5)
    kd, vd = tcore.dequantize_kv(kq, vq, res)
    jkd, jvd = jcore.dequantize_kv(jkq, jvq, jres)
    np.testing.assert_allclose(kd.numpy(), np.asarray(jkd), atol=1e-5)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jvd), atol=1e-6)
    for axis in AXES:
        assert tcore.compression_ratio(bits, 2, 16, 128, axis) == \
            jcore.compression_ratio(bits, 2, 16, 128, axis)


# ---------------------------------------------------------------------------
# quantized paged attention
# ---------------------------------------------------------------------------

KV, G, D, P, NP = 2, 4, 64, 16, 4


def _quant_case(seed, B, T, *, tail_start, lengths):
    """Quantized pages packed by JAX's oracle from random fp pages (planes
    stored as f16, as the engine stores them), disjoint per-row tables, fp
    tails whose values bf16 represents exactly (so a bf16 round trip of the
    tail is exact on both sides)."""
    rng = np.random.default_rng(seed)
    NB = B * NP + 2
    q = rng.normal(size=(B, KV, G, D)).astype(np.float32)
    leaves = {}
    for name, axis in (("k", "channel"), ("v", "token")):
        fp = rng.normal(size=(KV * NB, P, D)).astype(np.float32)
        codes, scale, zero = jquantize_pages_ref(jnp.asarray(fp), bits=8, axis=axis)
        shape = lambda a: np.asarray(a).reshape((KV, NB) + a.shape[1:])  # noqa: E731
        leaves[name] = {"codes": shape(codes),
                        "scale": shape(scale).astype(np.float16),
                        "zero": shape(zero).astype(np.float16)}
        tail = rng.normal(size=(B, T, KV, D)).astype(np.float32)
        leaves[name]["tail"] = torch.from_numpy(tail).bfloat16().float().numpy()
    tables = rng.permutation(NB)[: B * NP].reshape(B, NP).astype(np.int32)
    return (q, leaves, tables, np.asarray(lengths, np.int32),
            np.asarray(tail_start, np.int32))


def _poison(leaves, tables, lengths, tail_start):
    """A copy with every slot the rows must not read poisoned: page slots
    at or past tail_start (codes 255, value planes at the f16 limit, whole
    dead pages' key planes +-Inf) and tail slots at or past lengths
    (+-1e6, +-Inf)."""
    out = {n: {k: a.copy() for k, a in leaf.items()} for n, leaf in leaves.items()}
    for b in range(len(lengths)):
        ts = int(tail_start[b])
        for page in range(NP):
            blk = tables[b, page]
            dead = slice(max(0, ts - page * P), P)
            for n in ("k", "v"):
                out[n]["codes"][:, blk, dead] = 255
            out["v"]["scale"][:, blk, dead] = np.float16(65504)
            out["v"]["zero"][:, blk, dead] = -np.inf
            if page * P >= ts:
                out["k"]["scale"][:, blk] = np.inf
                out["k"]["zero"][:, blk] = -np.inf
        n_tail = int(lengths[b]) - ts
        out["k"]["tail"][b, n_tail:] = np.where(
            np.arange(out["k"]["tail"].shape[1] - n_tail)[:, None, None] % 2, 1e6, np.inf)
        out["v"]["tail"][b, n_tail:] = -np.inf
    return out


def _args(q, leaves, tables, lengths, tail_start, framework):
    conv = (lambda a: jnp.asarray(a)) if framework == "jax" else \
        (lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return (conv(q), conv(leaves["k"]["codes"]), conv(leaves["k"]["scale"]),
            conv(leaves["k"]["zero"]), conv(leaves["v"]["codes"]),
            conv(leaves["v"]["scale"]), conv(leaves["v"]["zero"]),
            conv(leaves["k"]["tail"]), conv(leaves["v"]["tail"]), conv(tables),
            conv(lengths), conv(tail_start))


@pytest.mark.parametrize("T", [1, 4, 17])
@pytest.mark.parametrize("deq", ["float32", "bfloat16"])
def test_quant_attention_matches_jax(T, deq):
    """Rows: tail only (tail_start 0), a mid-page split with a full tail,
    pages only (lengths == tail_start), and a split at a page boundary."""
    tail_start = [0, 13, 32, 48]
    lengths = [T, 13 + T, 32, 48 + (T + 1) // 2]
    case = _quant_case(T, 4, T, tail_start=tail_start, lengths=lengths)
    jdt, tdt = jnp.dtype(deq), getattr(torch, deq)
    jargs = _args(*case, "jax")
    want = np.asarray(jpaged_attention_quant(*jargs, scale=0.125, deq_dtype=jdt,
                                             interpret=True))
    want_ref = np.asarray(jref.paged_attention_quant_ref(*jargs, scale=0.125,
                                                         deq_dtype=jdt))
    np.testing.assert_allclose(want, want_ref, atol=1e-5)
    got = tref.paged_attention_quant_ref(*_args(*case, "torch"), scale=0.125,
                                         deq_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the wrapper's CPU path is the plain version
    wrapped = tq_kernel.paged_attention_quant(*_args(*case, "torch"), scale=0.125,
                                              deq_dtype=tdt)
    assert torch.equal(wrapped, got)
    # poisoned dead slots change nothing
    q, leaves, tables, ln, ts = case
    bad = _args(q, _poison(leaves, tables, ln, ts), tables, ln, ts, "torch")
    poisoned = tref.paged_attention_quant_ref(*bad, scale=0.125, deq_dtype=tdt)
    assert torch.isfinite(poisoned).all()
    np.testing.assert_allclose(poisoned.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("C", [1, 3, 8])
def test_chunked_quant_oracle_and_fold_match_jax(C):
    """Chunked oracle vs JAX's; the fold (row b*C + j with length
    lengths[b] + j + 1, sequence b's tail, table and tail_start) on CPU
    tensors equals it too, so the CUDA path's semantics hold here."""
    B = 3
    lengths = np.asarray([0, 13, 47], np.int32)  # chunk starts
    tail_start = lengths // P * P
    case = _quant_case(100 + C, B, P + C, tail_start=tail_start,
                       lengths=lengths)
    q1, leaves, tables, _, _ = case
    qc = np.random.default_rng(C).normal(size=(B, C, KV, G, D)).astype(np.float32)
    jargs = _args(qc, leaves, tables, lengths, tail_start, "jax")
    want = np.asarray(jref.paged_attention_chunked_quant_ref(*jargs, scale=0.2))
    targs = _args(qc, leaves, tables, lengths, tail_start, "torch")
    got = tref.paged_attention_chunked_quant_ref(*targs, scale=0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    row_len = torch.from_numpy((lengths[:, None] + np.arange(C)[None, :] + 1)
                               .reshape(-1).astype(np.int32))
    fold = tq_kernel.paged_attention_quant(
        targs[0].reshape(B * C, KV, G, D), *targs[1:10], row_len, targs[11],
        scale=0.2, rows_per_seq=C)
    np.testing.assert_allclose(fold.reshape(B, C, KV, G, D).numpy(), want, atol=1e-5)


def test_quant_model_layout_ops_match_jax():
    """paged_attend_quant / paged_attend_extend_quant (model layout, int64
    tables) == the JAX ops on their CPU path."""
    B, C, H = 3, 5, KV * G
    lengths = np.asarray([3, 20, 33], np.int32)
    tail_start = lengths // P * P
    q1, leaves, tables, _, _ = _quant_case(7, B, P + C,
                                           tail_start=tail_start, lengths=lengths)
    rng = np.random.default_rng(8)
    q1 = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    qc = rng.normal(size=(B, C, H, D)).astype(np.float32)
    tables = tables.astype(np.int64)

    def pages(conv):
        return [{k: conv(a) for k, a in leaves[n].items() if k != "tail"}
                for n in ("k", "v")]

    jp = pages(jnp.asarray)
    tp = pages(torch.from_numpy)
    jt = [jnp.asarray(leaves[n]["tail"]) for n in ("k", "v")]
    tt = [torch.from_numpy(leaves[n]["tail"]) for n in ("k", "v")]
    valid = lengths + 1  # decode: the tail's first token past the split
    want = jops.paged_attend_quant(jnp.asarray(q1), *jp, *jt, jnp.asarray(tables),
                                   jnp.asarray(valid), jnp.asarray(tail_start),
                                   scale=0.2, impl="ref")
    got = tops.paged_attend_quant(torch.from_numpy(q1), *tp, *tt,
                                  torch.from_numpy(tables), torch.from_numpy(valid),
                                  torch.from_numpy(tail_start), scale=0.2)
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jops.paged_attend_extend_quant(
        jnp.asarray(qc), *jp, *jt, jnp.asarray(tables), jnp.asarray(lengths),
        jnp.asarray(tail_start), scale=0.2, impl="ref")
    got = tops.paged_attend_extend_quant(
        torch.from_numpy(qc), *tp, *tt, torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(tail_start), scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("bits", [4, 8])
def test_quant_oracle_matches_core_reference(bits, seed):
    """Quantized paged attention == fp paged attention over pages
    dequantized with ``core/kv_quant.py`` (K per channel, V per token), with
    the tail materialized into the pages: the oracle's dequantization IS the
    reference quantization math. ``ts`` is drawn up to NP*P - T, so the
    materialized tail stays inside the table."""
    rng = np.random.default_rng(seed)
    B, KV_, G_, D_, P_, NB, NP_, T = 1, 2, 2, 32, 8, 8, 4, 2
    kf = torch.from_numpy(rng.normal(size=(KV_ * NB, P_, D_)).astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=(KV_ * NB, P_, D_)).astype(np.float32))

    def per_page(x, axis):
        parts = [tcore.quantize(page, bits, axis, token_axis=0, channel_axis=1)
                 for page in x]
        return [torch.stack(p) for p in zip(*parts)]

    kc, ks, kz = per_page(kf, "channel")
    vc, vs, vz = per_page(vf, "token")
    shape = lambda a: a.reshape((KV_, NB) + a.shape[1:])  # noqa: E731
    q = torch.from_numpy(rng.normal(size=(B, KV_, G_, D_)).astype(np.float32))
    kt = torch.from_numpy(rng.normal(size=(B, T, KV_, D_)).astype(np.float32))
    vt = torch.from_numpy(rng.normal(size=(B, T, KV_, D_)).astype(np.float32))
    tables = np.stack([rng.choice(NB, NP_, replace=False) for _ in range(B)])
    ts = rng.integers(1, NP_ * P_ - T + 1, size=(B,))
    lengths = ts + rng.integers(1, T + 1, size=(B,))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    out = tref.paged_attention_quant_ref(
        q, shape(kc), shape(ks), shape(kz), shape(vc), shape(vs), shape(vz), kt, vt,
        i32(tables), i32(lengths), i32(ts), scale=0.2)
    kd = shape(tcore.dequantize(kc, ks, kz)).clone()
    vd = shape(tcore.dequantize(vc, vs, vz)).clone()
    for b in range(B):
        for i in range(int(lengths[b] - ts[b])):
            pos = int(ts[b] + i)
            kd[:, tables[b, pos // P_], pos % P_] = kt[b, i]
            vd[:, tables[b, pos // P_], pos % P_] = vt[b, i]
    want = tref.paged_attention_ref(q, kd, vd, i32(tables), i32(lengths), scale=0.2)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5)


def test_no_silent_cpu_fallback(monkeypatch, tmp_path):
    """Tensors on another device, or on several, raise; a build without nvcc
    raises instead of computing anything."""
    x = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="no kernel for device"):
        tkv_kernel.quantize_pages(x.to("meta"), bits=8, axis="channel")
    codes = torch.zeros(2, 4, 32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="several devices"):
        tkv_kernel.dequantize_pages(codes, torch.zeros(2, 1, 32).to("meta"),
                                    torch.zeros(2, 1, 32))
    case = _quant_case(1, 1, 1, tail_start=[0], lengths=[1])
    args = [a.to("meta") for a in _args(*case, "torch")]
    with pytest.raises(ValueError, match="no kernel for device"):
        tq_kernel.paged_attention_quant(*args, scale=1.0)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    for source in (tkv_kernel.SOURCE, tq_kernel.SOURCE):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(source, build_dir=tmp_path / "build")
