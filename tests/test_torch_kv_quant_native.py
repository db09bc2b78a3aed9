"""The KIVI pack and unpack as the serving store calls them, on the CPU.

  * The pack of f32, bf16 and f16 pages (the CUDA pack reads the staging
    dtype and upcasts in registers) against JAX's ``quantize_pages`` in
    interpret mode and its ``quantize_pages_ref`` on the same pages (numpy,
    seeded, cast to the dtype on both sides, with a constant page and a page
    of exact .5 ties): codes and f32 planes equal to the oracle's; against
    the interpret kernel the zero plane is equal and the scale within 1 ulp
    (under ``jit`` XLA divides by ``qmax`` through its reciprocal), so codes
    are equal wherever the scales are and within one step elsewhere; the f16
    planes equal the f32 planes cast, so the store keeps the bytes of the
    f32 pack of ``pages.float()``.
  * The launch plans (``pack_plan``, ``unpack_plan``) for P 4-32, C 32-256
    and 48, NP 1-4097: the route each shape and axis takes (a CTA per page
    up to one wave of pages, a warp per page past it), pages that fit a
    CTA's shared memory.
  * ``PagedModelState._requant_group`` over bf16, f16 and f32 staging pages:
    the store's codes and f16 planes equal the f32 pack of the pages with
    its planes cast, and ``pack_transfer_bytes`` counts the pages in their
    own dtype, the codes and the f16 planes.

The CUDA kernels run only on the card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_quant.kv_quant import quantize_pages as jquantize_pages
from repro.kernels.kv_quant.ref import quantize_pages_ref as jquantize_pages_ref
from repro_torch import configs as tconfigs
from repro_torch.core import EngineConfig, QuantConfig
from repro_torch.core.executor.state import PagedModelState
from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import kv_quant as tkv
from repro_torch.kernels.kv_quant import ops as tops
from repro_torch.kernels.kv_quant.ref import quantize_pages_ref

BITS = [2, 4, 8]
AXES = ["channel", "token"]
DTYPES = ["float32", "bfloat16", "float16"]
SMS = 132  # the H100's SMs


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
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_of_each_input_dtype_equals_jax(bits, axis, dtype):
    x32 = _pack_input(bits, axis, seed=bits)
    jx = jnp.asarray(x32).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    # both sides round the f32 draws to the same values
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)))
    want_ref = jquantize_pages_ref(jx, bits=bits, axis=axis)
    want_kernel = jquantize_pages(jx, bits=bits, axis=axis, interpret=True)
    got = tkv.quantize_pages(tx, bits=bits, axis=axis)
    for g, w in zip(got, want_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.uint8 and got[1].dtype == got[2].dtype == torch.float32
    # the interpret kernel: zero equal, scale within 1 ulp ((hi - lo) * (1 /
    # qmax) under jit); codes equal in every group whose scale is equal, and
    # within one step (a rounding boundary) in the others
    kcodes, kscale, kzero = (np.asarray(a) for a in want_kernel)
    np.testing.assert_array_equal(got[2].numpy(), kzero)
    np.testing.assert_allclose(got[1].numpy(), kscale, rtol=2 ** -23, atol=0)
    same = np.broadcast_to(got[1].numpy() == kscale, kcodes.shape)
    np.testing.assert_array_equal(got[0].numpy()[same], kcodes[same])
    assert np.abs(got[0].numpy().astype(int) - kcodes).max() <= 1
    # the pack of the pages' own dtype is the f32 pack of their upcast
    for g, w in zip(got, quantize_pages_ref(tx.float(), bits=bits, axis=axis)):
        assert torch.equal(g, w)
    # f16 planes: the f32 planes rounded once, through the wrapper and the op
    for half in (tkv.quantize_pages(tx, bits=bits, axis=axis, plane_dtype=torch.float16),
                 tops.quantize_kv_pages(tx, bits=bits, axis=axis,
                                        plane_dtype=torch.float16)):
        assert torch.equal(half[0], got[0])
        for h, g, w in zip(half[1:], got[1:], want_ref[1:]):
            assert h.dtype == torch.float16 and torch.equal(h, g.to(torch.float16))
            np.testing.assert_array_equal(h.numpy(), np.asarray(w).astype(np.float16))
    # the tie page, where the dtype holds it exactly: half to even
    if np.array_equal(tx[1].float().numpy(), x32[1]):
        codes = got[0]
        inner = codes[1, 2:, :] if axis == "channel" else codes[1, :, 2:]
        ties = torch.from_numpy(x32[1])
        ties = ties[2:, :] if axis == "channel" else ties[:, 2:]
        assert torch.equal(inner, torch.round(ties).to(torch.uint8))
        assert torch.all(inner % 2 == 0)
    assert torch.all(got[1][0] == 1) and torch.all(got[0][0] == 0)  # the constant page


def test_pack_refuses_other_plane_dtypes():
    x = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="plane_dtype"):
        tkv.quantize_pages(x, plane_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

NPS = [1, 3, 131, 256, 1056, 1057, 4097]


@pytest.mark.parametrize("P", [4, 8, 16, 32])
@pytest.mark.parametrize("C", [32, 48, 64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", AXES)
def test_pack_plan(P, C, dtype, axis):
    itemsize = torch.finfo(getattr(torch, dtype)).bits // 8
    page = P * C * itemsize
    for NP in NPS:
        plan = tkv.pack_plan(NP, P, C, itemsize, axis, SMS)
        # a CTA per page for C outside the warp kernel's instances and while
        # the pages fit one wave of CTAs
        if C not in tkv.WARP_C or NP <= tkv.ONE_WAVE_CTAS * SMS:
            assert plan == tkv.PackPlan("generic", tkv.THREADS // 32, NP)
            continue
        # past it a warp per page, every page's warp launched: per token
        # (one pass) direct loads, per channel (two passes) a bulk copy of
        # the page, a multiple of 16 bytes, into shared memory
        assert plan.grid == -(-NP // plan.warps)
        assert plan.grid * plan.warps - NP < plan.warps
        assert plan.route == ("direct" if axis == "token" else "bulk") and page % 16 == 0
        assert plan.warps == tkv.CTA_WARPS
        assert tkv.bulk_smem(plan.warps, page) <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("P", [4, 6, 8, 16, 32])
@pytest.mark.parametrize("C", [32, 40, 48, 64, 128, 256])
def test_unpack_plan(P, C):
    for NP, itemsize in ((NP, i) for NP in NPS for i in (4, 2)):
        plan = tkv.unpack_plan(NP, P, C, itemsize, SMS)
        if C % 16 or P % tkv.UNPACK_ROWS:
            assert plan == tkv.UnpackPlan("scalar", NP)
            continue
        units = NP * P * C // (tkv.UNPACK_ROWS * 16 // itemsize)
        assert plan.route == "vector"
        assert 1 <= plan.grid <= SMS * tkv.UNPACK_CTAS_PER_SM
        assert plan.grid == min(-(-units // tkv.THREADS), SMS * tkv.UNPACK_CTAS_PER_SM)


def test_serve_shapes_plans():
    """The KIVI serve's packs (olmo-1b: P 16, C 128, bf16 staging; a decode
    step's fill of 256 pages, a prefill step's 4096) and a page too large
    for four warps' shared memory."""
    for itemsize in (2, 4):
        for axis in AXES:
            assert tkv.pack_plan(256, 16, 128, itemsize, axis, SMS) == ("generic", 8, 256)
        assert tkv.pack_plan(4096, 16, 128, itemsize, "channel", SMS) == ("bulk", 4, 1024)
        assert tkv.pack_plan(4096, 16, 128, itemsize, "token", SMS) == ("direct", 4, 1024)
    assert tkv.pack_plan(4096, 64, 256, 4, "channel", SMS) == ("bulk", 3, 1366)


# ---------------------------------------------------------------------------
# the serving store's pack call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_requant_group_packs_staging_pages_in_their_dtype(bits, dtype):
    cfg = tconfigs.smoke_config("olmo-1b")
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": dtype})
    P = 4
    state = PagedModelState(cfg, EngineConfig(block_size=P, num_blocks=12, device="cpu",
                                              kv_quant=QuantConfig(bits=bits)), "cpu")
    assert state.quantized
    rng = np.random.default_rng(bits)
    for idx, stage in state.qstage.items():
        stage.copy_(torch.from_numpy(rng.normal(size=stage.shape).astype(np.float32) * 2))
    blocks = torch.tensor([1, 5, 6, 9])
    leaves = state.attn_kv_leaves()
    state._requant_group([(idx, blocks, state.qstage[idx][:, blocks])
                          for _, _, idx in leaves])
    elt = torch.finfo(getattr(torch, dtype)).bits // 8
    want_bytes = 0
    for _, name, idx in leaves:
        stage = state.qstage[idx][:, blocks]  # (KV, n, P, D)
        assert stage.dtype == getattr(torch, dtype)
        KV, n, _, D = stage.shape
        x = stage.transpose(0, 1).reshape(-1, P, D).float()
        axis = "channel" if name == "k" else "token"
        codes, scale, zero = quantize_pages_ref(x, bits=bits, axis=axis)
        back = lambda t: t.reshape((n, KV) + t.shape[1:]).transpose(0, 1)  # noqa: E731
        assert torch.equal(state.stores[idx][:, blocks], back(codes))
        for pname, plane in (("scale", scale), ("zero", zero)):
            got = state.qplanes[idx][pname][:, blocks]
            assert got.dtype == torch.float16
            assert torch.equal(got, back(plane.to(torch.float16)))
        # up: the pages in their own dtype; down: codes and f16 planes
        want_bytes += x.numel() * (elt + 1) + 2 * scale.numel() * 2
    assert state.pack_transfer_bytes == want_bytes
