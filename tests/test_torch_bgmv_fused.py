"""The port's fused LoRA op (``bgmv_add``) and its grid plan, on the CPU.

The CUDA kernel (``kernels/lora/csrc/bgmv.cu``) serves up to three adapter
sites that share x in one launch (an attention layer's wq, wk and wv) and
adds each delta to its site's base output in place. What of that runs here
is held against the per-site composition it replaces and against the JAX
package on the same numpy inputs (seeded): the plain fused op
(``ref.bgmv_add_ref``, the CPU path of ``ops.bgmv_add``) equals ``base +
bgmv_ref`` per site bit for bit and matches JAX's ``bgmv`` (its oracle and
its Pallas kernel in interpret mode) plus the add; the host grid plan
(``bgmv.plan``) covers every (site, batch row, row of C, column) exactly
once and refuses what the kernel does not take; and the smoke models'
LoRA decode and extend logits through the new call sites (four launches a
layer) equal the per-site composition's.

Tolerances against JAX, as in ``test_torch_lora.py``: f32 ``atol 1e-6``
(summation order only, O(1) outputs); bf16 one bf16 step (``rtol 2^-7``:
both sum in f32 and round once). The kernel itself runs only on the card:
``gpu`` tests in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import itertools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lora import bgmv as jbgmv
from repro_torch import configs
from repro_torch.core.block_manager import BlockManager
from repro_torch.core.lora import LoRAConfig, PagedAdapterStore, make_adapter
from repro_torch.kernels.lora import bgmv as bgmod
from repro_torch.kernels.lora import ops
from repro_torch.kernels.lora.ref import bgmv_ref
from repro_torch.models import attention, build_model
from repro_torch.models import model as model_mod

DTYPES = ["float32", "bfloat16", "float16"]
# (Din, douts): MHA (three equal sites), GQA (a wide q, narrow k and v)
SITE_LISTS = {"mha": (32, (32, 32, 32)), "gqa": (40, (48, 16, 16))}


def _inputs(seed, B, C, Din, R, douts, T=4, dtype="float32", bases=True):
    """x, ids (slot 0 and a repeat among them), and per site a, b scaled as
    make_adapter scales them (slot 0 the null adapter) and a random base."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, C, Din)).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    idx = (np.arange(B) * 2 + 1) % T
    idx[0] = 0
    idx[-1] = idx[min(1, B - 1)]
    sites = []
    for dout in douts:
        a = (rng.standard_normal((T, Din, R)) / np.sqrt(Din)).astype(np.float32)
        b = (rng.standard_normal((T, R, dout)) / np.sqrt(R)).astype(np.float32)
        a[0] = 0
        b[0] = 0
        base = torch.from_numpy(rng.standard_normal((B, C, dout)).astype(np.float32))
        sites.append((torch.from_numpy(a), torch.from_numpy(b),
                      base.to(x.dtype) if bases else None))
    return x, torch.from_numpy(idx.astype(np.int64)), sites


# ---------------------------------------------------------------------------
# the plain fused op: equal to the per-site composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sites", list(SITE_LISTS))
@pytest.mark.parametrize("R", [4, 5, 8, 16, 64])
@pytest.mark.parametrize("C", [1, 3, 64])
def test_fused_plain_op_equals_per_site_composition(dtype, sites, R, C):
    Din, douts = SITE_LISTS[sites]
    x, idx, ss = _inputs(R * 100 + C, 3, C, Din, R, douts, dtype=dtype)
    want = [base + bgmv_ref(x, a, b, idx) for a, b, base in ss]
    copies = [(a, b, base.clone()) for a, b, base in ss]
    got = ops.bgmv_add(x, idx, copies)  # int64 ids: the op casts
    for g, w, (_, _, base) in zip(got, want, copies):
        assert g is base  # written in place into the base
        assert g.dtype == x.dtype and torch.equal(g, w)
    null = idx == 0
    for g, (_, _, base) in zip(got, ss):  # slot 0 adds exactly 0
        assert torch.equal(g[null], base[null])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_plain_op_without_bases_returns_the_deltas(dtype):
    x, idx, ss = _inputs(3, 4, 2, 40, 8, (48, 16, 16), dtype=dtype, bases=False)
    got = ops.bgmv_add(x, idx, ss)
    for g, (a, b, _) in zip(got, ss):
        assert g.dtype == x.dtype and torch.equal(g, bgmv_ref(x, a, b, idx))
        assert not g[idx == 0].any()
    assert torch.equal(bgmod.bgmv(x, *ss[0][:2], idx.int()), got[0])


# ---------------------------------------------------------------------------
# the plain fused op vs JAX's bgmv + add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sites", list(SITE_LISTS))
def test_fused_plain_op_matches_jax_bgmv_plus_add(impl, dtype, sites):
    Din, douts = SITE_LISTS[sites]
    x, idx, ss = _inputs(11, 5, 3, Din, 4, douts, dtype=dtype)
    jx = jnp.asarray(x.float().numpy(), dtype)
    want = [np.asarray((jnp.asarray(base.float().numpy(), dtype)
                        + jbgmv(jx, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                jnp.asarray(idx.numpy(), jnp.int32), impl=impl)
                        ).astype(jnp.float32))
            for a, b, base in ss]
    got = ops.bgmv_add(x, idx, [(a, b, base.clone()) for a, b, base in ss])
    for g, w in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
        else:  # one bf16 step apart at most
            np.testing.assert_allclose(g.float().numpy(), w, atol=1e-6, rtol=2 ** -7)


# ---------------------------------------------------------------------------
# the grid plan
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # B, C, Din, R, douts: olmo-1b's q/k/v, w1 and w2 at decode and prefill,
    # qwen2.5-32b's and gemma-2b's q/k/v (GQA, MQA), ragged widths, odd
    # ranks and C, a batch large enough that CTAs expand several passes
    (8, 1, 2048, 8, (2048, 2048, 2048)), (4, 64, 2048, 8, (2048, 2048, 2048)),
    (8, 1, 2048, 8, (16384,)), (4, 64, 2048, 8, (16384,)), (8, 1, 8192, 8, (2048,)),
    (8, 1, 5120, 8, (5120, 1024, 1024)), (4, 17, 2048, 16, (2048, 256, 256)),
    (3, 3, 1030, 5, (1002, 6)), (5, 3, 16, 4, (24,)), (2, 64, 256, 64, (320,)),
    (6, 1, 256, 33, (320, 320)), (128, 64, 2048, 8, (16384,)), (1, 1, 24, 4, (2, 3, 1)),
]


def _covered(p, B, C, Din, douts):
    """How often each (site, b, c, column) is written and each Din index
    is shrunk per (site, cluster, row tile, b), from the plan's CTA list."""
    cols = [np.zeros((B, C, d), np.int64) for d in douts]
    shrunk = {}
    for s, b, c0, c1, n0, n1, d0, d1 in p.tiles(B, C, douts):
        if n0 < n1:
            cols[s][b, c0:c1, n0:n1] += 1
        key = (s, n0 // p.spans[s] // p.cluster, c0, b)  # the CTA's cluster
        row = shrunk.setdefault(key, np.zeros(Din, np.int64))
        row[d0:min(d1, Din)] += 1
    return cols, shrunk


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_covers_every_output_once(case, itemsize):
    B, C, Din, R, douts = case
    p = bgmod.plan(B, C, Din, R, douts, 132, itemsize)
    assert p.rank >= R and p.rank in bgmod.RANKS and p.rows in bgmod.ROW_TILES
    assert bgmod.instance_ok(p.rank, p.rows) and p.row_tiles * p.rows >= C
    assert p.cluster in (1, 2, 4, 8) and all(n % p.cluster == 0 for n in p.ctas)
    assert all(span % 4 == 0 for span in p.spans)
    assert p.d_share % (16 // itemsize) == 0 and p.d_share * p.cluster >= Din
    cols, shrunk = _covered(p, B, C, Din, douts)
    for c in cols:
        assert (c == 1).all()  # every output written by exactly one CTA
    for row in shrunk.values():
        assert (row == 1).all()  # each cluster shrinks all of Din once


@pytest.mark.parametrize("douts", [(16384,), (2048, 2048, 2048), (5120, 1024, 1024)])
@pytest.mark.parametrize("R", [4, 8, 16, 32, 64])
def test_plan_takes_one_row_per_cta_at_decode(douts, R):
    p = bgmod.plan(8, 1, 2048, R, douts, 132, 2)
    assert p.rows == 1 and p.row_tiles == 1
    assert p.cluster == 8 and p.d_share == 256  # A read once per 8 CTAs


def test_plan_expands_several_passes_when_ctas_abound():
    few = bgmod.plan(4, 64, 2048, 8, (16384,), 132, 2)
    many = bgmod.plan(128, 64, 2048, 8, (16384,), 132, 2)
    assert few.spans == (1024,) and few.ctas == (16,) and few.rows == 16
    assert many.rows == 64 and many.ctas == (8,) and many.spans == (2048,)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="rank"):
        bgmod.plan(2, 1, 64, 65, (64,), 132, 2)
    with pytest.raises(ValueError, match="rank"):
        bgmod.plan(2, 1, 64, 0, (64,), 132, 2)
    with pytest.raises(ValueError, match="65535"):
        bgmod.plan(65536, 1, 64, 8, (64,), 132, 2)
    with pytest.raises(ValueError, match="sites"):
        bgmod.plan(2, 1, 64, 8, (64,) * 4, 132, 2)


# ---------------------------------------------------------------------------
# the models' call sites: four launches a layer, logits equal to the
# per-site composition
# ---------------------------------------------------------------------------

def _per_site(x, idx, sites):
    """The composition the call sites made before: one bgmv per site and an
    add, out of place."""
    return [ops.bgmv(x, a, b, idx) if base is None else base + ops.bgmv(x, a, b, idx)
            for a, b, base in sites]


def _lora(cfg, ids):
    lc = LoRAConfig(rank=4, alpha=8.0, max_loaded_adapters=2)
    store = PagedAdapterStore(cfg, lc, BlockManager(64, 8), 1 << 20, device="cpu")
    for j in range(2):
        store.registry.register(f"a{j}", make_adapter(cfg, lc, seed=j + 3))
    store.ensure(["a0", "a1"])
    return {"ids": torch.tensor(ids, dtype=torch.int32), "layers": store.tables}


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-32b"])
def test_model_lora_logits_equal_the_per_site_composition(arch):
    cfg = configs.smoke_config(arch)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    rng = np.random.default_rng(5)
    P, NP, B = 8, 4, 4
    g = torch.Generator().manual_seed(2)
    pages = m.init_pages(B * NP + 1, P)
    for pg in pages:
        for t in pg.values():
            t.copy_(torch.randn(t.shape, generator=g))
    tables = torch.from_numpy(rng.permutation(np.arange(1, B * NP + 1)).reshape(B, NP))
    lora = _lora(cfg, [1, 0, 2, 1])
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, 1)))
    lengths = torch.tensor([0, 5, 17, 30], dtype=torch.int32)
    tokc = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, 6)))
    starts = torch.tensor([0, 5, 17, 20], dtype=torch.int32)
    chunk_lens = torch.tensor([6, 2, 1, 4], dtype=torch.int32)
    calls = []

    def counted(x, idx, sites):
        calls.append(len(sites))
        return ops.bgmv_add(x, idx, sites)

    def run(step, *args):
        fresh = [{n: t.clone() for n, t in pg.items()} for pg in pages]
        return getattr(m, step)(params, args[0], fresh, tables, *args[1:], lora=lora)[0]

    for step, args in (("decode_paged", (tok, lengths)),
                       ("extend_paged", (tokc, starts, chunk_lens, 0))):
        calls.clear()
        with mock.patch.object(attention, "bgmv_add", counted), \
                mock.patch.object(model_mod, "bgmv_add", counted):
            fused = run(step, *args)
        assert calls == [3, 1, 1, 1] * cfg.num_layers  # q/k/v together, wo, w1, w2
        with mock.patch.object(attention, "bgmv_add", _per_site), \
                mock.patch.object(model_mod, "bgmv_add", _per_site):
            composed = run(step, *args)
        assert torch.equal(fused, composed)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma-2b", "qwen2.5-32b"])
def test_projections_are_contiguous_for_the_epilogue(arch):
    cfg = configs.smoke_config(arch)
    m = build_model(cfg, device="cpu")
    p = m.init(0)["layers"][0]["mixer"]
    x = torch.randn(3, 5, cfg.d_model).to(m.dtype)
    for name in ("wq", "wk", "wv"):
        assert attention.proj_qkv(p[name], x).is_contiguous()
    h = torch.randn(3, 5, cfg.num_heads, cfg.head_dim).to(m.dtype)
    for t in (h, h.transpose(1, 2).contiguous().transpose(1, 2)):
        assert attention.proj_out(p["wo"], t).is_contiguous()


def test_all_rank_instances_and_row_tiles_are_planned():
    """Every (rank instance, rows) pair the kernel instantiates is one the
    plan can pick, and no other: rows * rank <= 512, at most 4 rows at
    rank 32 and 64."""
    seen = set()
    for R, C in itertools.product(range(1, 65), (1, 2, 3, 5, 9, 17, 33, 64)):
        p = bgmod.plan(2, C, 64, R, (64,), 1, 2)
        seen.add((p.rank, p.rows))
    assert seen == {(r, t) for r in bgmod.RANKS for t in bgmod.ROW_TILES
                    if bgmod.instance_ok(r, t)}
