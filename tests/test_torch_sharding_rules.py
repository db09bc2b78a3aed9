"""The port's sharding rules, TP layouts and TP branches vs the JAX package.

* ``repro_torch.sharding.Rules.pspec`` against JAX's ``repro.sharding.Rules``
  over the cases of ``tests/test_sharding_rules.py`` and the serving rules
  (JAX's ``pspec`` reads only ``mesh.shape``, so both get a shape dict).
* The replicated-KV head order and the GLU column order of ``tp_layout``
  against the reference's closed forms (``repro/core/executor/
  sharded.py``) for MHA, GQA (40 heads over 8 KV heads, 6 over 3), MQA and
  a GLU MLP, and the properties they exist for.
* Each parameter leaf's logical axes (``models.model.param_axes``) against
  JAX's ``param_axes_tree``, carried through the weight converter, for
  every smoke config (MoE, MLA, Mamba, xLSTM, whisper's encoder and
  cross-attention, learned positions, the MTP block included).
* ``proj_out_lora`` and ``mlp_apply`` over 2 gloo ranks on the CPU (each
  rank its heads / hidden units, bias and LoRA deltas included) against
  the single-device result, within 1e-5 in f32 (summation order only).
* The decode roofline's collective term under a model axis: the card's
  NVLink rate.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_sharded_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.common import is_param  # noqa: E402
from repro.sharding import Rules as JRules  # noqa: E402
from repro.sharding import serving_tp_rules as jserving_tp_rules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.executor.sharded import paged_layout, tp_layout  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.launch.roofline import card_for, decode_step_bound, H100_SXM  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.models.model import mlp_apply, param_axes  # noqa: E402
from repro_torch.sharding import Rules, serving_tp_rules  # noqa: E402


class FakeMesh:
    """JAX's ``Rules.pspec`` only consults ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


# (mesh shape, logical axes, dims): tests/test_sharding_rules.py's cases
PSPEC_CASES = [
    (dict(data=16, model=16), ("batch", None, "vocab"), (256, 4096, 129280)),
    (dict(pod=2, data=16, model=16), ("batch",), (256,)),
    (dict(data=16, model=16), ("batch", None, "kv_heads", None), (128, 32776, 8, 128)),
    (dict(data=16, model=16), ("batch", None, "kv_heads", None), (128, 32776, 16, 128)),
    (dict(pod=2, data=16, model=16), ("batch",), (16,)),
    (dict(data=16, model=16), ("heads", "ff"), (32, 4096)),
    (dict(data=16, model=16), (None, "nonexistent"), (4, 4)),
    (dict(data=16, model=16), ("batch",), (256,)),
    (dict(data=2, model=4), ("embed", "heads", None), (256, 4, 64)),
    (dict(data=1, model=5), ("heads", None, "embed"), (40, 128, 5120)),
]


@pytest.mark.parametrize("shape,axes,dims", PSPEC_CASES)
def test_pspec_matches_jax(shape, axes, dims):
    want = tuple(JRules(FakeMesh(shape)).pspec(axes, dims))
    assert Rules(shape).pspec(axes, dims) == want


@pytest.mark.parametrize("kv_sharded,ff_sharded", [(True, True), (False, True), (True, False),
                                                   (False, False)])
def test_serving_rules_match_jax(kv_sharded, ff_sharded):
    shape = dict(data=2, model=4)
    r = serving_tp_rules(shape, kv_sharded=kv_sharded, ff_sharded=ff_sharded)
    jr = jserving_tp_rules(FakeMesh(shape), kv_sharded=kv_sharded, ff_sharded=ff_sharded)
    for axes, dims in [(("embed", "heads", None), (256, 8, 64)),
                       (("embed", "kv_heads", None), (256, 4, 64)),
                       (("embed", "ff"), (256, 1024)), (("ff", "embed"), (512, 256)),
                       (("vocab", "embed"), (512, 256)), (("batch", None), (8, 3))]:
        assert r.pspec(axes, dims) == tuple(jr.pspec(axes, dims)), axes


def test_pspec_rank_mismatch_raises():
    with pytest.raises(ValueError, match="do not match"):
        Rules(dict(model=2)).pspec(("heads",), (4, 4))


# ---------------------------------------------------------------------------
# head and GLU orders
# ---------------------------------------------------------------------------

def _cfg(H, KV, hd=8, f=16, activation="silu_glu"):
    return dataclasses.replace(tconfigs.smoke_config("olmo-1b"), num_heads=H,
                               num_kv_heads=KV, head_dim=hd, d_ff=f, activation=activation)


def _closed_head_order(H, KV, mp):
    """``repro/core/executor/sharded.py``'s loop."""
    G, Hl = H // KV, H // mp
    Gl = G // mp
    order = np.empty(H, np.int64)
    for i in range(mp):
        for g in range(KV):
            for t in range(Gl):
                order[i * Hl + g * Gl + t] = g * G + i * Gl + t
    return order


@pytest.mark.parametrize("H,KV,mp,kv_sharded,permuted", [
    (16, 16, 4, True, False),   # MHA: KV heads shard, contiguous split
    (40, 8, 2, True, False),    # qwen2.5-32b: KV divides the axis
    (40, 8, 5, False, True),    # qwen2.5-32b over 5: replicated KV, permuted
    (6, 3, 2, False, True),     # the smoke fallback
    (8, 1, 2, False, False),    # MQA: the order is the identity
    (8, 1, 4, False, False),
])
def test_head_order_matches_closed_form(H, KV, mp, kv_sharded, permuted):
    hd = 8
    lay = tp_layout(_cfg(H, KV, hd), mp)
    assert lay.kv_sharded == kv_sharded
    assert (lay.head_order is not None) == permuted
    if not permuted:
        return
    order = lay.head_order
    np.testing.assert_array_equal(order, _closed_head_order(H, KV, mp))
    assert sorted(order.tolist()) == list(range(H))
    # rank i's local head l reads local KV head l // (G / mp), the KV head
    # the global head order[i * Hl + l] reads: h // G
    G, Hl = H // KV, H // mp
    for i in range(mp):
        for l in range(Hl):
            assert l // (G // mp) == order[i * Hl + l] // G
    np.testing.assert_array_equal(lay.head_order_blocked,
                                  (order[:, None] * hd + np.arange(hd)).reshape(-1))
    assert (lay.local_cfg.num_heads, lay.local_cfg.num_kv_heads) == (H // mp, KV)


@pytest.mark.parametrize("activation,glu", [("silu_glu", True), ("gelu", False)])
def test_glu_order_matches_closed_form(activation, glu):
    f, mp = 12, 3
    lay = tp_layout(_cfg(6, 6, f=f, activation=activation), mp)
    assert lay.ff_sharded and lay.local_cfg.d_ff == f // mp and lay.local_cfg.tp_ff_sharded
    if not glu:
        assert lay.glu_order is None
        return
    fl = f // mp
    want = np.concatenate([np.concatenate([np.arange(i * fl, (i + 1) * fl),
                                           f + np.arange(i * fl, (i + 1) * fl)])
                           for i in range(mp)])
    np.testing.assert_array_equal(lay.glu_order, want)
    # rank i's block of the permuted 2f columns: its units' up, then gate
    for i in range(mp):
        block = lay.glu_order[i * 2 * fl:(i + 1) * 2 * fl]
        np.testing.assert_array_equal(block[:fl], np.arange(i * fl, (i + 1) * fl))
        np.testing.assert_array_equal(block[fl:], f + np.arange(i * fl, (i + 1) * fl))


def test_indivisible_heads_raise():
    """Heads that do not divide the model axis: the sharded paged runner's
    layout raises the reference's error; ``tp_layout`` itself keeps them
    whole on every rank (the divisibility rule of the train and step
    plans)."""
    with pytest.raises(ValueError, match="num_heads=6 is not divisible by the model axis"):
        paged_layout(_cfg(6, 6), 4)
    lay = tp_layout(_cfg(6, 6), 4)
    assert not lay.heads_cut and {"heads", "kv_heads"} <= set(lay.whole)
    assert lay.layer_cfg.num_heads == 6 and lay.head_order is None


# ---------------------------------------------------------------------------
# leaf axes against JAX's, through the converter
# ---------------------------------------------------------------------------

AXIS_NAMES = [None, "layers", "vocab", "embed", "heads", "kv_heads", "ff", "experts",
              "moe_ff", "rank", "ssm_inner", "lstm_inner", "conv", "state"]


def _encode(p):
    """A JAX Param's axes as integer codes in the value's layout: a stacked
    stage leaf (R, ...) gives one row of codes per repeat, which the
    converter then unstacks as it unstacks the weights."""
    codes = np.asarray([AXIS_NAMES.index(a) for a in p.axes], np.int64)
    if p.axes and p.axes[0] == "layers":
        return np.tile(codes[1:], (p.value.shape[0], 1))
    return codes


def _decode(tree):
    if isinstance(tree, dict):
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v) for v in tree]
    return tuple(AXIS_NAMES[i] for i in tree.tolist())


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-32b", "gemma-2b"] + [
    a for a in jconfigs.ARCHS if a not in ("olmo-1b", "qwen2.5-32b", "gemma-2b")])
def test_param_axes_match_jax(arch):
    jparams = jax.eval_shape(lambda: jbuild(jconfigs.smoke_config(arch)).init(
        jax.random.PRNGKey(0), max_seq=64))
    codes = jax.tree.map(_encode, jparams, is_leaf=is_param)
    cfg = tconfigs.smoke_config(arch)
    assert param_axes(cfg) == _decode(convert_params(cfg, codes))


# ---------------------------------------------------------------------------
# proj_out_lora and mlp_apply over 2 ranks
# ---------------------------------------------------------------------------

def test_tp_branches_equal_single_device():
    """Each rank's partial product plus its LoRA delta, one all-reduce, then
    the bias: equal to the single-device order (bias, then delta) within
    f32 summation order, on both ranks; one all-reduce per branch."""
    r = np.random.default_rng(0)
    B, C, H, hd, d, f, T, R = 3, 2, 4, 8, 32, 24, 3, 4

    def n(*shape, scale=1.0):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    inputs = dict(x_attn=n(B, C, H, hd), wo_w=n(H, hd, d, scale=0.2), wo_b=n(d),
                  wo_a=n(T, H * hd, R, scale=0.2), wo_bb=n(T, R, d, scale=0.5),
                  x_mlp=n(B, C, d), w1_w=n(d, 2 * f, scale=0.2), w1_b=n(2 * f),
                  w1_a=n(T, d, R, scale=0.2), w1_bb=n(T, R, 2 * f, scale=0.5),
                  w2_w=n(f, d, scale=0.2), w2_b=n(d), w2_a=n(T, f, R, scale=0.2),
                  w2_bb=n(T, R, d, scale=0.5),
                  ids=np.asarray([0, 2, 1], np.int32))
    for k in ("wo_a", "wo_bb", "w1_a", "w1_bb", "w2_a", "w2_bb"):
        inputs[k][0] = 0  # slot 0: the null adapter
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    ids = t["ids"]
    want_attn = attention.proj_out_lora(
        {"w": t["wo_w"], "b": t["wo_b"]}, t["x_attn"],
        {"wo": {"a": t["wo_a"], "b": t["wo_bb"]}}, ids).numpy()
    cfg = dataclasses.replace(tconfigs.smoke_config("olmo-1b"), d_ff=f)
    want_mlp = mlp_apply({"w1": {"w": t["w1_w"], "b": t["w1_b"]},
                          "w2": {"w": t["w2_w"], "b": t["w2_b"]}}, cfg, t["x_mlp"],
                         {"w1": {"a": t["w1_a"], "b": t["w1_bb"]},
                          "w2": {"a": t["w2_a"], "b": t["w2_bb"]}}, ids).numpy()
    for got_attn, got_mlp, n_reduces, nbytes in spawn_ranks(ranks.tp_branches, 2, inputs,
                                                            timeout=120):
        np.testing.assert_allclose(got_attn, want_attn, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got_mlp, want_mlp, atol=1e-5, rtol=0)
        assert n_reduces == 2 and nbytes == 2 * B * C * d * 4


def test_shard_local_model_needs_its_group():
    """A model built from a shard-local config refuses to run without the
    rank's model group (its all-reduces would be skipped)."""
    lay = tp_layout(tconfigs.smoke_config("olmo-1b"), 2)
    model = build_model(lay.local_cfg, device="cpu")
    pages = model.init_pages(4, 8)
    with pytest.raises(ValueError, match="model group is missing"):
        model.decode_paged(model.init(0), torch.zeros((1, 1), dtype=torch.long), pages,
                           torch.zeros((1, 1), dtype=torch.long),
                           torch.zeros((1,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the decode roofline under a model axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ff_sharded", [False, True])
def test_roofline_collective_uses_nvlink(ff_sharded):
    """decode_step_bound's collective term at a model axis of 2 is the ring
    all-reduce payload over the card's NVLink rate (900 GB/s on the SXM
    H100), one per attention layer plus one per MLP when ff shards."""
    cfg = tconfigs.get_config("qwen2.5-32b")
    card = card_for(H100_SXM)
    assert card.link_bw == 900e9
    out = decode_step_bound(cfg, batch=8, seq_len=1024, model_shards=2,
                            ff_sharded=ff_sharded, card=card)
    n = cfg.num_layers * (2 if ff_sharded else 1)
    payload = 2.0 * (2 - 1) / 2 * 8 * cfg.d_model * 2
    assert out["t_collective_s"] == pytest.approx(n * payload / 900e9, rel=1e-12)


def test_param_axes_refuse_moe():
    """``param_axes`` no longer refuses a MoE layer (expert parallelism is
    ported): its leaves take the reference's axes (``repro/models/moe.py``:
    the router's input over "embed", the experts over "experts", the
    shared expert as a dense MLP), and the serving runner's rules split
    none of the routed leaves."""
    cfg = tconfigs.smoke_config("llama4-scout-17b-a16e")
    ff = param_axes(cfg)["layers"][0]["ff"]
    assert ff == {"router": {"w": ("embed", None)}, "w1": ("experts", "embed", "moe_ff"),
                  "w2": ("experts", "moe_ff", "embed"), "shared_w1": {"w": ("embed", "ff")},
                  "shared_w2": {"w": ("ff", "embed")}}
    rules = serving_tp_rules({"data": 1, "model": 2}, kv_sharded=True, ff_sharded=False)
    assert rules.pspec(ff["w1"], (4, 256, 512)) == (None, None, None)
