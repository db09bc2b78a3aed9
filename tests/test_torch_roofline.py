"""The port's analytic roofline (``repro_torch.launch.roofline``) vs the JAX
package's ``repro.launch.roofline``, on the CPU.

The parameter counts equal JAX's for every config the port holds, smoke and
published, but for whisper's cross-attention and learned positions, which
the reference's count leaves out. ``decode_step_bound`` keeps the reference's formula with the card
as a parameter: given a card row that carries the reference's TPU v5e
constants (197e12 FLOP/s, 819e9 B/s, two 50e9 B/s links), it equals JAX's
value key by key. Mixers and feed-forwards the port does not hold raise.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro_torch import configs as tconfigs
from repro_torch.launch import roofline

V5E = roofline.Card("v5e", hbm_bw=819e9, fp32_flops=19.7e12, bf16_flops=197e12,
                    link_bw=2 * 50e9)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_counts_match_jax(arch, smoke):
    """Equal to JAX's count, but for what the reference leaves out of
    whisper's: each decoder layer's cross-attention and the learned
    position table (tests/test_torch_whisper.py)."""
    get = "smoke_config" if smoke else "get_config"
    cfg = getattr(tconfigs, get)(arch)
    got = roofline.param_counts(cfg)
    want = jroofline.param_counts(getattr(jconfigs, get)(arch))
    extra = cfg.learned_positions * cfg.d_model + (cfg.num_layers * (
        2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim)
        if cfg.encoder_layers else 0)
    assert got == {k: v + extra for k, v in want.items()}


def test_olmo_1b_parameter_count():
    # tied embeddings: 1.177 B parameters, 2.35 GB in bf16
    n = roofline.param_counts(tconfigs.get_config("olmo-1b"))
    assert n["total"] == n["active"] == 1_176_764_416


@pytest.mark.parametrize("kw", [dict(), dict(kv_sharded=False), dict(ff_sharded=True),
                                dict(dtype_bytes=4, kv_dtype_bytes=1)])
@pytest.mark.parametrize("model_shards", [1, 4])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-32b", "llama4-scout-17b-a16e"])
def test_decode_step_bound_matches_jax_on_v5e_constants(arch, model_shards, kw):
    for batch, seq_len in ((1, 16), (8, 1024), (64, 4096)):
        got = roofline.decode_step_bound(tconfigs.get_config(arch), batch=batch,
                                         seq_len=seq_len, model_shards=model_shards,
                                         card=V5E, **kw)
        want = jroofline.decode_step_bound(jconfigs.get_config(arch), batch=batch,
                                           seq_len=seq_len, model_shards=model_shards,
                                           **kw)
        assert got == want


def test_default_card_is_the_sxm_h100():
    cfg = tconfigs.get_config("olmo-1b")
    card = roofline.card_for(roofline.H100_SXM)
    assert card.name == "H100" and card.hbm_bw == 3.35e12 and card.bf16_flops == 989e12
    assert card.link_bw == 900e9
    out = roofline.decode_step_bound(cfg, batch=8, seq_len=1024)
    assert out == roofline.decode_step_bound(cfg, batch=8, seq_len=1024, card=card)
    # 2.35 GB of weights + 1.07 GB of K and V (16 layers x 2048 x 1024 slots x
    # 8 rows) at 3.35 TB/s: memory-bound, 1.02 ms a step
    assert out["t_memory_s"] > out["t_compute_s"] and out["t_collective_s"] == 0.0
    assert out["t_memory_s"] == (2 * 1_176_764_416 + 2 ** 30) / 3.35e12
    assert 7800 < out["tokens_per_s"] < 7850


def test_card_rows_by_device_name():
    assert roofline.card_for("NVIDIA H100 PCIe").name == "H100 PCIe"
    assert roofline.card_for("NVIDIA H100 NVL").name == "H100 NVL"
    assert roofline.card_for("NVIDIA H200").name == "H200"
    with pytest.raises(ValueError, match="A100"):
        roofline.card_for("NVIDIA A100-SXM4-80GB")
    pcie = roofline.card_for("NVIDIA H100 PCIe")
    with pytest.raises(ValueError, match="link bandwidth"):
        roofline.decode_step_bound(tconfigs.get_config("olmo-1b"), batch=1, seq_len=16,
                                   model_shards=2, card=pcie)


def test_unported_kinds_raise():
    cfg = tconfigs.get_config("olmo-1b")
    spec = cfg.stages[0][0][0]
    # every mixer and feed-forward of the reference's configs is counted
    # (state mixers and ff "none" since the port serves them): a kind that
    # names none of them raises
    for change, name in ((dict(mixer="hyena"), "hyena"), (dict(ff="dense2"), "dense2")):
        bad = dataclasses.replace(cfg, stages=(((dataclasses.replace(spec, **change),), 1),))
        with pytest.raises(ValueError, match=repr(name)):
            roofline.param_counts(bad)
