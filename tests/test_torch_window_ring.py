"""The window ring of the port's contiguous decode, on the CPU: the twin of
``tests/test_window_ring.py``. starcoder2-3b's smoke config (window 16)
decodes 40 tokens at B=2 into a 24-slot ring (window 16 + headroom,
wrapped after step 24) under the rules' "window_ring" option, and matches
JAX's plain decode into a 128-slot contiguous cache at every step within
the reference test's bound. ``init_cache(..., window_ring=True)`` gives a
window layer ``min(max_seq, sliding_window + 512)`` slots; ``extend``
refuses a ring, ``decode`` refuses one without the option, and a row
whose position falls past a plain cache raises (the reference's scatter
drops the write).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.models.model import RingCache  # noqa: E402
from repro_torch.sharding.rules import Rules, use_rules  # noqa: E402

ARCH = "starcoder2-3b"
ATOL = 2e-4  # tests/test_window_ring.py's bound
B, STEPS = 2, 40
RING = Rules({}, options={"window_ring": True})


def _model():
    cfg = tconfigs.smoke_config(ARCH)
    return build_model(cfg, device="cpu")


def test_ring_decode_matches_jax_full_cache():
    jcfg, jm, values = bcommon.small_model(ARCH)
    assert jcfg.sliding_window == 16
    tm = _model()
    params = convert_params(tm.cfg, jax.device_get(values))
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, jcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
    cache = jm.init_cache(B, 128)
    dec = jax.jit(jm.decode)
    ref = []
    for t in range(STEPS):
        lg, cache = dec(values, jnp.asarray(tokens[:, t:t + 1]), cache,
                        jnp.full((B,), t, jnp.int32))
        ref.append(np.asarray(lg[:, 0]))
    ring = tm.init_cache(B, 24, window_ring=True)
    assert isinstance(ring, RingCache) and ring[0]["k"].shape == (B, 24, 2, 64)
    with use_rules(RING):
        for t in range(STEPS):
            lg, ring = tm.decode(params, torch.from_numpy(tokens[:, t:t + 1]), ring,
                                 torch.full((B,), t))
            np.testing.assert_allclose(lg[:, 0].numpy(), ref[t], atol=ATOL,
                                       err_msg=f"step {t}")
    assert isinstance(ring, RingCache)


@pytest.mark.parametrize("max_seq,width", [(24, 24), (128, 128), (4096, 528)])
def test_ring_leaf_width(max_seq, width):
    """A window layer holds min(max_seq, window + 512) slots, as the
    reference's ``_layer_cache``; without the flag the cache is whole."""
    tm = _model()
    ring = tm.init_cache(1, max_seq, window_ring=True)
    assert [c["k"].shape[1] for c in ring] == [width] * len(ring)
    assert [c["k"].shape[1] for c in tm.init_cache(1, max_seq)] == [max_seq] * len(ring)


def test_ring_refusals():
    tm = _model()
    params = tm.init(0)
    ring = tm.init_cache(1, 24, window_ring=True)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="ring"):
        tm.extend(params, tok, ring, torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="window_ring"):
        tm.decode(params, tok, ring, torch.zeros(1, dtype=torch.long))
    with pytest.raises(IndexError, match="past its 24-slot cache"):
        tm.decode(params, tok, tm.init_cache(1, 24), torch.full((1,), 24))
    with use_rules(RING):  # a ring takes any position
        lg, _ = tm.decode(params, tok, ring, torch.full((1,), 1000))
    assert torch.isfinite(lg).all()
