"""The port's xLSTM mixers (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``) on the CPU.

The same parameters (JAX's ``make_mlstm_params`` / ``make_slstm_params``
at the xlstm-1.3b smoke width, f32, converted to tensors) and the same
numpy-seeded inputs go through both. mLSTM: a whole sequence of S = 128
(the chunkwise-parallel branch: S >= 128 and S % 64 == 0) and of S = 40
(the recurrence), and a continuation from the carried state (chunks of
128, 1 and 39: both branches and the one-token decode); sLSTM: a whole
sequence and chunks of 7, 1 and 16. Outputs and every carried state leaf
(conv window, C, n, m; c, n, h, m) agree within ``ATOL`` (f32, sums in
another order). In the port alone the chunkwise form equals the
recurrence on the same inputs, and an empty history is the init state
with ``m = -1e30``. ``convert_params`` places the mLSTM and sLSTM trees
(``w_if`` with its bias, ``head_norm``, ``r``, ``group_norm``, ``ffn_*``).
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
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import split_params  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ATOL = 1e-5  # f32, summation order only
NAME = "xlstm-1.3b"
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.fixture(scope="module")
def cfg():
    return jsmoke_config(NAME)


@pytest.fixture(scope="module")
def mlstm(cfg):
    jp, _ = split_params(jxlstm.make_mlstm_params(jax.random.PRNGKey(5), cfg,
                                                  jnp.float32))
    return jp, _t(jp)


@pytest.fixture(scope="module")
def slstm(cfg):
    jp, _ = split_params(jxlstm.make_slstm_params(jax.random.PRNGKey(6), cfg,
                                                  jnp.float32))
    return jp, _t(jp)


def _x(cfg, S, seed=0):
    return (0.5 * np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
            ).astype(np.float32)


def _close(tstate, jstate):
    assert set(tstate) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), atol=ATOL,
                                   err_msg=k)


def _chunks(fwd_j, fwd_t, jp, tp, cfg, x, cuts, jinit, tinit):
    js, ts = jinit, tinit
    jo, to = [], []
    for lo, hi in cuts:
        y, js = fwd_j(jp, cfg, jnp.asarray(x[:, lo:hi]), state=js, return_state=True)
        jo.append(np.asarray(y))
        y, ts = fwd_t(tp, cfg, torch.from_numpy(x[:, lo:hi]), state=ts)
        to.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(to, 1), np.concatenate(jo, 1), atol=ATOL)
    _close(ts, js)


@pytest.mark.parametrize("S", [128, 40], ids=["chunkwise", "recurrence"])
def test_mlstm_forward_matches_jax(cfg, mlstm, S):
    jp, tp = mlstm
    x = _x(cfg, S)
    jy, js = jxlstm.mlstm_forward(jp, cfg, jnp.asarray(x), return_state=True)
    ty, ts = txlstm.mlstm_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    _close(ts, js)


def test_mlstm_continuation_matches_jax(cfg, mlstm):
    """128 tokens (chunkwise), one (decode), 39 (recurrence) from the
    carried state."""
    jp, tp = mlstm
    _chunks(jxlstm.mlstm_forward, txlstm.mlstm_forward, jp, tp, cfg, _x(cfg, 168, 1),
            ((0, 128), (128, 129), (129, 168)),
            jxlstm.init_mlstm_cache(cfg, B, jnp.float32),
            txlstm.init_mlstm_cache(cfg, B, torch.float32, "cpu"))


def test_mlstm_chunkwise_equals_recurrence(cfg, mlstm):
    """The two forms of the same recurrence, from a non-empty state."""
    _, tp = mlstm
    H, dh = cfg.num_heads, txlstm.mlstm_d_inner(cfg) // cfg.num_heads
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(B, 192, H, dh, generator=g) for _ in range(3))
    ig = torch.randn(B, 192, H, generator=g)
    fg = torch.nn.functional.logsigmoid(torch.randn(B, 192, H, generator=g) + 2)
    s0 = (torch.randn(B, H, dh, dh, generator=g), torch.randn(B, H, dh, generator=g),
          torch.randn(B, H, generator=g))
    hc, sc = txlstm.mlstm_chunkwise(q, k, v, ig, fg, s0)
    hr, sr = txlstm.mlstm_recurrence(q, k, v, ig, fg, s0)
    # from a random state the outputs reach O(30) and the carried C O(100):
    # f32 sums in another order, held to 1e-4 absolute and relative
    for a, b in zip((hc,) + sc, (hr,) + sr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


def test_empty_history_is_the_init_state(cfg, mlstm, slstm):
    x = torch.from_numpy(_x(cfg, 40))
    for (_, tp), fwd, init in ((mlstm, txlstm.mlstm_forward, txlstm.init_mlstm_cache),
                               (slstm, txlstm.slstm_forward, txlstm.init_slstm_cache)):
        st = init(cfg, B, torch.float32, "cpu")
        assert (st["m"] == -1e30).all()
        assert all((v == 0).all() for k, v in st.items() if k != "m")
        a, sa = fwd(tp, cfg, x)
        b, sb = fwd(tp, cfg, x, state=st)
        assert torch.equal(a, b) and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_slstm_forward_matches_jax(cfg, slstm):
    jp, tp = slstm
    x = _x(cfg, 24, 3)
    jy, js = jxlstm.slstm_forward(jp, cfg, jnp.asarray(x), return_state=True)
    ty, ts = txlstm.slstm_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    _close(ts, js)


def test_slstm_continuation_matches_jax(cfg, slstm):
    jp, tp = slstm
    _chunks(jxlstm.slstm_forward, txlstm.slstm_forward, jp, tp, cfg, _x(cfg, 24, 4),
            ((0, 7), (7, 8), (8, 24)),
            jxlstm.init_slstm_cache(cfg, B, jnp.float32),
            txlstm.init_slstm_cache(cfg, B, torch.float32, "cpu"))


def test_convert_params_places_the_xlstm_layers():
    _, _, values = bcommon.small_model(NAME)
    tcfg = tconfigs.smoke_config(NAME)
    params = convert_params(tcfg, values)
    m, s = params["layers"]
    assert [sp.mixer for sp in tcfg.layer_specs()] == ["mlstm", "slstm"]
    assert set(m) == set(s) == {"norm1", "mixer"}  # ff "none": no norm2, no ff
    assert set(m["mixer"]["w_if"]) == {"w", "b"}
    assert set(m["mixer"]["head_norm"]) == {"scale", "bias"}
    assert set(s["mixer"]) == {"wx", "r", "group_norm", "ffn_up", "ffn_down"}
    H, d = tcfg.num_heads, tcfg.d_model
    assert tuple(s["mixer"]["r"].shape) == (H, d // H, 4 * d // H)
    np.testing.assert_array_equal(
        s["mixer"]["r"].numpy(), np.asarray(values["stages"][0]["l1"]["mixer"]["r"])[0])
