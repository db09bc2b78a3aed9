"""Tensor-parallel training of the xLSTM's mLSTM and sLSTM, whisper's
encoder and cross-attention, and internvl on the CPU against the JAX
package's single-device step; the model group's collectives per layer of
every family this slice reaches; a sharded checkpoint through the xLSTM's
column orders.

Two worlds run while this process runs JAX's steps
(``test_torch_sharded_train_mla.py::jax_family``, at the tolerances stated
there; rank-side work in ``tests/_torch_sharded_train_ranks.py``, no JAX):

* 2 ranks on (data 1, model 2): xlstm-1.3b (the mLSTM's [xin ; z] and the
  sLSTM's gate-major ``wx`` in their orders, the sLSTM's ``ffn_up`` at 2 x
  341 columns gathered where it is used), whisper-base (encoder layers,
  cross-attention, learned positions, a cut vocabulary of 512 tied to the
  embedding) and internvl2-2b (image rows after the vocab-parallel
  embedding) train ``TP_STEPS`` steps: each step's metrics, the first
  step's gradient and the final params equal JAX's; each rank holds its
  slices only. The same world counts the model group's collectives of one
  layer forward and backward for all five families.
* 4 ranks on (data 2, model 2): xlstm-1.3b again, held alike, and its
  seed-0 slices saved through the mesh (the one-process save byte for
  byte) and restored onto it.
"""
import concurrent.futures
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_sharded_train_ranks as ranks  # noqa: E402
from test_torch_sharded_train_mla import hold_family, references  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.xlstm import slstm_ffn_cut  # noqa: E402

ARCHS = ranks.MIXER_ARCHS
XLSTM = "xlstm-1.3b"

# The model group's collectives (all-reduces, all-gathers, reduce-scatters)
# of each part of a layer at a model axis of 2, forward and backward. The
# forward's are the all-reduces that complete a partial sum
# (``reduce_from_model``), the reduce-scatter of the mLSTM's q/k/v/gates
# and the sLSTM's gathers; the backward's are the all-reduces of every
# ``copy_to_model`` (x into the rank's heads or units, and the whole
# tensors and leaves a rank uses in part) and the all-gather that undoes
# the reduce-scatter.
PARTS = {
    # x into q and the cut K/V heads; after wo
    "attn": ((1, 0, 0), (1, 0, 0)),
    # after wo; the query latent, c_kv, the roped shared key
    "mla": ((1, 0, 0), (3, 0, 0)),
    # after x_proj and out_proj; x, (dt, B, C)
    "mamba": ((2, 0, 0), (2, 0, 0)),
    # after down_proj, q/k/v/gates scattered; x, w_if's bias, head_norm's
    # scale and bias, the scatter's gather
    "mlstm": ((1, 0, 1), (4, 1, 0)),
    # the states gathered; x, r, and the FFN's ("pairs": the normed states
    # in, its output out; "gather": ffn_up gathered, no all-reduce)
    "slstm": ((0, 1, 0), (2, 0, 0)),
    "slstm pairs": ((1, 0, 0), (1, 0, 0)),
    "slstm gather": ((0, 1, 0), (0, 0, 0)),
    # after w2; x
    "mlp": ((1, 0, 0), (1, 0, 0)),
    # after the experts and the shared expert; x and the routing weights
    "moe": ((1, 0, 0), (2, 0, 0)),
    # after wo; x into q, the encoder states into the cut K/V heads
    "cross": ((1, 0, 0), (2, 0, 0)),
    "none": ((0, 0, 0), (0, 0, 0)),
}


def layer_formula(cfg, mixer, ff, cross=False):
    """(forward, backward) collectives of one layer, from ``PARTS``."""
    names = [mixer, ff] + (["cross"] if cross else [])
    if mixer == "slstm":
        names.append("slstm " + slstm_ffn_cut(cfg, 2))
    fwd = tuple(sum(PARTS[n][0][i] for n in names) for i in range(3))
    bwd = tuple(sum(PARTS[n][1][i] for n in names) for i in range(3))
    return fwd, bwd


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("xlstm_ckpt"))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        two = ex.submit(spawn_ranks, ranks.mixer_cases, 2, ARCHS, timeout=600)
        four = ex.submit(spawn_ranks, ranks.xlstm_mesh_cases, 4, tmp, timeout=600)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            want = references(ARCHS)
            cfg = tconfigs.smoke_config(XLSTM)
            save_checkpoint(os.path.join(tmp, "xlstm_single.npz"),
                            build_model(cfg, device="cpu").init(0), step=2)
        finally:
            torch.set_num_threads(n)
        got2, got4 = two.result(), four.result()
    return dict(got2=got2, got4=got4, want=want, tmp=tmp)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_matches_jax(runs, arch):
    """(data 1, model 2): every step's metrics, the first step's gradient
    and the final params equal JAX's single-device step; each rank holds
    its slices only."""
    hold_family(runs["got2"], runs["want"][arch], arch, ranks.TP_MESH)


def test_xlstm_data_and_model_axes_match_jax(runs):
    """(data 2, model 2): xlstm's slices cut over both axes, the batch over
    data: the same as JAX's single-device step."""
    hold_family(runs["got4"], runs["want"][XLSTM], XLSTM, ranks.MESH)


def test_xlstm_checkpoint_round_trip(runs):
    """The save through the (2, 2) mesh (every order undone) writes the
    one-process save of the same params, byte for byte; the restore gives
    every rank its slices."""
    with np.load(os.path.join(runs["tmp"], "xlstm_sharded.npz")) as a, \
            np.load(os.path.join(runs["tmp"], "xlstm_single.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert np.array_equal(a[k], b[k]), k
    for rank in runs["got4"]:
        assert rank["checkpoint"] == {"restored_equal": True, "step": 2}


@pytest.mark.parametrize("arch", ranks.MLA_ARCHS + ARCHS)
def test_layer_collectives_match_formula(runs, arch):
    """Each layer's collectives over the model group, forward and backward,
    are ``layer_formula``'s on both ranks: MLA 1 all-reduce forward, Mamba
    2, the mLSTM 1 and a reduce-scatter, the sLSTM an all-gather of its
    states and its FFN's, a whisper decoder layer 3 (self, cross, MLP), an
    encoder layer 2; the backward's one per ``copy_to_model``."""
    cfg = tconfigs.smoke_config(arch)
    for rank in runs["got2"]:
        got = rank["layer_collectives"][arch]
        for row in got["layers"]:
            want = layer_formula(cfg, *row["spec"], cross=cfg.family == "audio")
            assert (tuple(row["forward"]), tuple(row["backward"])) == want, (row, want)
        if cfg.family == "audio":
            enc = got["encoder"]
            fwd, bwd = layer_formula(cfg, *enc["spec"])
            n = enc["layers"]
            assert tuple(enc["forward"]) == tuple(n * c for c in fwd), enc
            assert tuple(enc["backward"]) == tuple(n * c for c in bwd), enc
