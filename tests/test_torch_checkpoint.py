"""The port's checkpoints and serving-state log, on the CPU.

``save_checkpoint`` / ``load_checkpoint``: an f32 and a bf16 parameter
tree (olmo-1b's smoke config, NaN, inf, -0 and subnormal bit patterns
planted) come back bit-exact, the bf16 file no larger than the tree's
bytes plus the archive's headers; ``__step__`` is kept; a leaf the file
lacks raises; a restore casts to the dtypes of ``like`` (meta tensors will
do). The training driver's ``--ckpt`` file restores its trained params.
``ServingStateLog``: a log written by either package is restored equally
by the other, later commits winning and a torn tail dropped. ~5 s.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro.checkpoint import ServingStateLog as JServingStateLog  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import (ServingStateLog, load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402

# per-entry zip and .npy headers of an npz archive, an upper bound
HEADER_BYTES = 512


def _params(dtype):
    cfg = dataclasses.replace(tconfigs.smoke_config("olmo-1b"), param_dtype=dtype)
    params = build_model(cfg, device="cpu").init(0)
    w = params["layers"][0]["mixer"]["wq"]["w"].view(-1)
    w[:4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40]).to(w.dtype)
    return params


def _bit_equal(a, b):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_bit_exact(tmp_path, dtype):
    params = _params(dtype)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, step=7)
    restored, step = load_checkpoint(path, params, device="cpu")
    assert step == 7
    got, want = tree_paths(restored), tree_paths(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(_bit_equal(a, b) for (_, a), (_, b) in zip(got, want))
    nbytes = sum(t.numel() * t.element_size() for _, t in want)
    assert os.path.getsize(path) <= nbytes + HEADER_BYTES * (len(want) + 2)


def test_step_kept_or_none(tmp_path):
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    save_checkpoint(str(tmp_path / "s.npz"), tree, step=123)
    save_checkpoint(str(tmp_path / "n.npz"), tree)
    assert load_checkpoint(str(tmp_path / "s.npz"), tree, device="cpu")[1] == 123
    assert load_checkpoint(str(tmp_path / "n.npz"), tree, device="cpu")[1] is None


def test_missing_key_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="checkpoint missing b"):
        load_checkpoint(path, {"a": torch.zeros(2), "b": torch.zeros(2)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": torch.zeros(3)}, device="cpu")


def test_restore_casts_to_like(tmp_path):
    params = _params("float32")
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, params)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=torch.bfloat16, device="meta"),
                    params)
    restored, _ = load_checkpoint(path, like, device="cpu")
    for (_, got), (_, src) in zip(tree_paths(restored), tree_paths(params)):
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert _bit_equal(got, src.to(torch.bfloat16))


def test_train_driver_checkpoint(tmp_path):
    path = str(tmp_path / "olmo.npz")
    state, records = train(tconfigs.smoke_config("olmo-1b"), steps=3, batch=2, seq=16,
                           device="cpu", ckpt=path, log=lambda _: None)
    assert len(records) == 3 and all(np.isfinite(r["ce"]) for r in records)
    restored, step = load_checkpoint(path, state.params, device="cpu")
    assert step == 3
    assert all(_bit_equal(a, b) for (_, a), (_, b) in zip(tree_paths(restored),
                                                         tree_paths(state.params)))


def _commits(log):
    log.commit("r1", [1, 2, 3], [10])
    log.commit("r1", [1, 2, 3], [10, 11], meta={"step": 2})
    log.commit("r2", [4, 5], [20])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serving_state_log_read_by_the_other_package(tmp_path, writer):
    path = str(tmp_path / "state.jsonl")
    _commits((JServingStateLog if writer == "jax" else ServingStateLog)(path))
    with open(path, "a") as f:
        f.write('{"id": "r3", "prompt": [1,')  # torn tail write
    got, want = ServingStateLog(path).restore(), JServingStateLog(path).restore()
    assert got == want
    assert got["r1"]["generated"] == [10, 11] and got["r1"]["meta"] == {"step": 2}
    assert "r2" in got and "r3" not in got
