"""The port's dry-run tooling on the CPU (no card, no process group): the
cost counter (``launch/op_cost.py``, the twin of ``tests/test_hlo_cost.py``),
the time-loop folding, ``flash_prefill``'s registered cost, the roofline's
``model_flops`` against the reference's, one production-width row and the
report over it, and ``perf_runs``' nine variants. The virtual mesh's
collectives and argument bytes against real gloo ranks are held in
``tests/test_torch_tp_steps.py``, whose worlds run those steps.

* The counter's flops of a matmul, a batched matmul and a GQA attention
  (the port's plain ``flash_attention``: QK^T and PV, 4 B H Sq Sk D)
  equal the analytic counts; its bytes of a matmul are its operands' and
  result's.
* Each state mixer's time loop folded under the counter (one step, its
  counts times the trip count) counts what the whole loop counts at S=8:
  Mamba's scan, the mLSTM's recurrence and chunkwise form, the sLSTM's
  recurrence.
* ``flash_prefill`` on meta tensors counts PERF.md's bounds: 25.8 GFLOP at
  (B 1, H 24, KV 2, S 2048, D 128), 309.3 GFLOP at S 8192 under window
  4096.
* ``model_flops`` equals the reference's for every arch x shape.
* olmo-1b ``decode_32k`` on the virtual (16, 16) mesh: status ok, 33
  all-reduces (two a layer, one for the vocab-parallel embedding), the
  rank's argument bytes its slices and cache; the report prints its row
  against the SXM H100.
* deepseek-v3 ``long_500k`` under "cp_decode" on the same mesh: the
  rank's MLA latents 1/16 of the whole, 2 combine all-reduces a layer of
  the predicted sizes (the CLI row stays skipped, as the reference's).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_prefill  # noqa: E402
from repro_torch.launch import dryrun, perf_runs  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.launch.mesh import make_virtual_mesh, production_shape  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import mamba, xlstm  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_and_bmm_flops():
    with OpCost() as c:
        _meta(64, 128) @ _meta(128, 32)
    assert c.flops == 2 * 64 * 128 * 32
    assert c.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    with OpCost() as c:
        torch.bmm(_meta(4, 8, 16), _meta(4, 16, 2))
    assert c.flops == 2 * 4 * 8 * 16 * 2


def test_gqa_attention_flops():
    B, Sq, Sk, H, KV, D = 2, 16, 24, 8, 2, 32
    with OpCost() as c:
        flash_attention(_meta(B, Sq, H, D), _meta(B, Sk, KV, D), _meta(B, Sk, KV, D),
                        q_pos=torch.arange(Sq, device="meta"),
                        k_pos=torch.arange(Sk, device="meta"), scale=0.1)
    assert c.flops == 4 * B * H * Sq * Sk * D
    assert c.transcendentals >= B * H * Sq * Sk  # the softmax's exponentials


@pytest.mark.parametrize("S,window,gflop", [(2048, 0, 25.8), (8192, 4096, 309.3)])
def test_flash_prefill_cost_matches_perf_md(S, window, gflop):
    bf = torch.bfloat16
    with OpCost() as c:
        out = flash_prefill(_meta(1, 24, S, 128, dtype=bf), _meta(1, 2, S, 128, dtype=bf),
                            _meta(1, 2, S, 128, dtype=bf), scale=0.1, window=window)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 24, S, 128)
    assert round(c.flops / 1e9, 1) == gflop
    assert c.bytes == 2 * (2 * 24 * S * 128 + 2 * 2 * S * 128)
    assert c.calls["flash_prefill"] == 1


def _loops(S=8):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    B, di, N, H, dh = 2, 6, 4, 2, 4
    yield "mamba", lambda: mamba.ssm_scan(-torch.exp(t(di, N)), t(B, S, N), t(B, S, N),
                                          t(B, S, di).abs(), t(B, S, di), t(B, di, N))
    state = (t(B, H, dh, dh), t(B, H, dh), t(B, H))
    args = (t(B, S, H, dh), t(B, S, H, dh), t(B, S, H, dh), t(B, S, H), -t(B, S, H).abs())
    yield "mlstm", lambda: xlstm.mlstm_recurrence(*args, state)
    yield "mlstm_chunkwise", lambda: xlstm.mlstm_chunkwise(*args, state, chunk=4)
    yield "slstm", lambda: xlstm.slstm_recurrence(t(B, S, 4 * H * dh), t(H, dh, 4 * dh),
                                                  (t(B, H * dh), t(B, H * dh),
                                                   t(B, H * dh), t(B, H)), H, dh)


@pytest.mark.parametrize("name", ["mamba", "mlstm", "mlstm_chunkwise", "slstm"])
def test_folded_loop_counts_the_whole_loop(name):
    fn = dict(_loops())[name]
    with torch.no_grad(), OpCost() as folded:
        fn()
    with torch.no_grad(), OpCost(fold_loops=False) as full:
        fn()
    assert folded.totals() == pytest.approx({**full.totals(),
                                             "peak_bytes": folded.peak_bytes})
    assert folded.calls == full.calls
    assert folded.dispatches < full.dispatches  # it folded


@pytest.mark.parametrize("arch", tuple(sorted(tconfigs.REGISTRY)))
def test_model_flops_equal_reference(arch):
    for shape in tconfigs.SHAPES:
        assert troofline.model_flops(tconfigs.get_config(arch), shape) == pytest.approx(
            jroofline.model_flops(jconfigs.get_config(arch), shape), rel=1e-12), shape


def test_production_row_and_report(tmp_path):
    r = dryrun.run_one("olmo-1b", "decode_32k", "single", str(tmp_path))
    assert r["status"] == "ok", r.get("error")
    cfg = tconfigs.get_config("olmo-1b")
    assert r["mesh_shape"] == {"data": 16, "model": 16} and r["whole"] == []
    assert r["collective_calls"] == {"all-reduce": 2 * cfg.num_layers + 1}
    # the rank's slices (1/16 of every cut leaf) and its 8 rows' cache of
    # 32768 + 512 slots of its one KV head, bf16
    n_params = troofline.param_counts(cfg)["total"]
    kv = 2 * cfg.num_layers * 8 * (32768 + 512) * 1 * cfg.head_dim * 2
    assert abs(r["memory"]["argument_bytes"] - (2 * n_params / 16 + kv)) < 0.05 * kv
    assert r["memory"]["generated_code_bytes"] == 0 and r["unknown_loops"] == 0
    assert r["flops"] > troofline.model_flops(cfg, "decode_32k") / 256
    with open(tmp_path / "olmo-1b__decode_32k__single.json") as f:
        assert json.load(f)["status"] == "ok"
    skipped = dryrun.run_one("olmo-1b", "long_500k", "single", str(tmp_path))
    assert skipped == {"arch": "olmo-1b", "shape": "long_500k", "mesh": "single",
                       "status": "skipped", "reason": "full-attention arch (DESIGN §4)"}
    rows = json.loads(troofline.report(str(tmp_path), "json"))
    assert [row["shape"] for row in rows] == ["decode_32k"]
    row = rows[0]
    assert row["dominant"] == "memory" and row["fits"]
    assert row["t_memory_s"] == pytest.approx(r["bytes_accessed"] / 3.35e12)
    md = troofline.report(str(tmp_path))
    assert "H100" in md and "| olmo-1b | decode_32k | single |" in md
    brief = troofline.report(str(tmp_path), "brief")
    assert "| olmo-1b | decode_32k |  | " in brief and brief.rstrip().endswith("| — |")


def test_mla_cp_decode_dry_run(tmp_path):
    """deepseek-v3 at ``long_500k`` under "cp_decode" on the virtual (16, 16)
    mesh, rank 0: its latents are 1/16 of the whole (32 800 of 524 800
    slots a layer), and the data group's all-reduces are the CP combine's,
    2 per MLA layer: the max of m (8 local heads) and [l, ctx] (8, 1 + 512)
    in f32; the model group's are one after ``wo``, one after the
    feed-forward a layer and one for the vocab-parallel embedding, d_model
    wide in bf16. The CLI row stays skipped, as the reference's."""
    cfg = tconfigs.get_config("deepseek-v3-671b")
    mesh = make_virtual_mesh(production_shape())
    step = build_step(cfg, tconfigs.get_shape("long_500k"), mesh, options={"cp_decode": True})
    assert step.cp is mesh.batch and step.cp.size == 16
    r = dryrun.measure(step)
    L, slots = cfg.num_layers, step.max_seq
    latents = [t for layer in step.init_cache() for t in layer.values()]
    assert {t.shape[1] for t in latents} == {slots // 16}
    whole = L * slots * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    assert 16 * sum(t.numel() * t.element_size() for t in latents) == whole
    assert r["memory"]["argument_bytes"] > whole // 16
    H = cfg.num_heads // 16
    assert (step.cp.all_reduces, step.cp.all_reduce_bytes) == (
        2 * L, L * H * 4 * (2 + cfg.kv_lora_rank))
    assert r["collective_calls"] == {"all-reduce": 2 * L + 2 * L + 1}
    assert r["collective_bytes"]["all-reduce"] == (step.cp.all_reduce_bytes
                                                   + (2 * L + 1) * cfg.d_model * 2)
    assert dryrun.run_one("deepseek-v3-671b", "long_500k", "single",
                          str(tmp_path))["status"] == "skipped"


def test_perf_runs_are_the_references_nine():
    runs = perf_runs.runs()
    assert [(p, kw["arch"], kw["shape_name"], kw["tag"]) for p, kw in runs] == [
        ("pair1", "deepseek-v3-671b", "train_4k", "shardedmoe"),
        ("pair1", "deepseek-v3-671b", "train_4k", "onehotce"),
        ("pair1", "deepseek-v3-671b", "train_4k", "shardedmoe+onehotce"),
        ("pair2", "qwen2.5-32b", "decode_32k", "mesh32x8"),
        ("pair2", "qwen2.5-32b", "decode_32k", "mesh64x4"),
        ("pair3", "llama4-scout-17b-a16e", "long_500k", "cpdecode"),
        ("pair5", "deepseek-v3-671b", "decode_32k", "ep256"),
        ("pair4", "xlstm-1.3b", "train_4k", "timeremat"),
        ("pair4", "jamba-v0.1-52b", "train_4k", "timeremat")]
    meshes = [kw["mesh_override"] for _, kw in runs if "mesh_override" in kw]
    assert [m.shape for m in meshes] == [{"data": 32, "model": 8}, {"data": 64, "model": 4}]
    assert all(m.backend == "virtual" and m.device.type == "meta" for m in meshes)
