"""Context-parallel decode in the port vs the JAX package, on the CPU.

The reference cuts the KV cache's sequence over (pod, data) and merges each
shard's flash-decode partial (m, l, o) by one LSE-weighted combine
(``decode_attention_cp``); ``tests/test_distributed.py`` holds it against
the dense decode on 8 host devices. For MLA it names the latents ``c_kv``
and ``k_pe`` on the same "kv_seq" axis and lets XLA partition the absorbed
decode. The port runs one process per rank
(``launch/mesh.py::spawn_ranks``, gloo, one intra-op thread each; the
rank-side work is in ``tests/_torch_cp_ranks.py``, which imports no JAX):
one world of 4 ranks, each holding 16 of a 64-slot cache, decodes 3 tokens
at B=2 for llama4-scout's smoke config (a chunked and a global NoPE layer)
and starcoder2-3b's (two window layers) after a 24-token prefill, so the
new tokens land in rank 1's slice, and for deepseek-v3's (a dense and a MoE
MLA layer) from positions 15 and 40, so row 0's tokens cross the boundary
of ranks 0 and 1 while row 1's land in rank 2's slice. Each rank's logits
equal JAX's dense decode of the same weights within ``ATOL`` (the
reference's own bound) at every step, each step makes exactly 2
all-reduces per attention or MLA layer (the max of m, then l and o packed
into one sum: ``attention.cp_combine``), and the ranks' K (or ``c_kv`` and
``k_pe``) slices put together equal JAX's cache. The same world runs
``build_step``'s decode of one sequence (``mode_rules`` cuts the KV
sequence over data under "cp_decode"; with "window_ring" starcoder2's
rings stay whole on every rank; deepseek-v3 on a (data 2, model 2) mesh,
heads over model, latents over data) against ``Model.decode`` in one
process. f32 throughout.
"""
import concurrent.futures
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import _torch_cp_ranks as ranks  # noqa: E402
import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ATOL = 2e-4  # tests/test_distributed.py's bound for the reference's CP decode
ARCHS = ("llama4-scout-17b-a16e", "starcoder2-3b", "deepseek-v3-671b")
B, S, W, STEPS = 2, 24, 64, 3
# each row's first decode position: MLA's rows cross the ranks' slices
STARTS = {"deepseek-v3-671b": np.array([15, 40])}


def _starts(arch):
    return np.asarray(STARTS.get(arch, np.full(B, S)))


def _jax_dense(arch, toks):
    """JAX's dense decode after its extend of max(starts) tokens, row b
    decoding from starts[b]: per step the logits, then each layer's cache
    leaves ({"k", "v"} (B, W, KV, D) or {"c_kv", "k_pe"} (B, W, *))."""
    jcfg, jm, values = bcommon.small_model(arch)
    starts = _starts(arch)
    cache = jm.init_cache(B, W)
    _, cache = jax.jit(jm.extend)(values, jnp.asarray(toks[:, :starts.max()]), cache,
                                  jnp.zeros((B,), jnp.int32))
    dec = jax.jit(jm.decode)
    logits = []
    for t in range(STEPS):
        pos = starts + t
        lg, cache = dec(values, jnp.asarray(toks[np.arange(B), pos, None]), cache,
                        jnp.asarray(pos, jnp.int32))
        logits.append(np.asarray(lg))
    n = len(jcfg.stages[0][0])
    return logits, [{k: np.asarray(v)[0] for k, v in cache["stages"][0][f"l{i}"].items()}
                    for i in range(n)]


@pytest.fixture(scope="module")
def world():
    """The 4 ranks' results (spawned once) and JAX's references, computed
    in this process while the ranks run."""
    rng = np.random.default_rng(5)
    cases, toks = {}, {}
    for arch in ARCHS:
        cfg = tconfigs.smoke_config(arch)
        starts = _starts(arch)
        toks[arch] = rng.integers(2, cfg.vocab_size,
                                  size=(B, starts.max() + STEPS)).astype(np.int32)
        _, _, values = bcommon.small_model(arch)
        params = convert_params(cfg, jax.device_get(values))
        cases[arch] = (tree_map(lambda t: t.numpy(), params), toks[arch], starts, W, STEPS)
    toks_step = rng.integers(2, 512, size=(1, 41)).astype(np.int32)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn_ranks, ranks.run_all, ranks.WORLD, cases, toks_step,
                        timeout=600)
        want = {arch: _jax_dense(arch, toks[arch]) for arch in ARCHS}
        got = fut.result()
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_cp_decode_matches_jax_dense(world, arch):
    got, want = world
    jl, _ = want[arch]
    for r in got:
        for t in range(STEPS):
            np.testing.assert_allclose(r["dense"][arch]["logits"][t], jl[t], atol=ATOL,
                                       err_msg=f"rank {r['dense'][arch]['index']} step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cp_decode_two_all_reduces_per_attention_layer(world, arch):
    """2 per attention or MLA layer per step, both f32: the max of m, then
    one sum of [l, o]. Attention: m (B, KV, G) and (B, KV, G, 1 + D); MLA:
    m (B, H) and (B, H, 1 + r), its latent context of rank r."""
    got, _ = world
    cfg = tconfigs.smoke_config(arch)
    mixers = [s.mixer for s in cfg.layer_specs()]
    n = sum(m in ("attn", "mla") for m in mixers)
    if "mla" in mixers:
        per_layer = B * cfg.num_heads * 4 * (2 + cfg.kv_lora_rank)
    else:
        G = cfg.num_heads // cfg.num_kv_heads
        per_layer = B * cfg.num_kv_heads * G * 4 * (1 + 1 + cfg.head_dim)
    for r in got:
        assert r["dense"][arch]["all_reduces"] == [(2 * n, n * per_layer)] * STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_cp_decode_ranks_cache_slices_equal_jax(world, arch):
    """Put together in rank order, the ranks' K slices (MLA: ``c_kv`` and
    ``k_pe``) are JAX's cache: the prefill and each new token, written by
    its owning rank alone."""
    got, want = world
    _, jc = want[arch]
    end = _starts(arch).max() + STEPS
    order = sorted(got, key=lambda r: r["dense"][arch]["index"])
    assert [r["dense"][arch]["index"] for r in order] == list(range(ranks.WORLD))
    names = ("c_kv", "k_pe") if "c_kv" in jc[0] else ("k",)
    for name in names:
        for i, leaf in enumerate(jc):
            whole = np.concatenate([r["dense"][arch][name][i] for r in order], axis=1)
            assert whole.shape == leaf[name].shape
            np.testing.assert_allclose(whole[:, :end], leaf[name][:, :end], atol=1e-5,
                                       err_msg=f"{name} layer {i}")
            assert not whole[:, end:].any()


def test_build_step_cp_decode_matches_one_process(world):
    """``build_step``'s decode of one 40-token sequence: llama4's caches of
    552 slots cut into 4 x 138 over data, starcoder2's rings (528 slots)
    whole on every rank, both equal to one process's ``Model.decode``."""
    got, _ = world
    for r in got:
        ll, sc = r["step"]["llama4"], r["step"]["starcoder2 ring"]
        assert ll["cp"] == ranks.WORLD and ll["width"] == 138
        np.testing.assert_allclose(ll["logits"], ll["one"], atol=ATOL)
        assert sc["ring_whole"] and sc["width"] == 528
        np.testing.assert_allclose(sc["logits"], sc["one"], atol=ATOL)


def test_build_step_cp_decode_mla_on_data_model_mesh(world):
    """deepseek-v3's ``build_step`` decode under "cp_decode" on (data 2,
    model 2): each rank holds 276 of the 552 latent slots (``c_kv`` and
    ``k_pe`` cut, not whole) and its 2 of the 4 heads, and its logits
    (gathered over the vocab) equal one process's ``Model.decode``."""
    got, _ = world
    for r in got:
        ds = r["step"]["deepseek (2, 2)"]
        assert ds["cp"] == 2 and ds["width"] == ds["pe_width"] == 276
        np.testing.assert_allclose(ds["logits"], ds["one"], atol=ATOL)
