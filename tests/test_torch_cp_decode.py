"""Context-parallel decode in the port vs the JAX package, on the CPU.

The reference cuts the KV cache's sequence over (pod, data) and merges each
shard's flash-decode partial (m, l, o) by one LSE-weighted combine
(``decode_attention_cp``); ``tests/test_distributed.py`` holds it against
the dense decode on 8 host devices. The port runs one process per rank
(``launch/mesh.py::spawn_ranks``, gloo, one intra-op thread each; the
rank-side work is in ``tests/_torch_cp_ranks.py``, which imports no JAX):
one world of 4 ranks, each holding 16 of a 64-slot cache, decodes 3 tokens
after a 24-token prefill at B=2, so the new tokens land in rank 1's slice,
for llama4-scout's smoke config (a chunked and a global NoPE layer) and
starcoder2-3b's (two window layers). Each rank's logits equal JAX's dense
decode of the same weights within ``ATOL`` (the reference's own bound),
each step makes exactly 2 all-reduces per attention layer (the max of m,
then l and o packed into one sum), and the ranks' K slices put together
equal JAX's cache. The same world runs ``build_step``'s decode of one
sequence (``mode_rules`` cuts the KV sequence 4 ways under "cp_decode";
with "window_ring" starcoder2's rings stay whole on every rank) against
``Model.decode`` in one process, and deepseek-v3's MLA under ``cp``
raises. f32 throughout.
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
ARCHS = ("llama4-scout-17b-a16e", "starcoder2-3b")
B, S, W, STEPS = 2, 24, 64, 3


def _jax_dense(arch, toks):
    """JAX's dense decode after its extend: per step the logits, then each
    layer's K cache (B, W, KV, D)."""
    jcfg, jm, values = bcommon.small_model(arch)
    cache = jm.init_cache(B, W)
    _, cache = jax.jit(jm.extend)(values, jnp.asarray(toks[:, :S]), cache,
                                  jnp.zeros((B,), jnp.int32))
    dec = jax.jit(jm.decode)
    logits = []
    for t in range(STEPS):
        lg, cache = dec(values, jnp.asarray(toks[:, S + t:S + t + 1]), cache,
                        jnp.full((B,), S + t, jnp.int32))
        logits.append(np.asarray(lg))
    n = len(jcfg.stages[0][0])
    ks = [np.asarray(cache["stages"][0][f"l{i}"]["k"])[0] for i in range(n)]
    return logits, ks


@pytest.fixture(scope="module")
def world():
    """The 4 ranks' results (spawned once) and JAX's references, computed
    in this process while the ranks run."""
    rng = np.random.default_rng(5)
    cases, toks = {}, {}
    for arch in ARCHS:
        cfg = tconfigs.smoke_config(arch)
        toks[arch] = rng.integers(2, cfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
        _, _, values = bcommon.small_model(arch)
        params = convert_params(cfg, jax.device_get(values))
        cases[arch] = (tree_map(lambda t: t.numpy(), params), toks[arch], S, W, STEPS)
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
    """2 per attention layer per step: the max of m (B, KV, G) and one
    sum of [l, o] (B, KV, G, 1 + D), both f32."""
    got, _ = world
    cfg = tconfigs.smoke_config(arch)
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    G = cfg.num_heads // cfg.num_kv_heads
    per_layer = B * cfg.num_kv_heads * G * 4 * (1 + 1 + cfg.head_dim)
    for r in got:
        assert r["dense"][arch]["all_reduces"] == [(2 * n_attn, n_attn * per_layer)] * STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_cp_decode_ranks_cache_slices_equal_jax(world, arch):
    """Put together in rank order, the ranks' K slices are JAX's cache:
    the prefill and each new token, written by its owning rank alone."""
    got, want = world
    _, jk = want[arch]
    order = sorted(got, key=lambda r: r["dense"][arch]["index"])
    assert [r["dense"][arch]["index"] for r in order] == list(range(ranks.WORLD))
    for i, k in enumerate(jk):
        whole = np.concatenate([r["dense"][arch]["k"][i] for r in order], axis=1)
        assert whole.shape == k.shape
        np.testing.assert_allclose(whole[:, :S + STEPS], k[:, :S + STEPS], atol=1e-5)
        assert not whole[:, S + STEPS:].any()


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


def test_mla_under_cp_raises(world):
    got, _ = world
    for r in got:
        assert r["mla"] is not None and "MLA" in r["mla"]
