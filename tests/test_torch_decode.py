"""The contiguous ``Model.decode`` of the port vs the JAX package, on the CPU.

For each of the ten smoke configs (global, window and chunked attention,
MQA / GQA with qkv biases, MLA with its MoE, Mamba and mLSTM / sLSTM
states, whisper with random audio frames, internvl with a random image):
JAX's ``extend`` of an 11-token prompt at B=2, then 3 ``decode`` steps
with ragged positions (row 1 three tokens behind row 0, rewriting slots
its prefill filled), against the port's ``extend`` (internvl: over N
placeholder tokens, the port's splice) and ``decode`` on the converted
weights. Each step's logits match within ``ATOL`` (the families' own
bound), and after the last step every cache leaf does: attention K/V,
MLA latents, the mixers' states and whisper's cross K/V. JAX's two
functions are compiled once per config, at XLA's backend optimization
level 0. f32 throughout.
"""
import functools
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

ATOL = 1e-4  # f32 logits over 2 layers, XLA vs PyTorch summation order
ARCHS = tuple(sorted(tconfigs.REGISTRY))
B, S, W, STEPS = 2, 11, 32, 3
LAG = np.array([0, 3])  # row 1 decodes three positions behind row 0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extras(cfg, rng):
    if cfg.family == "audio":
        return {"audio_frames": (0.1 * rng.normal(size=(B, cfg.n_audio_ctx, cfg.d_model))
                                 ).astype(np.float32)}
    if cfg.family == "vlm":
        return {"vision_embeds": (0.1 * rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)}
    return None


def _jax_leaves(jcfg, cache):
    """JAX's stacked cache as the port's per-layer dicts (one stage, one
    repeat at smoke size; "cross" K/V as ``cross_k`` / ``cross_v``)."""
    out = []
    for i in range(len(jcfg.stages[0][0])):
        layer = {n: np.asarray(v)[0] for n, v in cache["stages"][0][f"l{i}"].items()}
        if "cross" in cache:
            layer.update(cross_k=np.asarray(cache["cross"][0][f"l{i}"]["k"])[0],
                         cross_v=np.asarray(cache["cross"][0][f"l{i}"]["v"])[0])
        out.append(layer)
    return out


def _compiled(fn, *args):
    """``fn`` jitted for ``args``' shapes at XLA's backend optimization
    level 0 (the optimizer's passes would lengthen each one-off compile)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    jcfg, jm, values = bcommon.small_model(arch)
    tm = build_model(tconfigs.smoke_config(arch), device="cpu")
    params = convert_params(tm.cfg, jax.device_get(values))
    rng = np.random.default_rng(7)
    toks = rng.integers(2, jcfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
    extras = _extras(jcfg, rng)
    args = (values, jnp.asarray(toks[:, :S]), jm.init_cache(B, W), jnp.zeros((B,), jnp.int32))
    _, jcache = _compiled(functools.partial(jm.extend, batch=extras), *args)(*args)
    cache = tm.init_cache(B, W)
    prompt = torch.from_numpy(toks[:, :S])
    n_img = 0
    if extras and "vision_embeds" in extras:  # the image over N placeholders
        n_img = jcfg.num_image_tokens
        prompt = torch.cat([torch.zeros((B, n_img), dtype=prompt.dtype), prompt], dim=1)
    _, cache = tm.extend(params, prompt, cache, torch.zeros(B, dtype=torch.long),
                         batch=None if extras is None else
                         {k: torch.from_numpy(v) for k, v in extras.items()})
    dec = _compiled(jm.decode, values, jnp.asarray(toks[:, S:S + 1]), jcache,
                    jnp.zeros((B,), jnp.int32))
    for t in range(STEPS):
        lens = n_img + S + t - LAG
        jl, jcache = dec(values, jnp.asarray(toks[:, S + t:S + t + 1]), jcache,
                         jnp.asarray(lens, jnp.int32))
        tl, cache = tm.decode(params, torch.from_numpy(toks[:, S + t:S + t + 1]), cache,
                              torch.from_numpy(lens))
        assert tl.shape == (B, 1, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"{arch} step {t}")
    want = _jax_leaves(jcfg, jcache)
    assert [sorted(c) for c in cache] == [sorted(c) for c in want]
    for i, (got, ref) in enumerate(zip(cache, want)):
        for name, t in got.items():
            np.testing.assert_allclose(t.float().numpy(), ref[name].astype(np.float32),
                                       atol=ATOL, err_msg=f"{arch} layer {i} {name}")
