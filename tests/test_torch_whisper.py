"""whisper-base in the port vs the JAX package, on the CPU: the
encoder-decoder with cross-attention and learned decoder positions, served
on the gathered backend with its cross K/V in state slots.

The configs equal the reference's field by field. ``param_counts`` adds to
the reference's count what it leaves out: each decoder layer's
cross-attention and the learned position table. At smoke width (2 + 2
layers, d_model 256, 32 audio frames, 128 learned positions), with JAX's
init converted: ``Model.extend`` with ``audio_frames`` matches JAX's
logits and each layer's cross K/V (the encoder's output as the decoder
reads it), and a continuation chunk and a one-token decode read them back
from the cache; with the position table cut to 128 rows, a chunk running
past it clips its positions as JAX's does. Served (3 requests, 12 greedy
tokens each, over 16- and 6-token chunks), the streams EQUAL JAX's naive
``extend`` + ``decode`` loop, the twin of
``tests/test_engine.py::test_whisper_audio_through_engine``, and JAX's
engine's, with ``host_copy_bytes`` equal. The cross K/V are state leaves
by the model's word, also where the reference's store would read them as
pages (``n_audio_ctx == max_model_len``). f32 throughout; ``ATOL`` below.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.common as bcommon  # noqa: E402 (namespace pkg at repo root)
from repro import configs as jconfigs  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core.executor.state import PagedModelState as JPagedModelState  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import EngineConfig, LLMEngine, SchedulerConfig  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.sampling import SamplingParams  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import sinusoidal_positions  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.models.model import cache_leaf_shapes  # noqa: E402

ARCH = "whisper-base"
ATOL = 1e-4  # f32 logits over 2 + 2 layers, XLA vs PyTorch summation order
GEN = 12
ENGINE = dict(block_size=8, num_blocks=64, max_model_len=128)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_M = {}


def _models():
    """JAX's smoke model, its weights (init at PRNGKey(0), 512 position
    rows), the port's model and the converted weights; built once."""
    if not _M:
        jcfg, jm, values = bcommon.small_model(ARCH)
        tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
        _M.update(jcfg=jcfg, jm=jm, values=values, tm=tm,
                  params=convert_params(tm.cfg, values),
                  ext=jax.jit(jm.extend), dec=jax.jit(jm.decode))
    return _M


def _frames(seed, B=None):
    cfg = tconfigs.smoke_config(ARCH)
    shape = (cfg.n_audio_ctx, cfg.d_model) if B is None else (B, cfg.n_audio_ctx, cfg.d_model)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, tconfigs.smoke_config(ARCH).vocab_size,
                                       size=int(rng.integers(6, 30)))))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# configs, parameters, positions
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) == want


@pytest.mark.parametrize("get", ["get_config", "smoke_config"])
def test_param_counts(get):
    """The reference's count plus every decoder layer's cross-attention
    and the learned position table; at smoke width the count equals the
    built model's weights (biases and norms uncounted, as in the
    reference)."""
    cfg = getattr(tconfigs, get)(ARCH)
    d, hd = cfg.d_model, cfg.head_dim
    attn = 2 * d * cfg.num_heads * hd + 2 * d * cfg.kv_dim
    want = jroofline.param_counts(getattr(jconfigs, get)(ARCH))["total"] + \
        cfg.num_layers * attn + cfg.learned_positions * d
    got = troofline.param_counts(cfg)
    assert got["total"] == got["active"] == want
    if get == "smoke_config":
        params = build_model(cfg, device="cpu").init(0)

        def weights(tree):
            if isinstance(tree, dict):
                return sum(weights(v) for k, v in tree.items()
                           if k not in ("b", "scale", "bias"))
            if isinstance(tree, list):
                return sum(map(weights, tree))
            return tree.numel()
        assert weights(params) == want
    if get == "get_config":
        assert want == 70_824_448


@pytest.mark.parametrize("length,dim,atol", [(32, 256, 4e-6), (1500, 512, 2.5e-4)])
def test_sinusoidal_positions_equal_reference(length, dim, atol):
    """f32 sines and cosines of the same f32 arguments; XLA's and PyTorch's
    sin differ in their range reduction, by up to about one spacing of the
    argument: 1.2e-4 at the published 1500 frames (arguments up to 1499),
    1.9e-6 at the smoke width's 32; each tolerance is twice that."""
    from repro.models.common import sinusoidal_positions as jsin
    np.testing.assert_allclose(sinusoidal_positions(length, dim).numpy(),
                               np.asarray(jsin(length, dim)), atol=atol, rtol=0)


def test_cross_kv_are_state_leaves():
    """Each decoder layer holds k/v pages and ``cross_k`` / ``cross_v`` state
    leaves of (n_audio_ctx, KV, D): 18 432 000 B a slot at published width
    in bf16. The reference's store decides by shape and reads them as pages
    where n_audio_ctx equals max_model_len; the port's store keeps them in
    state slots."""
    cfg = tconfigs.get_config(ARCH)
    leaves = cache_leaf_shapes(cfg)
    assert len(leaves) == 6 and all(list(layer) == ["k", "v", "cross_k", "cross_v"]
                                    for layer in leaves)
    assert all(layer["cross_k"].state and layer["cross_k"].shape == (1500, 8, 64)
               and not layer["k"].state for layer in leaves)
    assert sum(np.prod(leaf.shape) * leaf.dtype.itemsize for layer in leaves
               for leaf in layer.values() if leaf.state) == 18_432_000
    m = _models()
    T = m["jcfg"].n_audio_ctx
    kw = dict(block_size=8, num_blocks=16, max_model_len=T)
    jstore = JPagedModelState(m["jm"], JEngineConfig(**kw))
    assert jstore.kinds.count("paged") == 4 * m["jcfg"].num_layers  # k, v, cross_k, cross_v
    eng = LLMEngine(m["tm"], m["params"], EngineConfig(device="cpu", **kw))
    assert eng.store.state_leaves == [(i, n) for i in range(2)
                                      for n in ("cross_k", "cross_v")]
    assert len(eng.store.stores) == 4 and eng.paged_runner is None
    assert eng.store.state_bytes_per_slot() == 2 * 2 * T * 4 * 64 * 4


# ---------------------------------------------------------------------------
# Model.extend
# ---------------------------------------------------------------------------

def _jcross(jc):
    """JAX's cross cache -> per layer (k, v) (B, T, KV, D)."""
    return [(np.asarray(layer["k"])[0], np.asarray(layer["v"])[0])
            for layer in jc["cross"][0].values()]


def test_extend_matches_jax():
    """Fresh rows with audio frames (B = 2, C = 10), then a continuation
    chunk (C = 6) and a one-token step (JAX's ``decode``) with the cross
    K/V read from the cache: logits, and each layer's cross K/V against
    JAX's."""
    m = _models()
    jm, tm, values, params = m["jm"], m["tm"], m["values"], m["params"]
    B, W = 2, 64
    frames = _frames(3, B)
    rng = np.random.default_rng(4)
    jc = jm.init_cache(B, W)
    tc = tm.init_cache(B, W)
    start = 0
    for C in (10, 6, 1):
        tok = rng.integers(0, m["jcfg"].vocab_size, size=(B, C)).astype(np.int32)
        cl = np.full(B, start, np.int32)
        extras = {"audio_frames": frames} if start == 0 else None
        if C == 1:
            jl, jc = m["dec"](values, jnp.asarray(tok), jc, jnp.asarray(cl))
        else:
            jl, jc = m["ext"](values, jnp.asarray(tok), jc, jnp.asarray(cl),
                              batch=None if extras is None else
                              {k: jnp.asarray(v) for k, v in extras.items()})
        tl, tc = tm.extend(params, torch.from_numpy(tok), tc, torch.from_numpy(cl),
                           batch=None if extras is None else
                           {k: torch.from_numpy(v) for k, v in extras.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        start += C
        for layer, (k, v) in zip(tc, _jcross(jc)):
            np.testing.assert_allclose(layer["cross_k"].numpy(), k, atol=ATOL)
            np.testing.assert_allclose(layer["cross_v"].numpy(), v, atol=ATOL)
    assert np.abs(tc[0]["cross_k"].numpy()).max() > 0.1  # the encoder ran


def test_learned_positions_clip_like_jax():
    """With the table cut to its published smoke size (128 rows), a chunk
    over positions 120-135 reads row 127 for every position past it, as
    JAX's ``extend`` clips them; the logits match."""
    m = _models()
    jm, tm = m["jm"], m["tm"]
    values = dict(m["values"], pos_embed=np.asarray(m["values"]["pos_embed"])[:128])
    params = dict(m["params"], pos_embed=m["params"]["pos_embed"][:128])
    B, W = 1, 160
    frames = _frames(5, B)
    rng = np.random.default_rng(6)
    jc = jm.init_cache(B, W)
    tc = tm.init_cache(B, W)
    for start, C in ((0, 120), (120, 16)):
        tok = rng.integers(0, m["jcfg"].vocab_size, size=(B, C)).astype(np.int32)
        cl = np.full(B, start, np.int32)
        jb = {"audio_frames": jnp.asarray(frames)} if start == 0 else None
        tb = {"audio_frames": torch.from_numpy(frames)} if start == 0 else None
        jl, jc = jm.extend(values, jnp.asarray(tok), jc, jnp.asarray(cl), batch=jb)
        tl, tc = tm.extend(params, torch.from_numpy(tok), tc, torch.from_numpy(cl),
                           batch=tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # the clip is live: the same chunk over the whole table gives other logits
    full = tm.extend(m["params"], torch.from_numpy(tok), tc, torch.from_numpy(cl))[0]
    assert not torch.allclose(full, tl, atol=1e-3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _naive(prompt, frames, n):
    """JAX's model driven by hand: ``extend`` with the frames over the
    prompt, then ``decode`` one token at a time (the reference loop)."""
    m = _models()
    cache = m["jm"].init_cache(1, 256)
    lg, cache = m["ext"](m["values"], jnp.asarray([prompt]), cache,
                         jnp.zeros((1,), jnp.int32),
                         batch={"audio_frames": jnp.asarray(frames[None])})
    out = [int(jnp.argmax(lg[0, -1]))]
    L = len(prompt)
    for _ in range(n - 1):
        lg, cache = m["dec"](m["values"], jnp.asarray([[out[-1]]]), cache,
                             jnp.asarray([L]))
        L += 1
        out.append(int(jnp.argmax(lg[0, 0])))
    return out


_TRACE = {}


def _trace():
    """Three requests, each with its own frames: the JAX loop's streams."""
    if not _TRACE:
        prompts = _prompts(3, 8)
        frames = [_frames(10 + i) for i in range(3)]
        _TRACE.update(prompts=prompts, frames=frames,
                      refs={f"r{i}": _naive(p, f, GEN)
                            for i, (p, f) in enumerate(zip(prompts, frames))})
    return _TRACE


def _serve(chunk, backend="auto"):
    m, tr = _models(), _trace()
    eng = LLMEngine(m["tm"], m["params"], EngineConfig(
        device="cpu", execution_backend=backend, **ENGINE,
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=64,
                                  prefill_chunk=chunk)))
    for i, (p, f) in enumerate(zip(tr["prompts"], tr["frames"])):
        eng.add_request(Request(request_id=f"r{i}", prompt=p, extras={"audio_frames": f},
                                sampling=SamplingParams(max_new_tokens=GEN)))
    eng.run()
    return eng, {rid: s.generated for rid, s in eng.seqs.items()}


@pytest.mark.parametrize("chunk", [16, 6])
def test_streams_equal_jax_loop(chunk):
    """At 6-token chunks every prompt takes several chunks: only the first
    carries the frames, the later ones read the cross K/V from the slot."""
    eng, got = _serve(chunk)
    refs = _trace()["refs"]
    assert got == refs
    assert len({tuple(s) for s in refs.values()}) == 3  # three distinct streams
    assert eng.paged_runner is None and eng.prefix_cache is None
    assert eng.scheduler.cfg.exact_chunks
    assert eng.bm.free_state_slots == eng.cfg.num_state_slots


def test_streams_and_host_bytes_equal_jax_engine():
    """JAX's engine over the same trace (the reference holds it to its own
    loop): equal streams, and ``host_copy_bytes`` equal — windows, written
    tokens and each row's slot of cross K/V, read and written whole, every
    dispatch."""
    m, tr = _models(), _trace()
    jeng = bcommon.make_engine(ARCH, **ENGINE)
    for i, (p, f) in enumerate(zip(tr["prompts"], tr["frames"])):
        jeng.add_request(JRequest(request_id=f"r{i}", prompt=p,
                                  extras={"audio_frames": f},
                                  sampling=JSamplingParams(max_new_tokens=GEN)))
    jeng.run()
    teng, got = _serve(16)
    assert got == {rid: s.generated for rid, s in jeng.seqs.items()}
    assert teng.host_copy_bytes == jeng.store.host_copy_bytes > 0
    assert teng.metrics_snapshot()["engine.dispatch.gathered"] == teng.runner.steps


def test_extras_refused():
    """Frames of another length, extras of another modality, and frames on
    a stack without an encoder are refused at admission."""
    m = _models()
    eng = LLMEngine(m["tm"], m["params"], EngineConfig(device="cpu", **ENGINE))
    cfg = m["tm"].cfg
    for extras in ({"audio_frames": np.zeros((cfg.n_audio_ctx - 1, cfg.d_model))},
                   {"vision_embeds": np.zeros((4, cfg.d_model))},
                   {"audio_frames": np.zeros((cfg.n_audio_ctx, cfg.d_model + 1))}):
        with pytest.raises(ValueError, match="extras"):
            eng.add_request(Request(request_id="x", prompt=[3, 4], extras=extras))
    olmo = build_model(tconfigs.smoke_config("olmo-1b"), device="cpu")
    eng = LLMEngine(olmo, olmo.init(0), EngineConfig(device="cpu", **ENGINE))
    with pytest.raises(ValueError, match="extras"):
        eng.add_request(Request(request_id="x", prompt=[3, 4],
                                extras={"audio_frames": _frames(0)}))
