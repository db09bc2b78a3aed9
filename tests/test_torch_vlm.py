"""internvl2-2b in the port vs the JAX package, on the CPU: a global GQA
decoder that takes image embeddings (``vision_embeds``) ahead of its text,
served through request extras.

The oracle is JAX's MODEL, not its engine: ``extend`` with
``batch={"vision_embeds"}`` over the prompt (the image's N rows spliced
ahead of the text), then ``decode`` from position N + len(prompt). JAX's
engine serves such a request wrongly on both backends: its chunk becomes
N + C rows the engine does not know of, so it scatters back the image
rows' K/V as the text's, samples at an image row and decodes from
position C (ROADMAP C). The port's image owns KV positions [0, N) ahead of
the text (``SeqState.image_len``).

At smoke width (2 layers, d_model 256, 4 heads over 2 KV heads, 8 image
rows), with JAX's init converted: ``Model.extend`` matches JAX's logits
and K/V, the image whole in one chunk and split across two, and a decode
step after it. Served (3 image requests and a text request, 8 greedy
tokens each), on ``auto``
(image chunks gathered, the rest paged: ``extend_paged`` and
``decode_paged``) and on ``gathered``, with 16-token chunks (the image
inside the first) and 6-token chunks (the image straddles a boundary),
the streams EQUAL the JAX loop's; so do they with an image request
arriving while a text request decodes (the twin of
``tests/test_executor.py::test_extras_first_chunk_routes_gathered_with_extras_intact``:
the image chunks run gathered as their own group, everything else fused
paged). JAX's engine gives other streams, on both backends. The prefix cache neither looks
up nor registers a request with an image. f32 throughout; ``ATOL`` below.
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
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import EngineConfig, LLMEngine, SchedulerConfig  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.sampling import SamplingParams  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

ARCH = "internvl2-2b"
ATOL = 1e-4  # f32 logits over 2 layers, XLA vs PyTorch summation order
GEN = 8
ENGINE = dict(block_size=8, num_blocks=128, max_model_len=128)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_M = {}


def _models():
    """JAX's smoke model and weights (init at PRNGKey(0)), the port's model
    and the converted weights; built once."""
    if not _M:
        jcfg, jm, values = bcommon.small_model(ARCH)
        tm = build_model(tconfigs.smoke_config(ARCH), device="cpu")
        _M.update(jcfg=jcfg, jm=jm, values=values, tm=tm,
                  params=convert_params(tm.cfg, values),
                  ext=jax.jit(jm.extend), dec=jax.jit(jm.decode))
    return _M


N = tconfigs.smoke_config(ARCH).num_image_tokens


def _image(seed, B=None):
    d = tconfigs.smoke_config(ARCH).d_model
    shape = (N, d) if B is None else (B, N, d)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _prompt(rng, lo=6, hi=30):
    return list(map(int, rng.integers(2, tconfigs.smoke_config(ARCH).vocab_size,
                                      size=int(rng.integers(lo, hi)))))


# ---------------------------------------------------------------------------
# config, parameters
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert dataclasses.asdict(getattr(tconfigs, get)(ARCH)) == want


@pytest.mark.parametrize("get", ["get_config", "smoke_config"])
def test_param_counts_equal_reference(get):
    got = troofline.param_counts(getattr(tconfigs, get)(ARCH))
    assert got == jroofline.param_counts(getattr(jconfigs, get)(ARCH))
    if get == "get_config":  # 1.89 B parameters, 3.78 GB in bf16
        assert got["total"] == 1_889_046_528


# ---------------------------------------------------------------------------
# Model.extend
# ---------------------------------------------------------------------------

def _windows(cache, upto):
    return [(c["k"][:, :upto].numpy(), c["v"][:, :upto].numpy()) for c in cache]


def _jwindows(jc, upto):
    return [(np.asarray(layer["k"])[0][:, :upto], np.asarray(layer["v"])[0][:, :upto])
            for layer in jc["stages"][0].values()]


@pytest.mark.parametrize("split", [None, 5])
def test_extend_matches_jax(split):
    """JAX's ``extend`` over [image; text] (B = 2, N = 8, C = 12), then one
    ``decode`` step; the port's ``extend`` over N placeholders and the
    text, whole or in two chunks split inside the image (the second chunk
    starts at 5 and carries image rows 5-7), then a one-token chunk at
    N + C. Logits and K/V windows match."""
    m = _models()
    jm, tm, values, params = m["jm"], m["tm"], m["values"], m["params"]
    B, C, W = 2, 12, 64
    img = _image(1, B)
    rng = np.random.default_rng(2)
    tok = rng.integers(2, m["jcfg"].vocab_size, size=(B, C)).astype(np.int32)
    jl, jc = m["ext"](values, jnp.asarray(tok), jm.init_cache(B, W),
                      jnp.zeros((B,), jnp.int32), batch={"vision_embeds": jnp.asarray(img)})
    tc = tm.init_cache(B, W)
    full = np.concatenate([np.zeros((B, N), np.int32), tok], axis=1)
    bounds = [0, N + C] if split is None else [0, split, N + C]
    logits = []
    for lo, hi in zip(bounds, bounds[1:]):
        tl, tc = tm.extend(params, torch.from_numpy(full[:, lo:hi]), tc,
                           torch.full((B,), lo, dtype=torch.int32),
                           batch={"vision_embeds": torch.from_numpy(img)})
        logits.append(tl.numpy())
    np.testing.assert_allclose(np.concatenate(logits, axis=1), np.asarray(jl), atol=ATOL)
    for (k, v), (jk, jv) in zip(_windows(tc, N + C), _jwindows(jc, N + C)):
        np.testing.assert_allclose(k, jk, atol=ATOL)
        np.testing.assert_allclose(v, jv, atol=ATOL)
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jl, jc = m["dec"](values, jnp.asarray(nxt), jc, jnp.full((B,), N + C, jnp.int32))
    tl, tc = tm.extend(params, torch.from_numpy(nxt), tc,
                       torch.full((B,), N + C, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _loop(prompt, image, n):
    """JAX's model driven by hand: ``extend`` over the prompt with the
    image spliced ahead of it (none: the prompt alone), then ``decode``
    from position N + len(prompt)."""
    m = _models()
    cache = m["jm"].init_cache(1, 256)
    batch = None if image is None else {"vision_embeds": jnp.asarray(image[None])}
    lg, cache = m["ext"](m["values"], jnp.asarray([prompt]), cache,
                         jnp.zeros((1,), jnp.int32), batch=batch)
    out = [int(jnp.argmax(lg[0, -1]))]
    L = len(prompt) + (0 if image is None else len(image))
    for _ in range(n - 1):
        lg, cache = m["dec"](m["values"], jnp.asarray([[out[-1]]]), cache,
                             jnp.asarray([L]))
        L += 1
        out.append(int(jnp.argmax(lg[0, 0])))
    return out


_TRACE = {}


def _trace():
    """Three image requests and one text request; the JAX loop's streams."""
    if not _TRACE:
        rng = np.random.default_rng(8)
        prompts = [_prompt(rng) for _ in range(4)]
        images = [_image(10 + i) for i in range(3)] + [None]
        _TRACE.update(prompts=prompts, images=images,
                      refs={f"r{i}": _loop(p, im, GEN)
                            for i, (p, im) in enumerate(zip(prompts, images))})
    return _TRACE


def _request(i, cls=Request, sp=SamplingParams):
    tr = _trace()
    im = tr["images"][i]
    return cls(request_id=f"r{i}", prompt=list(tr["prompts"][i]),
               extras=None if im is None else {"vision_embeds": im},
               sampling=sp(max_new_tokens=GEN))


def _engine(backend="auto", chunk=16, **kw):
    m = _models()
    return LLMEngine(m["tm"], m["params"], EngineConfig(
        device="cpu", execution_backend=backend, **dict(ENGINE, **kw),
        scheduler=SchedulerConfig(max_batch_slots=8, max_batched_tokens=64,
                                  prefill_chunk=chunk)))


def _record(eng):
    """Every batch each runner executes, in order: (runner, [(id, start,
    length)], extras or None)."""
    seen = []
    for runner in (eng.runner, eng.paged_runner):
        if runner is None:
            continue
        orig = runner.execute

        def capture(batch, _orig=orig, _name=runner.name):
            seen.append((_name, [(c.seq.request_id, c.start, c.length)
                                 for c in batch.chunks], batch.extras))
            return _orig(batch)
        runner.execute = capture
    return seen


@pytest.mark.parametrize("chunk", [16, 6])
@pytest.mark.parametrize("backend", ["auto", "gathered"])
def test_streams_equal_jax_loop(backend, chunk):
    """Every chunk over an image position runs gathered with the image, in
    groups of its own; on ``auto`` every other dispatch is paged. At
    6-token chunks each image straddles the boundary at 6."""
    eng = _engine(backend, chunk)
    seen = _record(eng)
    for i in range(4):
        eng.add_request(_request(i))
    eng.run()
    refs = _trace()["refs"]
    assert {rid: s.generated for rid, s in eng.seqs.items()} == refs
    assert len({tuple(s) for s in refs.values()}) == 4
    carrying = [(name, rows, ex) for name, rows, ex in seen
                if any(st < N and rid != "r3" for rid, st, _ in rows)]
    assert carrying and all(name == "gathered" and ex is not None
                            and ex["vision_embeds"].shape == (len(rows), N, 256)
                            and all(st < N and rid != "r3" for rid, st, _ in rows)
                            for name, rows, ex in carrying)
    if chunk == 6:  # the image crosses a chunk boundary: two carrying chunks each
        assert sum(len(rows) for _, rows, _ in carrying) == 6
    others = [name for name, rows, ex in seen if (name, rows, ex) not in carrying]
    assert set(others) == {"paged" if backend == "auto" else "gathered"}
    assert all(ex is None for name, rows, ex in seen if (name, rows, ex) not in carrying)
    # the image's positions are the sequence's: 8 + prompt + generated
    assert all(s.prompt_len == N * (i < 3) + len(_trace()["prompts"][i])
               for i, s in enumerate(eng.seqs.values()))


def test_image_request_arriving_mid_decode():
    """An image request admitted while a text request decodes: its image
    chunk runs gathered as its own group (fused, it would lose its image),
    every other dispatch runs paged, and both streams equal the loop's."""
    eng = _engine("auto", 16)
    seen = _record(eng)
    eng.add_request(_request(3))
    arrived = False
    while eng.scheduler.has_work():
        eng.step()
        if not arrived and len(eng.seqs["r3"].generated) >= 2:
            eng.add_request(_request(0))
            arrived = True
    refs = _trace()["refs"]
    assert eng.seqs["r3"].generated == refs["r3"]
    assert eng.seqs["r0"].generated == refs["r0"]
    first = [(name, rows, ex) for name, rows, ex in seen
             if any(rid == "r0" and st == 0 for rid, st, _ in rows)]
    assert len(first) == 1
    name, rows, ex = first[0]
    assert name == "gathered" and rows == [("r0", 0, rows[0][2])]
    assert ex["vision_embeds"].shape == (1, N, 256)
    assert all(name == "paged" for name, rows, ex in seen if (name, rows, ex) not in first)
    assert eng.metrics_snapshot()["engine.dispatch.gathered"] == 1


@pytest.mark.parametrize("backend", ["auto", "gathered"])
def test_reference_engine_diverges_from_its_model(backend):
    """JAX's engine over the same image requests gives streams that differ
    from its own model's loop, on both backends: it keeps the image rows'
    K/V as the text's, samples at an image row and decodes from the wrong
    positions (ROADMAP C). The port's engine equals the loop
    (``test_streams_equal_jax_loop``)."""
    jeng = bcommon.make_engine(ARCH, execution_backend=backend, **ENGINE)
    for i in range(3):
        jeng.add_request(_request(i, JRequest, JSamplingParams))
    jeng.run()
    refs = _trace()["refs"]
    got = {rid: s.generated for rid, s in jeng.seqs.items()}
    assert all(len(got[f"r{i}"]) == GEN and got[f"r{i}"] != refs[f"r{i}"]
               for i in range(3))
    # its sequence positions leave out the image: decode starts at C
    assert all(s.total_len == len(s.request.prompt) + GEN for s in jeng.seqs.values())


def test_prefix_cache_skips_images():
    """Two image requests with one prompt and different images, then two
    text requests with that prompt: the image requests are neither looked
    up nor registered (their placeholder tokens would name the other
    image's pages), each stream equals its loop; the text requests share
    pages as always."""
    rng = np.random.default_rng(12)
    prompt = _prompt(rng, 40, 41)
    images = [_image(20), _image(21)]
    eng = _engine("auto", 16)
    pc = eng.prefix_cache
    for i, im in enumerate(images):
        eng.add_request(Request(request_id=f"v{i}", prompt=list(prompt),
                                extras={"vision_embeds": im},
                                sampling=SamplingParams(max_new_tokens=4)))
        eng.run()
    assert pc.stats.lookups == 0 and pc.stats.inserted_blocks == 0
    assert eng.seqs["v0"].prefix_hit_tokens == eng.seqs["v1"].prefix_hit_tokens == 0
    for i, im in enumerate(images):
        assert eng.seqs[f"v{i}"].generated == _loop(prompt, im, 4)
    for i in range(2):
        eng.add_request(Request(request_id=f"t{i}", prompt=list(prompt),
                                sampling=SamplingParams(max_new_tokens=4)))
        eng.run()
    assert pc.stats.inserted_blocks > 0 and eng.seqs["t1"].prefix_hit_tokens > 0
    assert eng.seqs["t0"].generated == eng.seqs["t1"].generated
    assert eng.seqs["t0"].generated != eng.seqs["v0"].generated


def test_extras_refused():
    """Image rows of another width or count than the config's, audio
    frames on a VLM, and an image on a speculative engine are refused at
    admission."""
    eng = _engine()
    for extras in ({"vision_embeds": np.zeros((N, 255), np.float32)},
                   {"vision_embeds": np.zeros((N + 1, 256), np.float32)},
                   {"audio_frames": np.zeros((N, 256), np.float32)}):
        with pytest.raises(ValueError, match="extras"):
            eng.add_request(Request(request_id="x", prompt=[3, 4], extras=extras))
    with pytest.raises(ValueError, match="speculative"):
        _engine("speculative").add_request(Request(
            request_id="x", prompt=[3, 4], extras={"vision_embeds": _image(0)}))
