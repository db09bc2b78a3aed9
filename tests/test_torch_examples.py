"""The PyTorch twins of the six examples (``examples/<name>_torch.py``) run
on the CPU at smoke width and report what the JAX examples report.

The JAX examples run meanwhile on the same flags in two processes of their
own (``tests/_examples_reference.py``, XLA at backend optimization level 0;
~25 s, most of it compiles). Each twin's report lines that depend on
neither the weights nor the clock are held equal to the JAX example's: the
engines' step, migration, block and prefix-cache counters, the traffic's
token counts, the configs' shapes and train_small's parameter count (there
from the shapes of JAX's ``init_train_state``). Tokens, router loads, the
loss and every latency are left out: the port draws its own weights from
seed 0 and the clock is the host's. Quickstart's prompt tokens are held
against the JAX package's tokenizer. One intra-op thread (four for
train_small's AdamW over 125.8 M parameters).
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from chip_smoke import EXAMPLES, example  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import ByteTokenizer as JByteTokenizer  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

SERVE_REQUESTS = (4, 16)
# the JAX examples' runs (key, example, its flags), in two processes that
# run side by side; serve_batch's two runs share their compiles
REFERENCE_RUNS = (
    [(f"serve_batch {n}", "serve_batch", ["--requests", str(n)]) for n in SERVE_REQUESTS]
    + [("fleet_demo", "fleet_demo", [])],
    [("train_small", "train_small", []), ("disagg_demo", "disagg_demo", []),
     ("moe_serving", "moe_serving", [])],
)
# the report lines (or their groups) that depend on neither the weights
# nor the clock, per example
HELD = {
    "serve_batch": (r"^=== (\d+) requests, (\d+) tokens in \S+ \(\S+ tok/s on .*, "
                    r"(\d+) engine steps\) ===$",
                    r"^policy=.*$", r"^prefix cache: .*$", r"^blocks: .*$",
                    r"^fairness gap \(VTC tokens\): .*$", r"^state log: .* \((\d+) recoverable\)$"),
    "disagg_demo": (r"^finished=.*$", r"^prefill-instance steps: .*$"),
    "fleet_demo": (r"^before: loads = .*$", r"^served \d+ requests$", r"^migrations: .*$",
                   r"^requests finished per instance: .*$"),
    "moe_serving": (r"^\S+: \d+ experts top-\d+ \+ \d+ shared, MLA rank=\d+$",
                    r"^served \d+ requests in \d+ steps$", r"^MLA KV cache per token: .*$"),
    "train_small": (r"^model: .*$",),
}
TRAIN_THREADS = 4


class Reference:
    """The JAX examples' reports, read from their processes as each run
    ends."""

    def __init__(self, tmp):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(filter(None, [
                       os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH")])),
                   XLA_FLAGS=" ".join(filter(None, [
                       os.environ.get("XLA_FLAGS"), "--xla_backend_optimization_level=0"])))
        self.procs, self.where, self.got = [], {}, {}
        for i, runs in enumerate(REFERENCE_RUNS):
            runs = [(key, name, argv + (["--state-log", str(tmp / f"{i}-{j}.jsonl")]
                                        if name == "serve_batch" else []))
                    for j, (key, name, argv) in enumerate(runs)]
            self.where.update({key: i for key, _, _ in runs})
            err = open(tmp / f"reference-{i}.err", "w+")
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests", "_examples_reference.py"),
                 json.dumps(runs)], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=err)
            self.procs.append((proc, err))

    def __getitem__(self, key):
        proc, err = self.procs[self.where[key]]
        while key not in self.got:
            line = proc.stdout.readline()
            if not line:
                rc = proc.wait()
                err.seek(0)
                raise AssertionError(f"the JAX examples exited {rc} before {key}:\n"
                                     + err.read()[-4000:])
            if line.startswith("{"):
                rec = json.loads(line)
                self.got[rec["key"]] = rec
        return self.got[key]

    def close(self):
        for proc, err in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
            err.close()


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Started with the module's first test, so the JAX examples run while
    the twins do."""
    ref = Reference(tmp_path_factory.mktemp("reference"))
    yield ref
    ref.close()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke shapes run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def held(text, name):
    """The parts of ``text`` that ``HELD[name]`` picks out: each pattern's
    groups, or its whole line."""
    out = []
    for pat in HELD[name]:
        m = re.search(pat, text, re.M)
        assert m, f"no line of {name}'s report matches {pat!r}:\n{text}"
        out.append(m.groups() or m.group(0))
    return out


def test_quickstart(capsys):
    out = example("quickstart").main(["--device", "cpu"])
    ref = jconfigs.smoke_config("gemma-2b")
    assert (out["arch"], out["layers"], out["d"], out["family"]) == \
        (ref.name, ref.num_layers, ref.d_model, ref.family)
    want = [t % ref.vocab_size for t in JByteTokenizer().encode("the quick brown fox")]
    assert out["prompt_tokens"] == want
    assert len(out["generated"]) == 16
    text = capsys.readouterr().out
    assert (f"arch={ref.name} layers={ref.num_layers} d={ref.d_model} "
            f"family={ref.family}") in text
    assert f"prompt tokens: {want}" in text


def test_train_small(tmp_path, capsys, reference):
    ckpt = str(tmp_path / "olmo100m.npz")
    # AdamW's elementwise passes over 125.8 M parameters take most of the
    # time; unlike the smoke serves they scale with threads
    torch.set_num_threads(TRAIN_THREADS)
    try:
        out = example("train_small").main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                           "--seq", "16", "--ckpt", ckpt])
    finally:
        torch.set_num_threads(1)
    assert [r["step"] for r in out["records"]] == [0, 1]
    assert all(np.isfinite(r["ce"]) for r in out["records"])
    text = capsys.readouterr().out
    assert f"checkpoint -> {ckpt}" in text
    ref = reference["train_small"]
    assert held(text, "train_small") == held(ref["text"], "train_small")
    assert out["params_count"] == ref["count"]
    like = out["params"]
    restored, step = load_checkpoint(ckpt, like, device="cpu")
    assert step == 2
    for (key, a), (_, b) in zip(tree_paths(restored), tree_paths(like), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), key


@pytest.mark.parametrize("name", EXAMPLES)
def test_bare_run_raises_without_cuda(name, tmp_path, capsys):
    """Without ``--device`` a twin runs on ``cuda``; on a box without CUDA
    ``resolve_device`` raises before anything is served or written."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: a bare run would serve on it")
    files = {"serve_batch": ["--state-log", str(tmp_path / "state.jsonl")],
             "train_small": ["--ckpt", str(tmp_path / "ckpt.npz")]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example(name).main(files.get(name, []))
    assert not os.listdir(tmp_path)
    text = capsys.readouterr().out
    assert "served" not in text and "finished" not in text and "step " not in text


@pytest.mark.parametrize("requests", SERVE_REQUESTS)
def test_serve_batch(requests, tmp_path, capsys, reference):
    log = str(tmp_path / "state.jsonl")
    out = example("serve_batch").main(["--device", "cpu", "--requests", str(requests),
                                       "--state-log", log])
    text = capsys.readouterr().out
    assert "tok/s on CPU," in text and f"state log: {log} (" in text
    assert out["num_blocks"] == 512
    got, want = held(text, "serve_batch"), held(reference[f"serve_batch {requests}"]["text"],
                                                "serve_batch")
    assert got == want
    assert (out["requests"], out["tokens"], out["steps"]) == tuple(map(int, want[0]))
    assert out["recoverable"] == int(want[-1][0])


def test_disagg_demo(capsys, reference):
    out = example("disagg_demo").main(["--device", "cpu"])
    assert all(len(g) == 12 for g in out["streams"].values())
    text = capsys.readouterr().out
    assert held(text, "disagg_demo") == held(reference["disagg_demo"]["text"], "disagg_demo")


def test_fleet_demo(capsys, reference):
    example("fleet_demo").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert held(text, "fleet_demo") == held(reference["fleet_demo"]["text"], "fleet_demo")


def test_moe_serving(capsys, reference):
    out = example("moe_serving").main(["--device", "cpu"])
    ref = jconfigs.smoke_config("deepseek-v3-671b")
    assert len(out["router_load"]) == ref.num_experts
    assert sum(out["router_load"]) == 512 * ref.top_k
    assert np.isfinite(out["aux"])
    text = capsys.readouterr().out
    assert held(text, "moe_serving") == held(reference["moe_serving"]["text"], "moe_serving")
