"""The JAX examples' reports, for ``tests/test_torch_examples.py``.

Runs each ``examples/<name>.py`` named in the JSON list given as the only
argument, one after the other in this process (so runs of one example share
its compiles), each ``main`` under the arguments given, and prints one JSON
line as each run ends: ``{"key": ..., "text": what the example printed}``.
``train_small`` is not trained: its first report line ("model: ...
params=...M") is printed from the shapes of ``init_train_state``
(``jax.eval_shape``), with the exact count under ``"count"``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_examples_reference.py \\
        '[["fleet", "fleet_demo", []], ["small", "train_small", []]]'
"""
import contextlib
import importlib.util
import io
import json
import os
import sys

import jax

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def param_line(mod):
    """``train_small``'s first report line and its parameter count, from
    the shapes of the state its ``main`` initialises."""
    from repro.models import build_model
    from repro.train.loop import init_train_state
    cfg = mod.make_100m()
    state = jax.eval_shape(lambda: init_train_state(build_model(cfg), jax.random.PRNGKey(0)))
    n_params = sum(x.size for x in jax.tree.leaves(state.params))
    return f"model: {cfg.name}  params={n_params/1e6:.1f}M\n", n_params


def main():
    for key, name, argv in json.loads(sys.argv[1]):
        mod = example(name)
        if name == "train_small":
            text, count = param_line(mod)
            print(json.dumps({"key": key, "text": text, "count": count}), flush=True)
            continue
        sys.argv = [mod.__file__, *argv]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        print(json.dumps({"key": key, "text": buf.getvalue()}), flush=True)


if __name__ == "__main__":
    main()
