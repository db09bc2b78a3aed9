"""The PyTorch port stands alone: importing every module of ``repro_torch``
(and ``chip_smoke.py``) loads neither JAX nor the JAX package ``repro``.
Checked in a fresh interpreter, where nothing else has imported them."""
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke  # its phases run only under __main__
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), "modules;", "leaked:", bad)
assert not bad, bad
assert len(mods) >= 20, mods
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout
