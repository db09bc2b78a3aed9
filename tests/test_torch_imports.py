"""The PyTorch port stands alone: importing every module of ``repro_torch``
(and ``chip_smoke.py``) loads neither JAX nor the JAX package ``repro``.
Checked in a fresh interpreter, where nothing else has imported them; the
walk must reach the KIVI, LoRA, gathered-backend and MoE modules, and the
migration (disaggregation, fleet), telemetry config / export and roofline
modules, MLA (deepseek-v3) with the page store and gathered runner
that hold its latents and KIVI windows, and the state mixers (Mamba,
xLSTM) with the jamba-v0.1-52b and xlstm-1.3b configs."""
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
assert len(mods) >= 25, mods
kivi = {"repro_torch.core.kv_quant", "repro_torch.kernels._build",
        "repro_torch.kernels.kv_quant.kv_quant", "repro_torch.kernels.kv_quant.ops",
        "repro_torch.kernels.kv_quant.ref",
        "repro_torch.kernels.paged_attention.paged_attention_quant"}
assert kivi <= set(mods), kivi - set(mods)
lora = {"repro_torch.core.lora.config", "repro_torch.core.lora.registry",
        "repro_torch.core.lora.store", "repro_torch.kernels.lora.bgmv",
        "repro_torch.kernels.lora.ops", "repro_torch.kernels.lora.ref"}
assert lora <= set(mods), lora - set(mods)
gathered = {"repro_torch.configs.starcoder2_3b", "repro_torch.core.executor.gathered",
            "repro_torch.kernels.flash_attention.flash_attention",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref"}
assert gathered <= set(mods), gathered - set(mods)
moe = {"repro_torch.configs.llama4_scout_17b_a16e", "repro_torch.models.moe"}
assert moe <= set(mods), moe - set(mods)
migration = {"repro_torch.core.disagg", "repro_torch.core.fleet",
             "repro_torch.core.telemetry.config", "repro_torch.core.telemetry.export",
             "repro_torch.launch.roofline"}
assert migration <= set(mods), migration - set(mods)
mla = {"repro_torch.configs.deepseek_v3_671b", "repro_torch.models.mla",
       "repro_torch.core.executor.state", "repro_torch.core.executor.gathered"}
assert mla <= set(mods), mla - set(mods)
state = {"repro_torch.configs.jamba_v0_1_52b", "repro_torch.configs.xlstm_1_3b",
         "repro_torch.models.mamba", "repro_torch.models.xlstm"}
assert state <= set(mods), state - set(mods)
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout
