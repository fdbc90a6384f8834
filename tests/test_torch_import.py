"""``import repro_torch`` and every submodule, and ``chip_smoke.py``, pull in
neither jax nor the JAX package repro."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert {"repro_torch.workload", "repro_torch.workload.arrivals",
        "repro_torch.workload.serving",
        "repro_torch.workload.__main__", "repro_torch.core.collectives",
        "repro_torch.fabric.collectives", "repro_torch.models.moe",
        "repro_torch.configs.granite_moe_3b_a800m", "repro_torch.models.flash",
        "repro_torch.optim.adamw", "repro_torch.data.pipeline",
        "repro_torch.checkpoint.manager", "repro_torch.runtime.trainer",
        "repro_torch.runtime.loop",
        "repro_torch.runtime.manual_dp", "repro_torch.runtime.pipeline",
        "repro_torch.workload.extract"} <= set(sys.modules)
print(len(names), bad)
"""


def test_repro_torch_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    n, bad = out.split(" ", 1)
    assert int(n) >= 83, out          # every module of the port was imported
    assert bad.strip() == "[]", out


_SMOKE_PROBE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_chip_smoke_imports_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", _SMOKE_PROBE,
         os.path.join(ROOT, "chip_smoke.py")], env=dict(os.environ),
        check=True, capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == "[]", out
