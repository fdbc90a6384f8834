"""After a tiny run of the harness, no module of JAX or of the JAX package
``repro`` is loaded (compared by the top-level name: ``repro_torch`` is
the port), and the harness's sources name neither."""
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

BENCH = Path(__file__).resolve().parent


def test_tiny_run_loads_no_jax(tiny_bench):
    code = f"""
import sys, time, json
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH.parent / 'src')!r}]
import torch
torch.set_num_threads(1)
from portbench import harness
from pathlib import Path
harness.BENCH_DIR = Path({str(tiny_bench / 'portbench')!r})
for cell in ("tiny-dense.train.t", "tiny-moe.train.t"):
    out = harness.run_cell(cell, 1, 0.01, True, "cpu", time.perf_counter())
    assert out["correct"], out["_run"]["numbers"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_bench)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "portbench" in top
    assert not top & set(harness.FORBIDDEN_MODULES), top


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.sim", object())
    assert harness.forbidden_loaded() == ["repro"]


def test_sources_import_no_jax_and_read_no_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.name.startswith("test_") or path.name == "conftest.py":
            continue
        text = path.read_text()
        for word in ("import jax", "from jax", "import repro\n",
                     "from repro import", "from repro.", "import repro.",
                     "benchmarks/"):
            assert word not in text, (path, word)
