"""Fixtures of the benchmark's tests: tiny cells of both families, run on
the CPU through the whole harness.

``tiny_bench`` copies the benchmark's files beside a BENCHMARK.json of two
tiny cells (``tiny-dense.train.t`` and ``tiny-moe.train.t``: the port's
starcoder2-3b and granite-moe-3b-a800m at 2 layers, width 64) and points
the harness at the copy.  Tests that need the card carry the ``cuda``
marker and skip inside the ``cuda_device`` fixture where there is none.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from portbench import harness  # noqa: E402

TINY_PORT = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2,
             "head_dim": 16, "d_ff": 128, "vocab_size": 250, "num_layers": 2,
             "vocab_pad_to": 16, "remat": "full", "dtype": "bfloat16",
             "param_dtype": "float32"}
TINY_SHAPE = {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "intermediate_size": 128, "vocab_size": 250}

TINY_CONFIGS = {
    "tiny-dense": {
        **TINY_SHAPE, "name": "tiny-dense", "family": "dense",
        "source": "test", "registry_name": "starcoder2-3b",
        "hidden_act": "gelu_pytorch_tanh", "norm_type": "layer_norm",
        "norm_epsilon": 1e-06, "use_bias": True, "rope_theta": 10000.0,
        "tie_word_embeddings": True,
        "port": {**TINY_PORT, "rope_theta": 10000.0, "tie_embeddings": True}},
    "tiny-moe": {
        **TINY_SHAPE, "name": "tiny-moe", "family": "moe", "source": "test",
        "registry_name": "granite-moe-3b-a800m", "num_local_experts": 8,
        "num_experts_per_tok": 2, "hidden_act": "silu",
        "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
        "tie_word_embeddings": False,
        "port": {**TINY_PORT, "num_experts": 8, "top_k": 2,
                 "expert_pad_to": 16, "capacity_factor": 1.25,
                 "tie_embeddings": False}},
}
TINY_MIX = {"kind": "train", "batch": 4, "seq": 32, "zipf_s": 1.1,
            "reference_steps": 3,
            "optimizer": {"lr": 0.0003, "warmup_steps": 200,
                          "total_steps": 10000, "min_lr_ratio": 0.1,
                          "beta1": 0.9, "beta2": 0.95, "eps": 1e-08,
                          "weight_decay": 0.1, "clip_norm": 1.0}}
#: Limits of the tiny cells: loose enough for bf16 against float32 at
#: width 64, tight enough for every planted fault.
TINY_LIMITS = {"loss_gap": 0.02, "grad_norm_gap": 0.2, "update_gap": 0.2}
TINY_CELLS = ("tiny-dense.train.t", "tiny-moe.train.t")


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    base = tmp_path / "portbench"
    shutil.copytree(harness.BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    for name, cfg in TINY_CONFIGS.items():
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (base / "traffic" / "train.t.json").write_text(json.dumps(TINY_MIX))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for cell in TINY_CELLS:
        config = cell.split(".")[0]
        (base / "cells" / f"{cell}.json").write_text(json.dumps(
            {"config": config, "traffic": "train.t", "why": "test",
             "limits": TINY_LIMITS}))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": "train.t", "chips": 1,
                                   "why": "test"})
    tiny = {"starcoder2-3b.train.b4t2048": "tiny-dense.train.t",
            "granite-moe-3b-a800m.train.b4t2048": "tiny-moe.train.t"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny[w] for w in m["workloads"] if w in tiny]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "BENCH_DIR", base)
    return tmp_path


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")
