"""Finding a cell's files by name, the run, and the result line.

A cell ``<cell>`` is ``cells/<cell>.json`` (its configuration, traffic
mix and output-check limits) and its entry in ``BENCHMARK.json``; its
configuration is ``configs/<config>.json``, its mix ``traffic/<mix>.json``,
whose ``kind`` names the driver ``traffic/<kind>.py``, and each per-layer
metric ``<metric>`` is read by ``metrics/<metric>.py``.  A driver runs
set-up, the window and the output check; a metric reader takes one number
from what the run recorded, or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
#: Top-level module names that may not be loaded in a run's process: JAX,
#: its relatives and the JAX package of this repository (``repro_torch``,
#: the port, is another name).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" named {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r}: {path}")
    mod_name = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    path = BENCH_DIR.parent / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else {}


@dataclass
class Cell:
    """A cell with its configuration and mix, and what BENCHMARK.json asks
    of it: the chips, the end-to-end and the per-layer metrics."""
    name: str
    spec: dict
    config: dict
    mix: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(name: str, bench: dict | None = None) -> Cell:
    spec = load_json("cells", name)
    config = load_json("configs", spec["config"])
    mix = load_json("traffic", spec["traffic"])
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench.get("workloads", ())
                  if w["name"] == name), None)
    cell = Cell(name, spec, config, mix)
    if entry is not None:
        if (entry["config"], entry["traffic"]) != (spec["config"],
                                                   spec["traffic"]):
            raise ValueError(f"{name}: BENCHMARK.json pairs "
                             f"{entry['config']}/{entry['traffic']}, its "
                             f"cell file {spec['config']}/{spec['traffic']}")
        cell.chips = entry["chips"]
        cell.end_to_end = [m for m in bench["end_to_end"]
                           if reports(m, name)]
        names = [m["name"] for m in cell.end_to_end]
        cell.per_layer = [m for m in bench.get("per_layer", ())
                          if reports(m, name, names)]
    return cell


# -- model sizes from a configuration file ----------------------------------

#: Published key -> the port's ModelConfig field, for the keys whose value
#: the run checks against the configuration it builds.
PORT_FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
               "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta",
               "tie_word_embeddings": "tie_embeddings",
               "num_local_experts": "num_experts",
               "num_experts_per_tok": "top_k"}
ACT_MLP = {"gelu_pytorch_tanh": "gelu", "silu": "swiglu"}


def _ceil_to(n: int, m: int) -> int:
    return -(-n // max(m, 1)) * max(m, 1)


def gains(config: dict) -> dict:
    """The published multipliers that the port has no field for, as the
    factors ``weights.py`` folds into its draws: the embedding's, the
    blocks' output (residual), the query's (the attention multiplier over
    the port's 1 / sqrt(head_dim)) and the final norm's scale (1 / logits
    scaling, and over the embedding multiplier where the head is tied)."""
    embed = config.get("embedding_multiplier", 1.0)
    query = config.get("attention_multiplier")
    final = 1.0 / config.get("logits_scaling", 1.0)
    if config["tie_word_embeddings"]:
        final /= embed
    return {"embed": embed, "residual": config.get("residual_multiplier", 1.0),
            "query": 1.0 if query is None
            else query * math.sqrt(config["head_dim"]),
            "final": final}


def model_sizes(config: dict, seq: int | None = None) -> dict:
    """The sizes the yardstick, the weights and the references read, from
    the configuration file alone (the program is not asked)."""
    port = config["port"]
    experts = config.get("num_local_experts", 0)
    layers = config["num_hidden_layers"]
    window = config.get("sliding_window") or 0
    return {
        "name": config["name"], "family": config["family"],
        "num_layers": layers, "d_model": config["hidden_size"],
        "num_heads": config["num_attention_heads"],
        "num_kv_heads": config["num_key_value_heads"],
        "head_dim": config["head_dim"], "d_ff": config["intermediate_size"],
        "vocab_size": config["vocab_size"],
        "vocab_padded": _ceil_to(config["vocab_size"], port["vocab_pad_to"]),
        "mlp": ACT_MLP[config["hidden_act"]],
        "norm": ("layernorm" if config.get("norm_type") == "layer_norm"
                 else "rmsnorm"),
        "norm_eps": config.get("norm_epsilon", config.get("rms_norm_eps")),
        "bias": bool(config.get("use_bias", False)),
        "tie": bool(config["tie_word_embeddings"]),
        "rope_theta": config["rope_theta"],
        # a window at least as long as the sequence sees every earlier key
        "windows": [0 if (seq is not None and window >= seq) else window]
        * layers,
        "num_experts": experts,
        "top_k": config.get("num_experts_per_tok", 0),
        "experts_stored": (_ceil_to(experts, port["expert_pad_to"])
                           if experts else 0),
        "capacity_factor": port.get("capacity_factor", 0.0),
        "aux_weights": (0.01, 0.001),
        "gains": gains(config),
    }


def port_config(config: dict):
    """The port's ModelConfig as this configuration runs it: the registry's
    entry with the file's ``port`` fields, checked against every published
    key of the file."""
    import dataclasses
    from repro_torch.models.config import get_config
    base = get_config(config["registry_name"])
    fields = dict(config["port"])
    n = fields.get("num_layers", base.num_layers)
    if n != base.num_layers:
        fields.update(block_pattern=base.block_pattern[:n],
                      windows=base.windows[:n])
    cfg = dataclasses.replace(base, **fields)
    wrong = {k: (config[k], getattr(cfg, f)) for k, f in PORT_FIELDS.items()
             if k in config and config[k] != getattr(cfg, f)}
    sizes = model_sizes(config)
    if cfg.mlp != sizes["mlp"] or cfg.norm != sizes["norm"]:
        wrong["mlp/norm"] = ((sizes["mlp"], sizes["norm"]),
                             (cfg.mlp, cfg.norm))
    if sizes["bias"] != (cfg.attn_bias and cfg.mlp_bias):
        wrong["use_bias"] = (sizes["bias"], (cfg.attn_bias, cfg.mlp_bias))
    if any(cfg.windows) or cfg.qk_norm or cfg.logit_softcap:
        wrong["attention"] = "windows, qk-norm and softcap are not expected"
    if wrong:
        raise ValueError(f"{config['name']}: the port's config departs from "
                         f"the file: {wrong}")
    return cfg


# -- the result line --------------------------------------------------------

def metric_entry(value, unit):
    return {"value": float(value), "unit": unit}


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def check_lines(check: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in check.items()]


@dataclass
class RunContext:
    """What a traffic driver is given: the cell, the run's arguments, the
    device, the process's start on the host clock and, for the tests and
    the readings only, a fault to plant (``traffic/<kind>.py`` names the
    faults it knows)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    fault: str | None = None


@dataclass
class Recorded:
    """What a run recorded, for the per-layer metrics' readers: the
    configuration's sizes, the cell's shape, the window's steps and host
    seconds, its trace (``yardstick.trace.Trace``, None untraced), the
    seconds of each spanned call by name, and the stored parameters."""
    cell: str
    sizes: dict
    batch: int
    seq: int
    steps: int
    window_s: float
    trace: object = None
    spans: dict = field(default_factory=dict)
    n_params: int = 0


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, fault: str | None = None) -> dict:
    """Run a cell on ``device`` and return the result's object (the line
    printed last), with the driver's full output under ``"_run"``."""
    import torch
    cell = find_cell(name)
    device = torch.device(device)
    driver = load_module("traffic", cell.mix["kind"])
    out = driver.run(RunContext(cell, seed, seconds, trace, device, t0,
                                fault))
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(out["recorded"])
            if value is not None:
                metrics[m["name"]] = metric_entry(value, units[m["name"]])
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = metric_entry(
                out["end_to_end"][m["name"]], units[m["name"]])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    rec = out["recorded"]
    if trace and rec.trace is not None:
        from portbench.yardstick import trace as T
        lo, hi = rec.trace.window
        dev["busy_s"] = T.busy_ns(rec.trace) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = {
            "device_ops": T.top({k: t for k, (t, _)
                                 in T.device_ops(rec.trace).items()}),
            "idle_gaps": T.top(T.idle_gaps(rec.trace))}
    result["check"] = out["check"]
    result["_run"] = out
    return result
