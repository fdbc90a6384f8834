"""Parameters of the JAX reference, as numpy arrays, into the port.

The caller turns the reference's pytree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module imports
nothing of JAX.  Layouts are the same in both packages, so each leaf is a
copy; the reference's per-run stacks (leading axis ``run.count``) become
one dict per layer, a MoE layer's ``moe`` subtree (router (d, E), wi/wg
(E_store, d, f), wo (E_store, f, d)) with the rest.  :func:`expert_shard`
gives one rank of an expert-parallel mesh its slice of every MoE layer.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .moe import expert_slice
from .transformer import _layer_specs, build_runs, resolve_device


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """``tree``: the reference's ``init_params`` output with numpy leaves."""
    device = resolve_device(device)
    _layer_specs(cfg)                 # raises for parts not ported yet
    runs = build_runs(cfg)
    if len(tree["stack"]) != len(runs):
        raise ValueError(f"{len(tree['stack'])} stacked runs for the "
                         f"{len(runs)} runs of {cfg.name}")
    layers = []
    for run, stacked in zip(runs, tree["stack"]):
        for i in range(run.count):
            layers.append(_to_torch(_index(stacked, i), device))
    out = {"embed": _to_torch(tree["embed"], device), "layers": layers,
           "final_norm": _to_torch(tree["final_norm"], device)}
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], device)
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def expert_shard(params: dict, rank: int, n: int) -> dict:
    """``params`` with every MoE layer's expert store cut to rank
    ``rank``'s slice of ``n`` (:func:`~.moe.expert_slice`, the reference's
    ``P(tp)`` in-spec); every other leaf is shared, not copied."""
    layers = [dict(layer, moe=expert_slice(layer["moe"], rank, n))
              if "moe" in layer else layer for layer in params["layers"]]
    return dict(params, layers=layers)
