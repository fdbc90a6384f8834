"""Parameters and train states of the JAX reference, as numpy arrays, into
the port, and back.

The caller turns the reference's pytree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module imports
nothing of JAX.  Layouts are the same in both packages, so each leaf is a
copy; the reference's per-run stacks (leading axis ``run.count``) become
one dict per layer, a MoE layer's ``moe`` subtree (router (d, E), wi/wg
(E_store, d, f), wo (E_store, f, d)) with the rest, and so does the
encoder's stack (``encoder``, beside ``enc_norm``); ``meta_tokens`` is one
(M, d) leaf.  Every leaf keeps its dtype (the SSM's float32 ``A_log`` and
``D`` too).
:func:`numpy_from_params` is the inverse of :func:`params_from_numpy`, and
:func:`train_state_to_numpy` / :func:`train_state_from_numpy` apply both to
a whole train state (parameters, AdamW's m and v, the step counters), the
layout the checkpoints of both packages hold;
:func:`train_state_to_reference` and :func:`train_state_from_reference`
change the layout without leaving the device, for a sharded state's
DTensors.  :func:`stacked` and :func:`per_layer` map any tree between the
two layouts (partition specs too).  :func:`expert_shard` gives one rank of
an expert-parallel mesh its slice of every MoE layer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from .config import ModelConfig
from .moe import expert_slice
from .transformer import build_runs, resolve_device


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """``tree``: the reference's ``init_params`` output with numpy leaves."""
    device = resolve_device(device)
    return per_layer(tree, cfg, lambda x: _to_torch(x, device),
                     lambda x, i: _to_torch(np.asarray(x)[i], device))


def per_layer(tree, cfg: ModelConfig, leaf, index) -> dict:
    """A tree of the reference's layout (each run's layers stacked along a
    leading axis, as :func:`shapes_from_params` gives it) in the port's:
    one dict per layer.  ``leaf(x)`` maps an unstacked leaf, ``index(x,
    i)`` gives layer ``i`` of a stacked one; so it maps parameters, shapes
    or a parameter's partition specs alike.  The inverse of
    :func:`numpy_from_params`' layout."""
    runs = build_runs(cfg)
    if len(tree["stack"]) != len(runs):
        raise ValueError(f"{len(tree['stack'])} stacked runs for the "
                         f"{len(runs)} runs of {cfg.name}")
    layers = [_map(stacked, lambda x, i=i: index(x, i))
              for run, stacked in zip(runs, tree["stack"])
              for i in range(run.count)]
    out = {"embed": _map(tree["embed"], leaf), "layers": layers,
           "final_norm": _map(tree["final_norm"], leaf)}
    if "lm_head" in tree:
        out["lm_head"] = _map(tree["lm_head"], leaf)
    if "encoder" in tree:
        out["encoder"] = [_map(tree["encoder"], lambda x, i=i: index(x, i))
                          for i in range(cfg.encoder_layers)]
    for name in ("enc_norm", "meta_tokens"):
        if name in tree:
            out[name] = _map(tree[name], leaf)
    return out


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype without its data (the reference's
    ``jax.ShapeDtypeStruct``), for ``CheckpointManager.restore``'s
    ``like``."""
    shape: tuple
    dtype: object


def _host(x) -> np.ndarray:
    """A numpy copy of ``x``, which later in-place updates of ``x`` leave
    alone."""
    return x.detach().to("cpu", copy=True).numpy()


def _shape(x) -> ShapeDtype:
    return ShapeDtype(tuple(x.shape), x.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stack(group, fn):
    """One run's per-layer dicts as one dict of stacked leaves."""
    if isinstance(group[0], dict):
        return {k: _stack([g[k] for g in group], fn) for k in group[0]}
    return fn(group)


def stacked(params, cfg: ModelConfig, leaf, stack) -> dict:
    """A tree of the port's layout in the reference's: ``leaf(x)`` maps a
    leaf outside the layers, ``stack(xs)`` one run's leaves of one name.
    The inverse of :func:`per_layer`."""
    stacked, i = [], 0
    for run in build_runs(cfg):
        stacked.append(_stack(params["layers"][i:i + run.count], stack))
        i += run.count
    if i != len(params["layers"]):
        raise ValueError(f"{len(params['layers'])} layers for the {i} of "
                         f"{cfg.name}")
    out = {"embed": _map(params["embed"], leaf), "stack": stacked,
           "final_norm": _map(params["final_norm"], leaf)}
    if "lm_head" in params:
        out["lm_head"] = _map(params["lm_head"], leaf)
    if "encoder" in params:
        out["encoder"] = _stack(params["encoder"], stack)
    for name in ("enc_norm", "meta_tokens"):
        if name in params:
            out[name] = _map(params[name], leaf)
    return out


def numpy_from_params(params, cfg: ModelConfig) -> dict:
    """The port's parameters (or any tree of their layout, such as AdamW's
    m) as the reference's tree of numpy arrays: the layers of each run
    stacked along a leading axis.  The inverse of
    :func:`params_from_numpy`.  A bf16 leaf raises (numpy has no bf16)."""
    return stacked(
        params, cfg, _host,
        lambda xs: np.stack([x.detach().cpu().numpy() for x in xs]))


def shapes_from_params(params, cfg: ModelConfig) -> dict:
    """The tree :func:`numpy_from_params` would give, as :class:`ShapeDtype`
    leaves: no data moves."""
    return stacked(
        params, cfg, _shape,
        lambda xs: ShapeDtype((len(xs),) + tuple(xs[0].shape), xs[0].dtype))


def train_state_to_numpy(state, cfg: ModelConfig) -> dict:
    """A train state (``runtime.trainer.init_train_state``) in the
    reference's layout, numpy leaves: what both packages' checkpoints
    hold."""
    opt = state["opt"]
    return {"params": numpy_from_params(state["params"], cfg),
            "opt": {"m": numpy_from_params(opt["m"], cfg),
                    "v": numpy_from_params(opt["v"], cfg),
                    "step": _host(opt["step"])},
            "step": _host(state["step"])}


def train_state_like(state, cfg: ModelConfig) -> dict:
    """:func:`train_state_to_numpy`'s tree as :class:`ShapeDtype` leaves."""
    opt = state["opt"]
    return {"params": shapes_from_params(state["params"], cfg),
            "opt": {"m": shapes_from_params(opt["m"], cfg),
                    "v": shapes_from_params(opt["v"], cfg),
                    "step": _shape(opt["step"])},
            "step": _shape(state["step"])}


def _shifted(placements, by: int) -> list:
    return [Shard(p.dim + by) if isinstance(p, Shard) else p
            for p in placements]


def as_dtensor(local, mesh, placements, shape) -> DTensor:
    """``local``, this rank's shard, as a DTensor of global ``shape``
    (contiguous) placed by ``placements`` on ``mesh``; no collective."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _stack_tensors(xs):
    """One run's per-layer tensors stacked along a new leading axis, on
    their device.  DTensors stack their local shards, each rank its own,
    the layer axis unsharded: no collective."""
    if not isinstance(xs[0], DTensor):
        return torch.stack(xs)
    x0 = xs[0]
    return as_dtensor(torch.stack([x.to_local() for x in xs]),
                      x0.device_mesh, _shifted(x0.placements, 1),
                      (len(xs),) + tuple(x0.shape))


def _layer_of(x, i: int):
    """Layer ``i`` of a stacked tensor, a view: a DTensor's is a view of
    its local shard."""
    if not isinstance(x, DTensor):
        return x[i]
    if any(isinstance(p, Shard) and p.dim == 0 for p in x.placements):
        raise ValueError(f"the layer axis is sharded: {x.placements}")
    return as_dtensor(x.to_local()[i], x.device_mesh,
                      _shifted(x.placements, -1), tuple(x.shape[1:]))


def train_state_to_reference(state, cfg: ModelConfig) -> dict:
    """A train state in the reference's layout, its leaves still tensors on
    their device: DTensors (a sharded state, ``runtime.sharding``) stay
    DTensors, each run's layers stacked from the local shards.  What
    ``CheckpointManager.save`` takes of a sharded state."""
    opt = state["opt"]
    stack = lambda tree: stacked(  # noqa: E731
        tree, cfg, lambda x: x, _stack_tensors)
    return {"params": stack(state["params"]),
            "opt": {"m": stack(opt["m"]), "v": stack(opt["v"]),
                    "step": opt["step"]},
            "step": state["step"]}


def train_state_from_reference(tree, cfg: ModelConfig) -> dict:
    """The inverse of :func:`train_state_to_reference`: tensors or DTensors
    of the reference's layout (``CheckpointManager.restore(...,
    shardings=)``) as the port's train state, each layer a view of its
    stacked tensor."""
    opt = tree["opt"]
    unstack = lambda t: per_layer(t, cfg, lambda x: x,  # noqa: E731
                                  _layer_of)
    return {"params": unstack(tree["params"]),
            "opt": {"m": unstack(opt["m"]), "v": unstack(opt["v"]),
                    "step": opt["step"]},
            "step": tree["step"]}


def train_state_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The inverse of :func:`train_state_to_numpy`: the reference's train
    state, numpy leaves, as the port's on ``device``."""
    device = resolve_device(device)
    opt = tree["opt"]
    return {"params": params_from_numpy(tree["params"], cfg, device),
            "opt": {"m": params_from_numpy(opt["m"], cfg, device),
                    "v": params_from_numpy(opt["v"], cfg, device),
                    "step": _to_torch(opt["step"], device)},
            "step": _to_torch(tree["step"], device)}


def expert_shard(params: dict, rank: int, n: int) -> dict:
    """``params`` with every MoE layer's expert store cut to rank
    ``rank``'s slice of ``n`` (:func:`~.moe.expert_slice`, the reference's
    ``P(tp)`` in-spec); every other leaf is shared, not copied."""
    layers = [dict(layer, moe=expert_slice(layer["moe"], rank, n))
              if "moe" in layer else layer for layer in params["layers"]]
    return dict(params, layers=layers)
