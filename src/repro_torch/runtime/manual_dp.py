"""Explicit-DP trainer: the paper's 1-factor schedule on the gradient
all-reduce, with optional int8 gradient compression.

Port of ``repro.runtime.manual_dp``.  The reference runs the whole step
inside a manual ``shard_map`` over the dp axis; here every rank of the
``DeviceMesh`` axis is a process that runs the step on its rows of the
batch, so its gradients exist as tensors, and the LACIN schedule reduces
them explicitly: a reduce-scatter chain, then an all-gather chain, of
1-factor matchings (``repro_torch.fabric.LacinCollectives``; wire-optimal
2(N-1)/N bytes, one hop per datum on the CIN).  On the CPU the ranks are a
gloo group; one H100 hosts one NCCL rank, so the multi-rank path is held
on gloo (ROADMAP C9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import library_all_reduce
from repro_torch.fabric import LacinCollectives
from repro_torch.models import ModelConfig
from repro_torch.models.layers import AxisRules
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.trainer import loss_and_grads, on_device


def _quantize_int8(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def lacin_grad_allreduce(grads, axis_name: str, coll: LacinCollectives,
                         compress: bool = False):
    """Mean of a gradient tree over one mesh axis with the LACIN schedule.
    ``coll`` is the mesh-bound collective set: the axis size comes from
    its mesh.  ``compress=True`` quantizes the *scattered* shards to int8
    before the all-gather phase (error <= 1/254 of max |g| per tensor),
    which quarters the all-gather's wire bytes."""
    axis_size = coll.axis_size(axis_name)

    def reduce_leaf(_, g):
        shape, dtype = g.shape, g.dtype
        flat = g.reshape(-1).float()
        pad = (-flat.numel()) % axis_size
        if pad:
            flat = F.pad(flat, (0, pad))
        shard = coll.reduce_scatter(flat.reshape(axis_size, -1), axis_name)
        if compress:
            q, scale = _quantize_int8(shard)
            qs = coll.all_gather(q, axis_name)
            ss = coll.all_gather(scale[None], axis_name)
            full = _dequantize(qs, ss[:, 0][:, None])
        else:
            full = coll.all_gather(shard, axis_name)
        flat = full.reshape(-1)
        if pad:
            flat = flat[:-pad]
        return (flat / axis_size).reshape(shape).to(dtype)

    return tree_map(reduce_leaf, grads)


def make_manual_dp_train_step(cfg: ModelConfig, mesh, opt: OptConfig,
                              *, axis_name: str = "data",
                              compress: bool = False,
                              instance: str = "auto"):
    """The data-parallel train step ``(state, batch) -> (state, metrics)``
    of one rank of ``mesh``'s ``axis_name`` (a ``DeviceMesh``); parameters
    replicated, updated in place.  Every rank passes the same global
    ``batch`` and takes its rows of it, the shard the reference's in-spec
    ``P(axis_name)`` gives each device.  ``loss`` is the mean over the
    ranks."""
    coll = LacinCollectives(mesh=mesh, instance=instance)
    n = coll.axis_size(axis_name)
    me = mesh.get_local_rank(axis_name)
    inner_rules = AxisRules()  # single-device math on each rank

    def step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = on_device(batch, device)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} ranks")
        rows = {k: v[me * (b // n):(me + 1) * (b // n)]
                for k, v in batch.items()}
        loss, _, grads = loss_and_grads(params, rows, cfg, inner_rules)
        grads = lacin_grad_allreduce(grads, axis_name, coll,
                                     compress=compress)
        # the reference's lax.pmean: the library's all-reduce, not a chain
        loss = library_all_reduce(loss, coll.group(axis_name)) / n
        params, new_opt, om = adamw_update(params, grads, state["opt"], opt)
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    return step
