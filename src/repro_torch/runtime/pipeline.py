"""Pipeline parallelism (GPipe-style) over a process group.

Port of ``repro.runtime.pipeline``.  Each rank of the ``pipe`` group owns
a contiguous stage of layers; microbatches stream through ``n_micro +
n_stages - 1`` ticks, and stage-to-stage transfer is a single
:func:`~repro_torch.core.collectives.ppermute` shift per tick.  The shift
is differentiable (its backward is the reverse shift), so the backward
pipeline falls out of autograd, as it falls out of autodiff in the
reference.

On the paper's fabric the shift permutation is a subset of a 1-factor
(neighbour exchanges), i.e. contention-free by construction.

Scope: uniform single-run stacks (attention, mLSTM or sLSTM layers), as
the reference's.  Stage parameters are the layers of the replicated
parameters that the stage runs; the schedule and its gradients are what
this module demonstrates.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.collectives import library_all_reduce, ppermute
from repro_torch.models import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import AxisRules
from repro_torch.models.transformer import (_train_layer, build_runs,
                                            cross_entropy)


def _group(group_or_mesh, axis_name: str):
    """The process group of ``axis_name`` on a ``DeviceMesh``, or the group
    itself (``None``: the default group)."""
    if hasattr(group_or_mesh, "get_group"):
        return group_or_mesh.get_group(axis_name)
    return group_or_mesh


def make_pipeline_loss_fn(cfg: ModelConfig, group_or_mesh, *,
                          axis_name: str = "pipe", n_micro: int = 2):
    """Returns ``loss_fn(params, batch) -> loss`` running the layer stack
    as a pipeline over ``axis_name`` of a ``DeviceMesh`` (or over a
    ``ProcessGroup``): every rank passes the same replicated parameters
    (:func:`repro_torch.models.init_params` layout) and the same batch,
    and gets the same loss.

    The loss is real on the last stage and summed over the group by the
    library's all-reduce (the reference's ``psum``), whose backward is an
    all-reduce of the gradients: the gradient of the replicated
    parameters is the mean over the ranks of each rank's autograd
    gradient, as a data-parallel step reduces them.
    """
    runs = build_runs(cfg)
    if len(runs) != 1:
        raise ValueError("pipeline demo supports uniform single-run stacks")
    run = runs[0]
    group = _group(group_or_mesh, axis_name)
    n_stages = dist.get_world_size(group)
    if run.count % n_stages:
        raise ValueError(f"{run.count} layers must divide {n_stages} stages")
    per_stage = run.count // n_stages
    rules = AxisRules()   # single-device math on each rank
    shift = [(i, i + 1) for i in range(n_stages - 1)]
    n_ticks = n_micro + n_stages - 1

    def loss_fn(params, batch):
        s = dist.get_rank(group)
        tokens, labels = batch["tokens"], batch["labels"]
        b, t = tokens.shape
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             f"microbatches")
        x = L.embed_tokens(params["embed"], tokens, cfg)
        micro = x.reshape(n_micro, b // n_micro, t, cfg.d_model)
        pos = torch.arange(t, dtype=torch.int32, device=x.device)
        first = torch.tensor(s == 0, device=x.device)
        layers = range(s * per_stage, (s + 1) * per_stage)

        def stage_fn(xb):
            for i in layers:
                xb, _ = _train_layer(params["layers"][i], xb, cfg,
                                     kind=run.kind, window=run.windows[i],
                                     theta=run.thetas[i], q_pos=pos,
                                     rules=rules)
            return xb

        # Every rank takes every shift, and every shift's output feeds the
        # next tick (the reference's ``jnp.where``), so each rank also runs
        # every shift's backward.
        buf = torch.where(first, micro[0], torch.zeros_like(micro[0]))
        ys = []
        for tk in range(n_ticks):
            y = stage_fn(buf)
            nxt = ppermute(y, shift, group)
            feed = micro[min(tk + 1, n_micro - 1)]
            buf = torch.where(first, feed, nxt)
            ys.append(y)
        # last stage: outputs for microbatch m are at tick m + S - 1
        h = torch.stack(ys[n_stages - 1:n_stages - 1 + n_micro])
        h = h.reshape(b, t, cfg.d_model)
        h = L.apply_norm(params["final_norm"], h)
        logits = L.logits_from_hidden(h, params["embed"],
                                      params.get("lm_head"), cfg)
        loss, _ = cross_entropy(logits, labels)
        # only the last stage's loss is real; replicate it across the group
        last = torch.tensor(s == n_stages - 1, device=x.device)
        return library_all_reduce(torch.where(last, loss,
                                              torch.zeros_like(loss)), group)

    return loss_fn
