"""Train and serve step factories, used by the training loop.

Port of ``repro.runtime.trainer``.  ``make_train_step`` returns
``(state, batch) -> (state, metrics)``: loss and gradients of
:func:`repro_torch.models.transformer.forward_train` by autograd, then one
AdamW step.  The reference's step is a pure function for ``pjit``; this one
runs eagerly on the state's device and updates the parameters and AdamW's
m and v in place (a second copy of a 3 B-parameter train state would not
fit beside the first on one card); the step counters are new tensors.

A train state is ``{"params", "opt": {"m", "v", "step"}, "step"}``: the
parameters as stored (fp32), m and v in fp32, int32 step counters.

With a mesh in the rules the step is sharded, the port's GSPMD step over a
``torch.distributed`` ``DeviceMesh``: the state's leaves are DTensors placed
by ``runtime.sharding.state_specs`` (``sharding.shard_tree``), and the step
computes what the single-device step computes on the global batch, which
every rank passes.  Each rank takes its dp rows of each microbatch
(``train_batch_specs``), gathers every leaf once a step over the mesh axes
its spec shards it on (ZeRO-3), but a leaf that the tensor-parallel layers
compute on its ``tp`` slice (``models.transformer.tp_slice_dim``: the
attention, MLP, cross-attention, SSM and mLSTM leaves, the encoder's, the
embedding, the head) or an expert leaf of the expert-parallel MoE
(``models/moe.py``) keeps that slice, gathered over dp only
(``sharding.working_copy``), and runs ``forward_train`` and its backward
on local tensors, the hand-written kernels included: on a mesh with a
``tp`` axis of size tp each rank's working copy holds 1/tp of those
leaves, and its layers post all-reduces over ``tp``.  The ``SLSTM`` block,
attention whose query heads do not split over ``tp`` and an mLSTM whose
heads do not still compute whole on every ``tp`` rank (ROADMAP C22).  A
rank's loss is
weighted by its labels over the global count (the reference's ``ce.sum() /
n`` over the whole batch), the MoE's aux and z losses come from router
statistics summed over dp (``AxisRules.global_router_stats``), and each
gradient (a ``tp`` slice's, or a whole leaf's, equal on every ``tp`` rank)
is summed over dp into ``grad_specs``' placements when given (a
reduce-scatter: the reference's ZeRO-2), else the parameter's.  AdamW then
runs on m and v's shards, its clip reading the norm over all shards, and
each updated parameter shard is gathered back to its own placement.  The
numbers are the reference's.  Data parallelism with the LACIN gradient
all-reduce is :func:`repro_torch.runtime.manual_dp.make_manual_dp_train_step`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.models import ModelConfig
from repro_torch.models.convert import as_dtensor
from repro_torch.models.layers import AxisRules
from repro_torch.models.transformer import (decode_step, forward_train,
                                            init_params, prefill,
                                            resolve_device)
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.sharding import (is_expert_leaf, narrow, spec_map,
                                          working_dim, working_leaf)
from repro_torch.runtime.sharding import placements as spec_placements


def make_rules(mesh) -> AxisRules:
    """AxisRules for a mesh with axes ("pod",)?, "data", "model" (a
    ``torch.distributed`` ``DeviceMesh``)."""
    if mesh is None:
        return AxisRules()
    names = tuple(mesh.mesh_dim_names or ())
    dp = tuple(n for n in names if n in ("pod", "data"))
    tp = "model" if "model" in names else None
    return AxisRules(dp=dp, tp=tp, mesh=mesh)


def init_train_state(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Parameters from :func:`init_params` (``seed``), AdamW state, step 0."""
    params = init_params(seed, cfg, device=device)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=resolve_device(device))}


def on_device(batch, device) -> dict:
    """The batch's arrays (numpy or torch) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(params, batch, cfg: ModelConfig,
                   rules: AxisRules = AxisRules(), weights=None):
    """(loss, metrics, grads) of :func:`forward_train` at ``params``;
    ``grads`` has ``params``' layout.  The parameters are read through
    detached aliases, so the stored tensors never require grad.
    ``weights`` (w_ce, w_aux): differentiate ``w_ce * ce_loss + w_aux *
    aux_loss`` in place of the loss (a sharded step's share of it)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _, p: next(it), params)
    with torch.enable_grad():
        loss, metrics = forward_train(live, batch, cfg, rules=rules)
        if weights is not None:
            loss = (weights[0] * metrics["ce_loss"]
                    + weights[1] * metrics["aux_loss"])
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    it = iter(grads)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _, p: next(it), params)


def make_train_step(cfg: ModelConfig, rules: AxisRules, opt: OptConfig,
                    *, grad_accum: int = 1, dp_allreduce: str = "xla",
                    grad_specs=None):
    """Build the train step ``(state, batch) -> (state, metrics)``.

    ``grad_accum > 1`` splits the batch into that many microbatches, run
    one after another, and averages their gradients and losses (the
    reference's ``lax.scan``); the other metrics are the last
    microbatch's.  ``dp_allreduce``: "xla" or "lacin", as the reference
    takes it; the step's own dp reduction is DTensor's (the reference's
    GSPMD), and the LACIN gradient all-reduce is in ``runtime.manual_dp``,
    as in the reference.  ``grad_specs``: a ``sharding.Spec`` tree for the
    gradients (``sharding.grad_accum_specs``), read where the rules have a
    mesh (see the module docstring), as the reference's constraint is.
    """
    if dp_allreduce not in ("xla", "lacin"):
        raise ValueError(f"dp_allreduce must be 'xla' or 'lacin', got "
                         f"{dp_allreduce!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be positive, got {grad_accum}")
    if rules.mesh is not None:
        return _sharded_train_step(cfg, rules, opt, grad_accum, grad_specs)

    def train_step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = on_device(batch, device)
        if grad_accum > 1:
            b = next(iter(batch.values())).shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} does not split into "
                                 f"{grad_accum} microbatches")
            grads, loss = None, 0.0
            for mb in range(grad_accum):
                part = {k: v.reshape((grad_accum, b // grad_accum)
                                     + v.shape[1:])[mb]
                        for k, v in batch.items()}
                mloss, metrics, g = loss_and_grads(params, part, cfg, rules)
                grads = g if grads is None else tree_map(
                    lambda _, a, c: a.add_(c), grads, g)
                loss = loss + mloss
                del g
            grads = tree_map(lambda _, g: g.div_(grad_accum), grads)
            loss = loss / grad_accum
        else:
            loss, metrics, grads = loss_and_grads(params, batch, cfg, rules)
        params, new_opt, opt_metrics = adamw_update(params, grads,
                                                    state["opt"], opt)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def _sharded_train_step(cfg: ModelConfig, rules: AxisRules, opt: OptConfig,
                        grad_accum: int, grad_specs):
    """The train step on a mesh (the module docstring says what it does)."""
    mesh = rules.mesh
    names = list(mesh.mesh_dim_names)
    dp_dims = [names.index(a) for a in rules.dp]
    tp_dim = names.index(rules.tp) if rules.tp is not None else None
    coord = mesh.get_coordinate()
    dp_size, dp_index = rules.dp_size, 0
    for i in dp_dims:
        dp_index = dp_index * int(mesh.size(i)) + coord[i]
    fwd_rules = dataclasses.replace(rules, global_router_stats=True)
    over_dp = [Partial() if i in dp_dims else Replicate()
               for i in range(mesh.ndim)]
    replicated = [Replicate()] * mesh.ndim

    def reduce(path, g, p, target, dim):
        """This rank's gradient (the whole leaf, or its ``tp`` slice on
        ``dim``) summed over dp into ``target``'s placement: the local
        shard."""
        src = over_dp
        if dim is not None:
            if is_expert_leaf(path, cfg, rules):
                # the all-to-all's backward summed the tp ranks' equal
                # losses
                g = g / rules.tp_size
            src = [Shard(dim) if i == tp_dim else pl
                   for i, pl in enumerate(over_dp)]
        return as_dtensor(g, mesh, src, p.shape).redistribute(
            mesh, target).to_local()

    def train_step(state, batch):
        params = state["params"]
        plist, m, v = [], [], []    # paired by key, in params' order
        spec_map(lambda _, p, mi, vi: plist.append(p) or m.append(mi)
                 or v.append(vi), params, state["opt"]["m"],
                 state["opt"]["v"])
        device = plist[0].to_local().device
        batch = on_device(batch, device)
        b = next(iter(batch.values())).shape[0]
        if b % (grad_accum * dp_size):
            raise ValueError(f"batch {b} does not split into {grad_accum} "
                             f"microbatches over {dp_size} dp ranks")
        rows = b // grad_accum
        mine = rows // dp_size
        targets = []
        if grad_specs is None:
            spec_map(lambda _, p: targets.append(list(p.placements)), params)
        else:
            spec_map(lambda _, p, s: targets.append(spec_placements(s, mesh)),
                     params, grad_specs)
        paths, dims = [], []

        def gather(path, p):
            """Once a step: the leaf whole, or its ``tp`` slice."""
            paths.append(path)
            dims.append(working_dim(path, p, cfg, rules))
            return working_leaf(p, dims[-1], rules)
        live = tree_map(gather, params)
        acc, weighted, aux = None, 0.0, 0.0
        for mb in range(grad_accum):
            whole = {k: v[mb * rows:(mb + 1) * rows] for k, v in batch.items()}
            part = {k: v[dp_index * mine:(dp_index + 1) * mine]
                    for k, v in whole.items()}
            total = (whole["labels"] >= 0).sum().clamp_min(1)
            weight = (part["labels"] >= 0).sum() / total
            _, metrics, grads = loss_and_grads(
                live, part, cfg, fwd_rules, weights=(weight, 1.0 / dp_size))
            grads = tree_leaves(grads)
            for j, (path, p, target, dim) in enumerate(
                    zip(paths, plist, targets, dims)):
                g, grads[j] = grads[j], None
                g = reduce(path, g, p, target, dim)
                if acc is None:
                    grads[j] = g
                else:
                    acc[j].add_(g)
            acc = grads if acc is None else acc
            weighted = weighted + weight * metrics["ce_loss"]
            aux = aux + metrics["aux_loss"]
        del live
        if grad_accum > 1:
            for g in acc:
                g.div_(grad_accum)
        ce = as_dtensor(weighted.reshape(()), mesh, over_dp,
                        ()).full_tensor()
        loss = (ce + aux) / grad_accum

        # the global norm: each shard counted once, on the rank at
        # coordinate 0 of every mesh dim that replicates it
        sq = torch.zeros((), dtype=torch.float32, device=device)
        for g, target in zip(acc, targets):
            if all(coord[i] == 0 for i, pl in enumerate(target)
                   if not isinstance(pl, Shard)):
                sq = sq + g.float().square().sum()
        gnorm = torch.sqrt(as_dtensor(sq, mesh, [Partial()] * mesh.ndim,
                                      ()).full_tensor())

        # AdamW on m and v's shards: the parameter and the gradient
        # narrowed to them (views), then each parameter gathered back
        views = [narrow(p.to_local(), p.placements, mi.placements, mesh)
                 for p, mi in zip(plist, m)]
        gviews = [narrow(g, target, mi.placements, mesh)
                  for g, target, mi in zip(acc, targets, m)]

        def like_params(leaves):
            it = iter(leaves)
            return tree_map(lambda _, p: next(it), params)
        _, new_opt, opt_metrics = adamw_update(
            like_params(views), like_params(gviews),
            {"m": like_params([x.to_local() for x in m]),
             "v": like_params([x.to_local() for x in v]),
             "step": state["opt"]["step"].to_local()}, opt, grad_norm=gnorm)
        del acc, gviews
        with torch.no_grad():
            for p, mi, view in zip(plist, m, views):
                if tuple(p.placements) != tuple(mi.placements):
                    p.to_local().copy_(as_dtensor(
                        view, mesh, mi.placements, p.shape).redistribute(
                            mesh, p.placements).to_local())
        new_state = {"params": params,
                     "opt": {"m": state["opt"]["m"], "v": state["opt"]["v"],
                             "step": as_dtensor(new_opt["step"], mesh,
                                                replicated, ())},
                     "step": as_dtensor(state["step"].to_local() + 1, mesh,
                                        replicated, ())}
        metrics = {"ce_loss": ce / grad_accum, "aux_loss": aux / grad_accum,
                   "tokens": total, **opt_metrics, "loss": loss}
        return new_state, metrics

    return train_step


def suggest_grad_accum(cfg: ModelConfig, global_batch: int, seq_len: int,
                       dp_size: int, budget_bytes: float = 5e9,
                       tp_size: int = 16) -> int:
    """Microbatch count keeping per-microbatch live bytes under budget.

    Two dominant terms with full remat:
    * saved residual stream:  L * B_loc * T * d * 2 bytes;
    * CE logits (fp32 value + grad + recompute ~ 3 copies):
      B_loc * T * (V / tp) * 4 * 3 bytes.
    The same arithmetic as the reference's.
    """
    b_loc = max(global_batch // max(dp_size, 1), 1)
    acts = cfg.num_layers * b_loc * seq_len * cfg.d_model * 2
    logits = b_loc * seq_len * (cfg.vocab_padded / max(tp_size, 1)) * 4 * 3
    moe = 0.0
    if cfg.is_moe:
        moe = (b_loc * seq_len * cfg.top_k * cfg.capacity_factor
               * cfg.d_model * 4 * 5)
    per_mb = acts + logits + moe
    ga = 1
    while per_mb / ga > budget_bytes and ga < b_loc:
        ga *= 2
    return min(ga, b_loc)


def make_serve_steps(cfg: ModelConfig, rules: AxisRules, seq_len: int):
    """(prefill_fn, decode_fn) for serving shapes; the parameters as
    ``models.cast_params`` returns them, local tensors: on a mesh, each
    rank's working copy of parameters placed by ``sharding.param_specs``
    (``sharding.working_copy``, taken once by the caller), and each rank
    then computes prefill and decode on its ``tp`` slices, on caches of its
    KV heads (``init_caches(rules=)``), and returns the whole logits.
    Decode reads the cross K/V that prefill left in the caches, or
    ``cross_src`` where a cache holds none
    (:func:`~repro_torch.models.transformer.decode_step`)."""
    def prefill_fn(params, batch):
        return prefill(params, batch, cfg, seq_len, rules=rules)

    def decode_fn(params, tokens, caches, pos, cross_src=None):
        return decode_step(params, tokens, caches, pos, cfg, seq_len,
                           rules=rules, cross_src=cross_src)

    return prefill_fn, decode_fn
