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
Without GSPMD there is nothing for ``grad_specs`` to constrain and no
partitioner to insert a data-parallel reduction, so a train step here is
single-device: sharded training (``runtime/sharding.py``) is not ported
yet (ROADMAP queue A, item 10(b)), and data parallelism with the LACIN
gradient all-reduce is :func:`repro_torch.runtime.manual_dp.
make_manual_dp_train_step`.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig
from repro_torch.models.layers import AxisRules
from repro_torch.models.transformer import (check_trainable, decode_step,
                                            forward_train, init_params,
                                            prefill, resolve_device)
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import tree_leaves, tree_map

_NO_SHARDING = ("not ported yet (ROADMAP queue A, item 10(b): "
                "runtime/sharding.py)")


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
    """Parameters from :func:`init_params` (``seed``), AdamW state, step 0.
    Raises for a config whose training is not ported
    (:func:`~repro_torch.models.transformer.check_trainable`)."""
    check_trainable(cfg)
    params = init_params(seed, cfg, device=device)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=resolve_device(device))}


def on_device(batch, device) -> dict:
    """The batch's arrays (numpy or torch) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(params, batch, cfg: ModelConfig,
                   rules: AxisRules = AxisRules()):
    """(loss, metrics, grads) of :func:`forward_train` at ``params``;
    ``grads`` has ``params``' layout.  The parameters are read through
    detached aliases, so the stored tensors never require grad."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _, p: next(it), params)
    with torch.enable_grad():
        loss, metrics = forward_train(live, batch, cfg, rules=rules)
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
    takes it; a single-device step reduces nothing, and the LACIN gradient
    all-reduce is in ``runtime.manual_dp``, as in the reference.
    ``grad_specs`` must be None (see the module docstring).
    """
    if grad_specs is not None or rules.mesh is not None:
        raise NotImplementedError(f"sharded train steps are {_NO_SHARDING}; "
                                  "for data parallelism use "
                                  "runtime.manual_dp")
    if dp_allreduce not in ("xla", "lacin"):
        raise ValueError(f"dp_allreduce must be 'xla' or 'lacin', got "
                         f"{dp_allreduce!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be positive, got {grad_accum}")

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
    ``models.cast_params`` returns them.  Decode reads the cross K/V that
    prefill left in the caches; a ``cross_src`` passed to it raises."""
    def prefill_fn(params, batch):
        return prefill(params, batch, cfg, seq_len, rules=rules)

    def decode_fn(params, tokens, caches, pos, cross_src=None):
        if cross_src is not None:
            raise NotImplementedError(
                "a cross-attention source in decode is not ported yet "
                "(ROADMAP queue A, item 10(a), training of hymba, whisper "
                "and internvl); decode reads the cross K/V from the caches")
        return decode_step(params, tokens, caches, pos, cfg, seq_len,
                           rules=rules)

    return prefill_fn, decode_fn
