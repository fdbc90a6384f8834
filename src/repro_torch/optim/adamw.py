"""AdamW + cosine schedule + global-norm clipping, on the port's parameter
trees.

Port of ``repro.optim.adamw``.  A tree is nested dicts and lists of
tensors, the port's layout: ``params["layers"]`` is a list of per-layer
dicts where the reference stacks each run's layers along a leading axis.
The optimizer state mirrors the parameters, with m and v in fp32.

Two differences of form, none of result:

- :func:`adamw_update` updates the parameters, m and v in place and
  returns the same tensors (the reference returns new arrays): a second
  copy of a 3 B-parameter state would not fit beside the first on one
  card.  The step counters are new tensors.
- The decay mask counts the reference's layer axis.  There every leaf
  under the stack carries it, so ``p.ndim >= 2`` holds for a per-layer
  bias (``bo``, ``bi``) and it decays; here that leaf is 1-D, so a leaf
  under ``layers`` counts one dimension more.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, *trees, path=()):
    """``fn(path, *leaves)`` over nested dicts and lists of the same
    structure; ``path`` is the tuple of dict keys and list indices."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), path=path + (k,))
                for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees), path=path + (i,))
                for i in range(len(first))]
    return fn(path, *trees)


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda _, a: out.append(a), tree)
    return out


def schedule(opt: OptConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; fp32, on the
    step's device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return opt.lr * warm * (opt.min_lr_ratio + (1 - opt.min_lr_ratio) * cos)


def init_opt_state(params) -> dict:
    """m and v as fp32 zeros shaped like ``params``; the step, int32 0."""
    device = tree_leaves(params)[0].device
    zeros = lambda: tree_map(lambda _, a: torch.zeros(  # noqa: E731
        a.shape, dtype=torch.float32, device=a.device), params)
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """The L2 norm of every leaf together, in fp32, leaf sums added in
    order as the reference's Python ``sum`` adds them."""
    total = 0
    for g in tree_leaves(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda _, g: g * scale, grads), norm


_NO_DECAY = ("scale", "bias", "b_i", "b_f", "b_gates", "dt_bias", "A_log", "D",
             "norm_scale", "hnorm_scale", "ffn_norm_scale", "q_scale",
             "k_scale", "attn_out_scale", "ssm_out_scale")


def _decay_mask(path) -> bool:
    """Decay weights only for >=2-D matrices (not norms/biases/gates):
    the reference's name test; the dimension test is in
    :func:`adamw_update`."""
    name = path[-1] if path and isinstance(path[-1], str) else ""
    return name not in _NO_DECAY


def _ndim_as_stored(path, p) -> int:
    """``p``'s dimensions in the reference's layout: one more under
    ``layers``, where the reference stacks the layers."""
    return p.dim() + int(bool(path) and path[0] == "layers")


def adamw_update(params, grads, state, opt: OptConfig, *, grad_norm=None):
    """One AdamW step; returns (params, new_state, metrics).  ``params``,
    ``state["m"]`` and ``state["v"]`` are updated in place; ``grads`` are
    read only.  Metrics: ``grad_norm`` (before clipping) and ``lr``.
    ``grad_norm``, when given, is the norm to clip by: a sharded step's
    trees hold this rank's shards, and the norm is over all of them."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, opt.clip_norm)
    step = state["step"] + 1
    lr = schedule(opt, step)
    b1, b2 = opt.beta1, opt.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(path, p, g, m, v):
        g = (g * scale).float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / ((v / bc2).sqrt() + opt.eps)
        if _decay_mask(path) and _ndim_as_stored(path, p) >= 2:
            delta = delta + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    with torch.no_grad():
        tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
