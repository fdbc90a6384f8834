"""The plain reference of a decoder whose MLP is a token-choice top-k
mixture of experts, trained as ``reference/dense.py`` trains.

Per layer after attention: router logits over the published experts,
softmax, each token's ``top_k`` largest probabilities (ties to the lower
expert) renormalised to sum to 1 as its gates; each expert takes the
assignments made to it in token order up to its capacity (the
configuration's capacity factor times the mean load, rounded up to a
multiple of 4, at least 4) and drops the rest; a kept assignment adds its
gate times the expert's silu-gated MLP of the token; the aux terms are the
Switch load-balance loss (experts x the sum over experts of the mean
probability times the share of assignments) and the router z-loss (the
mean squared log-sum-exp of the logits).  The store's padding experts are
never routed to.  Each expert is computed on its own rows, in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import dense
from portbench.reference.dense import Ops, attention_block, norm



def capacity(tokens: int, sizes) -> int:
    c = math.ceil(tokens * sizes["top_k"] / sizes["num_experts"]
                  * sizes["capacity_factor"])
    return max(4, -(-c // 4) * 4)


def moe(p, x, sizes, ops: Ops):
    """x (B, T, d) -> (y (B, T, d), [aux, z])."""
    b, t, d = x.shape
    flat = x.reshape(b * t, d)
    n, k, e = flat.shape[0], sizes["top_k"], sizes["num_experts"]
    logits = ops.mm(flat, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True).clamp_min(1e-9)
    choice = idx[:, :k].reshape(-1)                       # token-major
    rank = (F.one_hot(choice, e).cumsum(0) - 1).gather(
        1, choice[:, None])[:, 0]
    kept = rank < capacity(n, sizes)
    y = torch.zeros_like(flat)
    flat_gates = gates.reshape(-1)
    for j in range(e):
        rows = torch.nonzero((choice == j) & kept)[:, 0]
        if rows.numel() == 0:
            continue
        tok = rows // k
        xe = flat[tok]
        h = F.silu(ops.mm(xe, p["wg"][j])) * ops.mm(xe, p["wi"][j])
        y = y.index_add(0, tok, ops.mm(h, p["wo"][j])
                        * flat_gates[rows, None])
    share = torch.bincount(choice, minlength=e).float() / (n * k)
    aux = e * (probs.mean(0) * share).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return y.reshape(b, t, d), torch.stack([aux, z])


def moe_layer(p, x, pos, sizes, ops: Ops):
    x = attention_block(p, x, pos, sizes, ops)
    y, aux = moe(p["moe"], norm(p["ln2"], x, sizes), sizes, ops)
    return x + y, aux


def train(params, batches, sizes, opt: dict, *, precision="float32"):
    """As ``dense.train``, with the MoE layer."""
    return dense.train(params, batches, sizes, opt, precision=precision,
                       layer=moe_layer)
