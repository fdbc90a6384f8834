"""Token-choice top-k MoE with LACIN expert-parallel dispatch.

Port of ``repro.models.moe``.  The expert-parallel (EP) path is the paper's
technique made first-class: expert shards live on the "model" mesh axis,
and the dispatch/combine all-to-alls execute as a LACIN 1-factor step
schedule via the mesh-aware ``repro_torch.fabric.LacinCollectives`` (shard
count read from the mesh axis) — every step a perfect matching,
single-hop, contention-free.

Pipeline (per rank; the tokens are this rank's data-parallel shard,
replicated over the "model" axis, and the experts its slice of the store):

  router top-k -> capacity-bucketed sort-based dispatch (E, C, d)
  -> reshape (n_shards, E_loc*C, d) -> LACIN all-to-all ("model")
  -> expert FFN, batched matmul over local experts
  -> LACIN all-to-all back -> gate-weighted combine (+ dropped-token zeros)

``moe_impl='dense'``, rules without a "model" axis, or one of size 1 run
the same math without the all-to-all (single shard) — the path a single
card serves.  The products are ``torch.bmm``, the dispatch plain tensor
code, as the reference's are ``jnp.einsum`` and gathers outside any kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from repro_torch.core.collectives import library_all_reduce
from repro_torch.fabric import LacinCollectives
from .layers import AxisRules, dense_init, gelu_tanh, silu


def expert_store_count(cfg) -> int:
    """Experts as stored: padded to a multiple of ``expert_pad_to`` so the
    store shards evenly over the EP axis (granite: 40 -> 48)."""
    pad = max(cfg.expert_pad_to, 1)
    return -(-cfg.num_experts // pad) * pad


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    """The reference's distributions, drawn from ``gen``."""
    d, f = cfg.d_model, cfg.d_ff
    e = expert_store_count(cfg)
    p = {
        "router": dense_init(gen, (d, cfg.num_experts), dtype),
        "wi": dense_init(gen, (e, d, f), dtype, fan_in=d),
        "wo": dense_init(gen, (e, f, d), dtype, fan_in=f),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (e, d, f), dtype, fan_in=d)
    return p


def expert_slice(p: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s slice ``[rank*e_loc, (rank+1)*e_loc)`` of one MoE
    layer's expert store over ``n`` shards, the port's counterpart of the
    reference's ``P(tp)`` in-spec.  A store that does not divide ``n``
    (an off-spec config) is zero-padded first, as the reference pads it;
    the router stays whole."""
    e = p["wi"].shape[0]
    e_pad = -(-e // n) * n
    e_loc = e_pad // n
    out = dict(p)
    for name in ("wi", "wo", "wg"):
        if name in p:
            w = p[name]
            if e_pad != e:
                w = F.pad(w, (0, 0, 0, 0, 0, e_pad - e))
            out[name] = w[rank * e_loc:(rank + 1) * e_loc]
    return out


def _capacity(tokens: int, cfg) -> int:
    c = int(np.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest per row, ties to the lower index (a
    stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _dispatch_indices(eidx, num_experts: int, capacity: int):
    """Sort-based capacity bucketing.

    eidx: (N,) integer expert choice per assignment.  Returns (slot (N,),
    valid (N,)): position ``e*C + rank`` for assignments that fit, where
    ``rank`` counts earlier assignments to the same expert; the others get
    the overflow slot ``num_experts*C``.
    """
    n = eidx.shape[0]
    eidx = eidx.long()
    sort_idx = torch.argsort(eidx, stable=True)
    sorted_e = eidx[sort_idx]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=eidx.device), side="left")
    ranks_sorted = torch.arange(n, device=eidx.device) - seg_start[sorted_e]
    ranks = torch.empty_like(ranks_sorted).index_copy_(0, sort_idx,
                                                       ranks_sorted)
    valid = ranks < capacity
    slot = torch.where(valid, eidx * capacity + ranks,
                       torch.full_like(ranks, num_experts * capacity))
    return slot, valid


def _expert_ffn(p, x, cfg):
    """x: (E_loc, Cap, d) -> (E_loc, Cap, d), batched over local experts."""
    h = torch.bmm(x, p["wi"].to(x.dtype))
    if cfg.mlp == "swiglu":
        h = silu(torch.bmm(x, p["wg"].to(x.dtype))) * h
    elif cfg.mlp == "geglu":
        h = gelu_tanh(torch.bmm(x, p["wg"].to(x.dtype))) * h
    elif cfg.mlp == "squared_relu":
        r = F.relu(h)
        h = r * r
    else:
        h = gelu_tanh(h)
    return torch.bmm(h, p["wo"].to(x.dtype))


def _route(p, x, cfg, e: int, cap: int):
    """Router, top-k and dispatch: (logits, probs, gates, flat_e, slot,
    valid, buf (e*cap, d))."""
    t, d = x.shape
    k = cfg.top_k
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                 # (T, E_real)
    gates, eidx = _top_k(probs, k)                        # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = eidx.reshape(-1)                             # (N = T*k,)
    slot, valid = _dispatch_indices(flat_e, e, cap)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, torch.where(valid[:, None], x[tok_idx], 0))
    return logits, probs, gates, flat_e, slot, valid, buf[:-1]


def _combine(out_buf, slot, valid, gates, t: int, k: int, dtype):
    """Gate-weighted sum of each token's k expert outputs (dropped: 0)."""
    n_rows, d = out_buf.shape
    picked = torch.where(valid[:, None],
                         out_buf[slot.clamp(0, n_rows - 1)], 0)
    return (picked.reshape(t, k, d) * gates[..., None].to(dtype)).sum(dim=1)


def moe_losses(logits, probs, flat_e, t: int, k: int, reduce=None,
               shards: int = 1):
    """Switch-style load-balance aux loss and router z-loss from one
    call's router statistics (local to this rank).  ``reduce``, a sum over
    ``shards`` data-parallel shards of ``t`` tokens each, makes them the
    statistics of every shard's tokens together: what one device computes
    on the whole batch."""
    e_real = probs.shape[1]
    counts = torch.zeros((e_real,), dtype=torch.float32,
                         device=probs.device).index_add(
        0, flat_e.clamp(0, e_real - 1),
        torch.ones(flat_e.shape, dtype=torch.float32, device=probs.device))
    if reduce is None:
        me = probs.mean(dim=0)                            # (E_real,)
        ce = counts / max(t * k, 1)
        aux = e_real * (me * ce).sum()
        zloss = torch.logsumexp(logits, dim=-1).square().mean()
        return aux, zloss
    n = t * shards
    me = reduce(probs.sum(dim=0)) / n
    ce = reduce(counts) / max(n * k, 1)
    aux = e_real * (me * ce).sum()
    zloss = reduce(torch.logsumexp(logits, dim=-1).square().sum()) / n
    return aux, zloss


def _moe_local(p, x, cfg, coll: LacinCollectives | None, axis_name, *,
               losses: bool = True, reduce=None, shards: int = 1):
    """The per-rank MoE body.  x: (Tloc, d) local tokens.  Returns
    (y, aux, z); ``losses=False`` skips :func:`moe_losses` (aux and z are
    None), as serving does: the reference's jit drops them as dead code.

    ``coll`` is the mesh-bound LACIN collective set (None = dense / single
    shard); the EP shard count comes from the mesh axis it is bound to,
    so schedule and mesh can never disagree.

    ``p['wi']/['wo']/['wg']`` hold this rank's experts (the whole store on
    one shard); the store may be zero-padded so that it divides
    ``n_shards`` (e.g. granite's 40 -> 48): the router only ever selects
    real experts, so padding buckets stay empty but are computed.
    """
    n_shards = coll.axis_size(axis_name) if coll is not None else 1
    t, d = x.shape
    k = cfg.top_k
    # Bucket count: local expert rows times shards (== padded global count).
    e = p["wi"].shape[0] * n_shards
    cap = _capacity(t, cfg)

    logits, probs, gates, flat_e, slot, valid, buf = _route(p, x, cfg, e, cap)

    e_loc = e // n_shards
    if n_shards > 1:
        send = buf.reshape(n_shards, e_loc * cap, d)
        recv = coll.all_to_all(send, axis_name)
        # recv[j] = tokens from source shard j for MY local experts
        xin = (recv.reshape(n_shards, e_loc, cap, d).transpose(0, 1)
                   .reshape(e_loc, n_shards * cap, d))
    else:
        xin = buf.reshape(e_loc, cap, d)

    yout = _expert_ffn(p, xin, cfg)

    if n_shards > 1:
        back = (yout.reshape(e_loc, n_shards, cap, d).transpose(0, 1)
                    .reshape(n_shards, e_loc * cap, d))
        out_buf = coll.all_to_all(back, axis_name).reshape(e * cap, d)
    else:
        out_buf = yout.reshape(e * cap, d)

    y = _combine(out_buf, slot, valid, gates, t, k, x.dtype)
    if not losses:
        return y, None, None
    return (y, *moe_losses(logits, probs, flat_e, t, k, reduce, shards))


def apply_moe(p: dict, x, cfg, rules: AxisRules = AxisRules(), *,
              losses: bool = True):
    """x: (B, T, d) -> (y, aux_metrics dict).

    The EP path runs on every rank of the ``rules.tp`` group: ``x`` is this
    rank's data-parallel shard and ``p`` its expert slice
    (:func:`expert_slice`; ``repro_torch.models.convert.expert_shard`` for
    a whole model).  ``moe_aux`` and ``moe_z`` are then averaged over the
    ``rules.dp`` axes (the reference's ``lax.pmean``), or, with
    ``rules.global_router_stats``, computed from statistics summed over
    them (on either path).  The dense path
    runs inline (single shard, the whole store).  ``losses=False`` (prefill
    and decode) computes neither loss and returns an empty dict, so the
    data shards need not step together.
    """
    b, t, d = x.shape
    reduce, shards = _router_stats_sum(rules) if losses else (None, 1)
    if cfg.moe_impl == "dense" or rules.tp is None or rules.tp_size == 1:
        y2, aux, z = _moe_local(p, x.reshape(b * t, d), cfg, None, None,
                                losses=losses, reduce=reduce, shards=shards)
        return y2.reshape(b, t, d), ({"moe_aux": aux, "moe_z": z}
                                     if losses else {})

    # EP shard count and schedule both come from the mesh axis (the
    # mesh-aware API): no hand-threaded axis_size to disagree with it.
    coll = LacinCollectives(mesh=rules.mesh, instance="auto")
    n_shards = coll.axis_size(rules.tp)
    e_loc = -(-expert_store_count(cfg) // n_shards)
    if p["wi"].shape[0] != e_loc:
        raise ValueError(
            f"this rank holds {p['wi'].shape[0]} experts, not its slice of "
            f"{e_loc} of the store over {n_shards} shards (expert_slice)")
    y2, aux, z = _moe_local(p, x.reshape(b * t, d), cfg, coll, rules.tp,
                            losses=losses, reduce=reduce, shards=shards)
    if not losses:
        return y2.reshape(b, t, d), {}
    if reduce is None:
        for axis in rules.dp:
            n = rules.axis_size(axis)
            group = rules.mesh.get_group(axis)
            aux = library_all_reduce(aux, group) / n
            z = library_all_reduce(z, group) / n
    return y2.reshape(b, t, d), {"moe_aux": aux, "moe_z": z}


def _router_stats_sum(rules: AxisRules):
    """(sum over the ``dp`` axes, their shard count) where the rules ask
    for global router statistics, else (None, 1)."""
    if not (rules.global_router_stats and rules.dp and rules.mesh is not None):
        return None, 1
    groups = [rules.mesh.get_group(a) for a in rules.dp]

    def reduce(x):
        for group in groups:
            x = library_all_reduce(x, group)
        return x
    return reduce, rules.dp_size
