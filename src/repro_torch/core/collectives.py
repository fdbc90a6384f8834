"""LACIN-scheduled collectives: 1-factor step chains over a process group.

Port of ``repro.core.collectives``.  The reference runs these inside
``shard_map`` with a bound mesh axis; here the axis is a
``torch.distributed`` ``ProcessGroup`` (``None`` is the default group),
its size is ``dist.get_world_size(group)`` and this rank's place on it
``dist.get_rank(group)``.  Step ``i`` moves exactly the traffic the
port-``i`` 1-factor would carry on the physical CIN, so every step is a
perfect matching: contention-free by construction, with both endpoints of
every exchange using the same step index (the isoport property).

Wire-byte optimality (per rank, shard bytes ``b = B/N``):

==================  ==========  =================
collective           steps       bytes on wire
==================  ==========  =================
all_to_all_lacin     N-1         (N-1) * b   (optimal)
all_gather_lacin     N-1         (N-1) * b   (optimal)
reduce_scatter       N-1         (N-1) * b   (optimal)
all_reduce           2(N-1)      2(N-1) * b  (optimal, RS+AG)
==================  ==========  =================

Each step is one ``dist.batch_isend_irecv`` (a send to the step's target
and a receive from its source, waited on before the next step), the
counterpart of one ``lax.ppermute``.  Its backward runs the inverse
exchange, the transpose of ``ppermute``, so gradients flow through every
chain.  ``exchanges`` counts the steps this process has posted.

``axis_size`` is optional: when given it must equal the group's size.  The
mesh-aware front-end (``repro_torch.fabric.LacinCollectives`` and the
hierarchical schedules) builds on these single-axis chains.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from repro_torch._compat import LacinDeprecationWarning

from .schedule import LacinSchedule, make_schedule

#: Matching steps posted by this process (forward and backward), each one
#: ``batch_isend_irecv``.
exchanges = 0


def _size_and_rank(group, axis_size: int | None) -> tuple[int, int]:
    """The group's size (``axis_size`` must agree with it) and this rank's
    place on it."""
    n = dist.get_world_size(group)
    if axis_size is not None and int(axis_size) != n:
        raise ValueError(f"axis_size {axis_size} != the group's size {n}")
    return n, dist.get_rank(group)


def _global_rank(group, r: int) -> int:
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _exchange(send: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """One matching step: ``send`` to global rank ``dst``, the same shape
    back from global rank ``src``."""
    global exchanges
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), dst),
           dist.P2POp(dist.irecv, recv, src)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    exchanges += 1
    return recv


class _Step(torch.autograd.Function):
    """A differentiable exchange; backward sends the gradient back along
    the inverse matching (what arrived from ``src`` returns to it)."""

    @staticmethod
    def forward(ctx, send, dst: int, src: int):
        ctx.dst, ctx.src = dst, src
        return _exchange(send, dst, src)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.src, ctx.dst), None, None


def _steps(sched: LacinSchedule, me: int, group):
    """(target, source, global target, global source) per non-empty step."""
    for step in range(sched.num_steps):
        if not sched.perm(step):
            continue
        target = sched.table[step][me]
        source = sched.inv_table[step][me]
        yield (target, source, _global_rank(group, target),
               _global_rank(group, source))


# ---------------------------------------------------------------------------
# all-to-all
# ---------------------------------------------------------------------------

def all_to_all_lacin(x: torch.Tensor, group=None, *,
                     axis_size: int | None = None,
                     instance: str = "auto") -> torch.Tensor:
    """Personalized all-to-all over ``group``.

    ``x`` has leading dim ``N``; ``x[j]`` is this rank's chunk for rank
    ``j``.  Returns ``out`` with ``out[j]`` = chunk from rank ``j`` for this
    rank.  N-1 matching steps; step ``i`` exchanges with the 1-factor-``i``
    partner.
    """
    n, me = _size_and_rank(group, axis_size)
    sched = make_schedule(instance, n)
    out = [None] * n
    out[me] = x[me]
    for target, source, dst, src in _steps(sched, me, group):
        # Idle rank (odd-N circle): target == source == me; keep own chunk.
        if source != me:
            out[source] = _Step.apply(x[target], dst, src)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# all-gather
# ---------------------------------------------------------------------------

def all_gather_lacin(x: torch.Tensor, group=None, *,
                     axis_size: int | None = None, instance: str = "auto",
                     tiled: bool = False) -> torch.Tensor:
    """All-gather this rank's shard across ``group``.

    Every step sends the *original* shard to the step partner — on a CIN
    each shard travels exactly one hop to each consumer.  Returns shape
    ``(N, *x.shape)`` or concatenated along axis 0 if ``tiled``.
    """
    n, me = _size_and_rank(group, axis_size)
    sched = make_schedule(instance, n)
    out = [None] * n
    out[me] = x
    for _, source, dst, src in _steps(sched, me, group):
        if source != me:
            out[source] = _Step.apply(x, dst, src)
    out = torch.stack(out)
    if tiled:
        out = out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out


# ---------------------------------------------------------------------------
# reduce-scatter
# ---------------------------------------------------------------------------

def reduce_scatter_lacin(x: torch.Tensor, group=None, *,
                         axis_size: int | None = None,
                         instance: str = "auto") -> torch.Tensor:
    """Reduce-scatter over ``group``.

    ``x`` has leading dim ``N``; ``x[j]`` is this rank's contribution to
    rank ``j``'s output shard.  Each step sends the partner its addend
    directly (one hop) and accumulates the received one, in step order.
    Returns the reduced shard ``sum_s x_s[me]`` of shape ``x.shape[1:]``.
    """
    n, me = _size_and_rank(group, axis_size)
    sched = make_schedule(instance, n)
    acc = x[me]
    for target, source, dst, src in _steps(sched, me, group):
        if source != me:
            acc = acc + _Step.apply(x[target], dst, src)
    return acc


# ---------------------------------------------------------------------------
# all-reduce = reduce-scatter + all-gather
# ---------------------------------------------------------------------------

def all_reduce_lacin(x: torch.Tensor, group=None, *,
                     axis_size: int | None = None,
                     instance: str = "auto") -> torch.Tensor:
    """All-reduce (sum) of an arbitrary-shaped tensor over ``group``.

    RS+AG decomposition over a flattened, padded view: 2(N-1) matching
    steps, wire-optimal 2(N-1)/N * bytes.
    """
    shape, dtype = x.shape, x.dtype
    n, _ = _size_and_rank(group, axis_size)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shard = reduce_scatter_lacin(flat.reshape(n, -1), group, instance=instance)
    flat = all_gather_lacin(shard, group, instance=instance).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def library_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over ``group`` by the library's own ``dist.all_reduce`` (the
    reference's ``lax.psum``), on a copy; not differentiable."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# Deprecated shims (one release): superseded by the mesh-aware
# repro_torch.fabric.LacinCollectives front-end.
# ---------------------------------------------------------------------------

def tree_all_reduce_lacin(tree, group=None, *, axis_size: int | None = None,
                          instance: str = "auto"):
    """Deprecated: use
    ``repro_torch.fabric.LacinCollectives(mesh).tree_all_reduce``."""
    warnings.warn(
        "tree_all_reduce_lacin is deprecated; use "
        "repro_torch.fabric.LacinCollectives(mesh, instance=...)"
        ".tree_all_reduce(tree, axis)",
        LacinDeprecationWarning, stacklevel=2)
    return tree_map(lambda g: all_reduce_lacin(
        g, group, axis_size=axis_size, instance=instance), tree)


def psum_or_lacin(x, group=None, *, axis_size: int | None = None,
                  impl: str = "xla", instance: str = "auto"):
    """Deprecated: use
    ``repro_torch.fabric.LacinCollectives(mesh, impl=...).psum``.

    ``impl="xla"`` keeps the reference's name for the library's own
    all-reduce: here ``dist.all_reduce`` (:func:`library_all_reduce`)."""
    warnings.warn(
        "psum_or_lacin is deprecated; use "
        "repro_torch.fabric.LacinCollectives(mesh, instance=..., impl=...)"
        ".psum(x, axis)",
        LacinDeprecationWarning, stacklevel=2)
    if impl == "xla":
        _size_and_rank(group, axis_size)
        return library_all_reduce(x, group)
    return all_reduce_lacin(x, group, axis_size=axis_size, instance=instance)
