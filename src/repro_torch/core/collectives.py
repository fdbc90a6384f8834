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

Each step is one :func:`ppermute` of the step's matching: one
``dist.batch_isend_irecv`` (a send to the step's target and a receive from
its source, waited on before the next step), the counterpart of one
``lax.ppermute``.  Its backward runs the inverse exchange, the transpose of
``ppermute``, so gradients flow through every chain.  ``exchanges`` counts
the steps this process has posted.

:func:`record_collectives` is the port's counterpart of the reference's
``collective_sequence`` over compiled HLO (``repro.launch.hlo_analysis``):
while it is open, every collective this process posts appends a
:class:`CollectiveOp`.  A matching step is one ``collective-permute`` whose
``pairs`` hold the step's whole matching over global ranks, so every rank
records the same sequence whatever its place, as every device's HLO holds
the same program; :func:`library_all_reduce` is one ``all-reduce``.  (In a
backward, the rank that an odd-size circle schedule leaves idle at a step
took nothing from that step, so it runs and records none of its inverse.)

``axis_size`` is optional: when given it must equal the group's size.  The
mesh-aware front-end (``repro_torch.fabric.LacinCollectives`` and the
hierarchical schedules) builds on these single-axis chains.
"""
from __future__ import annotations

import contextlib
import functools
import warnings
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch._compat import LacinDeprecationWarning

from .schedule import LacinSchedule, make_schedule

#: Matching steps posted by this process (forward and backward), each one
#: ``batch_isend_irecv``.
exchanges = 0

#: The ``torch.distributed`` calls that :func:`record_collectives` counts.
COUNTED_CALLS = ("batch_isend_irecv", "all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single", "broadcast")


@dataclass(frozen=True)
class CollectiveOp:
    """One collective in program order (see :func:`record_collectives`).

    Fields and meanings are the reference's ``repro.launch.hlo_analysis.
    CollectiveOp``: ``raw_bytes`` is the per-rank result size (a
    collective-permute's chunk, an all-gather's gathered tensor, a
    reduce-scatter's output shard, an all-reduce's or all-to-all's whole
    tensor); ``count`` is a repeat multiplier; ``pairs`` holds a
    collective-permute's (source, target) global ranks (empty otherwise).
    """
    kind: str
    raw_bytes: int
    group_size: int
    count: int = 1
    pairs: tuple = ()


class _Recording:
    """The open recording: the ops, and per ``torch.distributed`` call the
    number posted and the number the ops account for."""

    def __init__(self):
        self.ops: list[CollectiveOp] = []
        self.posted: Counter = Counter()
        self.accounted: Counter = Counter()


_recording: _Recording | None = None


def _note(kind: str, raw_bytes: int, group_size: int, pairs=(),
          calls: dict | None = None):
    """Append one op to the open recording (none open: nothing); ``calls``
    are the ``torch.distributed`` calls this rank posts for it."""
    if _recording is None:
        return
    _recording.ops.append(CollectiveOp(kind, int(raw_bytes), int(group_size),
                                       1, tuple(pairs)))
    _recording.accounted.update(calls or {})


def _counting(name: str, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _recording is not None:
            _recording.posted[name] += 1
        return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def record_collectives():
    """``with record_collectives() as ops:`` appends to ``ops`` a
    :class:`CollectiveOp` for every collective this process posts inside
    the block, in program order.

    While it is open, every ``torch.distributed`` call in
    :data:`COUNTED_CALLS` is counted, and leaving the block raises if one
    was posted that no recorded op accounts for: a collective the recorder
    missed would otherwise vanish from the extracted workload.  Outside it
    the collectives run exactly as before.  Recordings do not nest.
    """
    global _recording
    if _recording is not None:
        raise RuntimeError("record_collectives() is already open")
    rec = _Recording()
    saved = {name: getattr(dist, name) for name in COUNTED_CALLS}
    for name, fn in saved.items():
        setattr(dist, name, _counting(name, fn))
    _recording = rec
    try:
        yield rec.ops
    finally:
        _recording = None
        for name, fn in saved.items():
            setattr(dist, name, fn)
    missed = {name: rec.posted[name] - rec.accounted[name]
              for name in COUNTED_CALLS
              if rec.posted[name] != rec.accounted[name]}
    if missed:
        raise RuntimeError(
            f"torch.distributed calls posted while recording that no "
            f"recorded collective accounts for (posted minus accounted): "
            f"{missed}")


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


def _peers(pairs, me: int) -> tuple[int | None, int | None]:
    """This rank's target and source in ``pairs`` (None: it sends or
    receives nothing); raises where a rank sends or receives twice."""
    targets = [b for a, b in pairs if a == me]
    sources = [a for a, b in pairs if b == me]
    if len(targets) > 1 or len(sources) > 1:
        raise ValueError(f"pairs {pairs} are not a permutation: rank {me} "
                         f"sends to {targets} and receives from {sources}")
    return (targets[0] if targets else None,
            sources[0] if sources else None)


def _permute(x: torch.Tensor, pairs, group) -> torch.Tensor:
    """One ``lax.ppermute`` of ``x`` along ``pairs`` (group ranks): this
    rank's value goes to its target, its source's arrives; a rank that
    receives nothing gets zeros, one paired with itself keeps its value."""
    global exchanges
    n, me = _size_and_rank(group, None)
    target, source = _peers(pairs, me)
    if target == me:
        out, ops = x.clone(), []
    else:
        out = (torch.empty_like(x) if source is not None
               else torch.zeros_like(x))
        ops = []
        if target is not None:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  _global_rank(group, target)))
        if source is not None:
            ops.append(dist.P2POp(dist.irecv, out,
                                  _global_rank(group, source)))
    _note("collective-permute", x.numel() * x.element_size(), n,
          [(_global_rank(group, a), _global_rank(group, b)) for a, b in pairs],
          {"batch_isend_irecv": 1} if ops else None)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        exchanges += 1
    return out


class _Permute(torch.autograd.Function):
    """A differentiable :func:`ppermute`; backward sends the gradient back
    along the inverse pairs (the transpose of ``lax.ppermute``)."""

    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _permute(x, pairs, group)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, tuple((b, a) for a, b in ctx.pairs),
                        ctx.group), None, None


def ppermute(x: torch.Tensor, pairs, group=None) -> torch.Tensor:
    """``lax.ppermute(x, axis, pairs)`` over ``group``: ``pairs`` are
    (source, target) ranks of the group, each rank at most once on each
    side.  Every rank of the group calls it; one that neither sends nor
    receives gets zeros and posts nothing.  Recorded as one
    ``collective-permute`` holding all the pairs; differentiable."""
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    return _Permute.apply(x, pairs, group)


def _steps(sched: LacinSchedule, me: int):
    """(matching, target, source) per non-empty step; an idle rank (odd-N
    circle) is its own target and source."""
    for step in range(sched.num_steps):
        perm = sched.perm(step)
        if perm:
            yield perm, sched.table[step][me], sched.inv_table[step][me]


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
    for perm, target, source in _steps(sched, me):
        recv = ppermute(x[target], perm, group)
        # Idle rank (odd-N circle): target == source == me; keep own chunk.
        if source != me:
            out[source] = recv
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
    for perm, _, source in _steps(sched, me):
        recv = ppermute(x, perm, group)
        if source != me:
            out[source] = recv
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
    for perm, target, source in _steps(sched, me):
        recv = ppermute(x[target], perm, group)
        if source != me:
            acc = acc + recv
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


def _library_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _note("all-reduce", out.numel() * out.element_size(),
          dist.get_world_size(group), calls={"all_reduce": 1})
    dist.all_reduce(out, group=group)
    return out


class _LibrarySum(torch.autograd.Function):
    """A differentiable library all-reduce: the gradient of a sum over the
    group is the sum of the gradients (``lax.psum``'s transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _library_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _library_sum(grad, ctx.group), None


def library_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over ``group`` by the library's own ``dist.all_reduce`` (the
    reference's ``lax.psum``), on a copy; differentiable, and recorded as
    one ``all-reduce`` of the whole tensor (forward and backward)."""
    return _LibrarySum.apply(x, group)


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
