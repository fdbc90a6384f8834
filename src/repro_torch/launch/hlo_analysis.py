"""Roofline terms and collective wire bytes of a step, from the calls it
dispatches.

Port of ``repro.launch.hlo_analysis``.  The reference parses the
optimized HLO of a compiled step; the port has no compiled module, so it
records what the step dispatches instead (as ``workload.extract`` records
the ``torch.distributed`` calls of a step): :func:`record_step_collectives`
is a ``TorchDispatchMode`` that appends one
:class:`~repro_torch.core.collectives.CollectiveOp` for each collective
op that reaches the dispatcher, in program order.  That includes the
``_c10d_functional`` gathers and reductions behind DTensor's
``redistribute`` and ``full_tensor``, which
:func:`~repro_torch.core.collectives.record_collectives` (a wrapper of the
Python ``torch.distributed`` calls) cannot see.

:func:`collective_stats` applies the reference's wire-byte table to a
list of ops, per device and per collective kind (group size N, ``size``
the op's per-rank result bytes):

================== ===========================================
op                  wire bytes per device
================== ===========================================
all-reduce          2 (N-1)/N * size
all-gather          (N-1)/N * out_size
reduce-scatter      (N-1)   * out_size   (= (N-1)/N * in_size)
all-to-all          (N-1)/N * size
collective-permute  size
================== ===========================================

Any other kind (broadcast, scatter, gather, reduce) moves ``size``, the
reference's rule for every op outside its table.

:func:`roofline` is the reference's formula with the card's constants in
place of its TPU's.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.collectives import CollectiveOp

# NVIDIA H100 80GB HBM3, 700 W: the bf16 dense tensor-core peak and the
# HBM3 rate of NVIDIA's H100 SXM datasheet, as PERF.md reads them.
PEAK_FLOPS = 989e12        # bf16 FLOP/s per card
HBM_BW = 3.35e12           # bytes/s per card
# NVIDIA H100 80GB HBM3, 700 W: NVLink 4, 900 GB/s a card counting both
# directions (NVIDIA's H100 SXM datasheet), so 450e9 bytes/s each way.  A
# datasheet number: not measured (one card hosts one NCCL rank, ROADMAP
# C9).
LINK_BW = 450e9            # bytes/s per card, one direction

#: Dispatcher ops (namespace, name) of each collective kind.  ``c10d``
#: holds the process group's ops (``torch.distributed``'s calls), whose
#: first argument is the result they write in place; ``_c10d_functional``
#: (and its autograd twin) the functional ones DTensor posts, which return
#: the result.  ``wait_tensor`` and ``barrier`` move no data.
_KINDS = {
    "c10d": {
        "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
        "allgather_": "all-gather", "_allgather_base_": "all-gather",
        "allgather_coalesced_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "reduce_scatter_": "reduce-scatter",
        "_reduce_scatter_base_": "reduce-scatter",
        "reduce_scatter_tensor_coalesced_": "reduce-scatter",
        "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
        "send": "collective-permute", "recv_": "collective-permute",
        "recv_any_source_": "collective-permute",
        "broadcast_": "broadcast", "scatter_": "scatter",
        "gather_": "gather", "reduce_": "reduce"},
    "_c10d_functional": {
        "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
        "all_reduce_coalesced": "all-reduce",
        "all_reduce_coalesced_": "all-reduce",
        "all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_out": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all",
        "broadcast": "broadcast", "broadcast_": "broadcast"},
}
_KINDS["_c10d_functional_autograd"] = _KINDS["_c10d_functional"]


def wire_bytes(kind: str, raw: float, n: int) -> float:
    """Bytes one device puts on the wire for one op (the module's table)."""
    if kind == "all-reduce":
        return 2 * (n - 1) / max(n, 1) * raw
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / max(n, 1) * raw
    if kind == "reduce-scatter":
        return (n - 1) * raw
    return raw


@dataclass
class CollectiveStats:
    """Per-kind counts, result bytes and wire bytes per device (the
    reference's fields)."""
    counts: dict = field(default_factory=dict)
    raw_bytes: dict = field(default_factory=dict)
    wire_bytes: dict = field(default_factory=dict)
    total_wire_bytes: float = 0.0
    total_raw_bytes: float = 0.0

    def add(self, op: str, raw: float, wire: float, count: float = 1):
        self.counts[op] = self.counts.get(op, 0) + count
        self.raw_bytes[op] = self.raw_bytes.get(op, 0) + raw
        self.wire_bytes[op] = self.wire_bytes.get(op, 0) + wire
        self.total_raw_bytes += raw
        self.total_wire_bytes += wire


def collective_stats(ops) -> CollectiveStats:
    """The wire bytes per device of ``ops`` (``CollectiveOp``s, each
    weighted by its ``count``), by kind."""
    stats = CollectiveStats()
    for op in ops:
        stats.add(op.kind, op.raw_bytes * op.count,
                  wire_bytes(op.kind, op.raw_bytes, op.group_size)
                  * op.count, count=op.count)
    return stats


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _group_size(func, args) -> int:
    """The size of the group an op runs on: its ``ProcessGroup`` argument
    (``c10d``), or the group named by its last argument
    (``_c10d_functional``)."""
    if func.namespace == "c10d":
        return next(int(dist.ProcessGroup.unbox(a).size()) for a in args
                    if isinstance(a, torch.ScriptObject) and a._type()
                    .qualified_name().endswith("c10d.ProcessGroup"))
    return int(_resolve_process_group(args[-1]).size())


class _StepCollectives(TorchDispatchMode):
    """The dispatch mode behind :func:`record_step_collectives`."""

    def __init__(self, ops: list):
        super().__init__()
        self.ops = ops
        self._p2p = None        # the op a lone send or receive opened

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace not in _KINDS:
            return out
        kind = _KINDS[func.namespace].get(func._schema.name.split("::")[-1])
        if kind is None:
            return out
        raw = _nbytes(args[0] if func.namespace == "c10d" else out)
        op = CollectiveOp(kind, int(raw), _group_size(func, args))
        if kind == "collective-permute":
            # One exchange step posts a send and a receive of one size on
            # one group: one collective-permute, as record_collectives
            # counts it (a rank that only sends or only receives posts one
            # of them).
            pending, self._p2p = self._p2p, None
            if pending is not None and pending == op:
                return out
            self._p2p = op
        else:
            self._p2p = None
        self.ops.append(op)
        return out


@contextlib.contextmanager
def record_step_collectives():
    """``with record_step_collectives() as ops:`` appends to ``ops`` a
    :class:`CollectiveOp` (kind, per-rank result bytes, group size) for
    every collective dispatched inside the block, in program order: the
    process group's ops behind ``torch.distributed``'s calls and the
    functional ops behind DTensor's ``redistribute`` and ``full_tensor``.
    A send and the receive of the same size on the same group that follows
    it are one collective-permute; ``pairs`` stay empty (a rank sees only
    its own peer), and a rank that posts nothing in a permute records none
    (``record_collectives`` records it).  ``wait_tensor`` is not counted."""
    ops: list[CollectiveOp] = []
    with _StepCollectives(ops):
        yield ops


# ---------------------------------------------------------------------------
# Roofline terms.
# ---------------------------------------------------------------------------

@dataclass
class RooflineTerms:
    """All *_s terms are seconds per step, per device."""
    exec_gflops_per_dev: float
    hbm_gbytes_per_dev: float
    wire_gbytes_per_dev: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_gflops_total: float
    useful_ratio: float
    cost_analysis_flops: float
    cost_analysis_bytes: float

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def roofline(*, exec_flops_per_dev: float, hbm_bytes_per_dev: float,
             wire_bytes_per_dev: float, chips: int, model_flops_total: float,
             cost_flops: float = 0.0, cost_bytes: float = 0.0,
             links_per_chip: int = 1) -> RooflineTerms:
    """The reference's roofline (``repro.launch.hlo_analysis.roofline``)
    at :data:`PEAK_FLOPS`, :data:`HBM_BW` and :data:`LINK_BW`."""
    compute_s = exec_flops_per_dev / PEAK_FLOPS
    memory_s = hbm_bytes_per_dev / HBM_BW
    collective_s = wire_bytes_per_dev / (LINK_BW * links_per_chip)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_exec = exec_flops_per_dev * chips
    useful = model_flops_total / total_exec if total_exec else 0.0
    return RooflineTerms(
        exec_gflops_per_dev=exec_flops_per_dev / 1e9,
        hbm_gbytes_per_dev=hbm_bytes_per_dev / 1e9,
        wire_gbytes_per_dev=wire_bytes_per_dev / 1e9,
        chips=chips, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_gflops_total=model_flops_total / 1e9, useful_ratio=useful,
        cost_analysis_flops=cost_flops, cost_analysis_bytes=cost_bytes)
