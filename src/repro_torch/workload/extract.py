"""Training-step extraction: recorded collectives -> replayable ``Workload``.

Port of ``repro.workload.extract``.  The bridge from the repo's *runtime*
half (training and serving steps over ``torch.distributed`` groups) to its
*simulator* half: record a step's collective sequence in program order
(:func:`repro_torch.core.collectives.record_collectives`, where the
reference walks compiled HLO with ``collective_sequence``) and lower each
op onto a :class:`~repro_torch.fabric.Fabric`'s own step schedules as
barrier-phased :class:`~repro_torch.sim.workloads.Workload` phases, with
byte-accurate message sizes (``bytes_per_packet`` = the simulated link's
per-cycle payload).

Lowering table (per op of group size N = the fabric's switch count,
``raw`` = the op's per-rank result bytes, ``ceil`` division throughout):

================== ======================== ==========================
op                 Workload phases          messages per (src, dst)
================== ======================== ==========================
all-to-all         ``all_to_all`` schedule  ``raw / (N * bpp)``
all-reduce         ``all_reduce`` sequence  ``raw / (N * bpp)``
reduce-scatter     ``reduce_scatter`` half  ``raw / bpp``
all-gather         ``all_gather`` half      ``raw / (N * bpp)``
collective-permute one phase from its       ``raw / bpp``
                   ``pairs``
================== ======================== ==========================

(The reduce-scatter row uses ``raw / bpp`` because the recorded size is
the *scattered output* shard, of which each schedule step moves one full
copy; the other rows split an unsharded payload N ways.)

An op whose group size differs from the fabric's switch count cannot be
laid onto that fabric's schedules one-to-one: ``strict=True`` (default)
raises, ``strict=False`` skips the op — the caller decides whether a
partial replay is meaningful.  An op with ``count`` k repeats its phases
k times.

The three steps of the reference (:func:`moe_step_ops`,
:func:`dp_step_ops`, :func:`pipeline_step_ops`) build on the calling
process's default group, whose size must be ``num_devices``, run once
under the recorder and return the ops.  :func:`extract_ops` runs one of
them on ``num_devices`` gloo ranks on the CPU, each a process of its own,
or in this process as rank 0 of torch's ``"fake"`` process group (the
recording group), whose collectives complete at once and move nothing:
the shapes and the order of every call are the real ones, the values
that arrive are not, so a recording run's outputs are never results.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.collectives import CollectiveOp, record_collectives
from repro_torch.fabric import Fabric, make_fabric
from repro_torch.models import ModelConfig, init_params
from repro_torch.models.layers import AxisRules
from repro_torch.models.moe import apply_moe, expert_slice, init_moe
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import OptConfig
from repro_torch.runtime.manual_dp import make_manual_dp_train_step
from repro_torch.runtime.pipeline import make_pipeline_loss_fn
from repro_torch.runtime.trainer import init_train_state
from repro_torch.sim.workloads import Phase, Workload, collective_workload

__all__ = ["workload_from_ops", "moe_step_ops", "dp_step_ops",
           "pipeline_step_ops", "extract_ops", "COLLECTIVE_TO_SCHEDULE"]

#: op -> (collective_workload name, payload divisor is N).
COLLECTIVE_TO_SCHEDULE = {
    "all-to-all": ("all_to_all", True),
    "all-reduce": ("all_reduce", True),
    "reduce-scatter": ("reduce_scatter", False),
    "all-gather": ("all_gather", True),
}


def _permute_phases(op: CollectiveOp, n: int, messages: int) -> list[Phase]:
    """A collective-permute is already a single explicit matching."""
    src = tuple(a for a, b in op.pairs if a != b)
    dst = tuple(b for a, b in op.pairs if a != b)
    if not src:
        return []
    bad = [v for v in src + dst if not 0 <= v < n]
    if bad:
        raise ValueError(
            f"collective-permute references device {bad[0]} outside the "
            f"fabric's [0, {n}) switch range")
    return [Phase(src, dst, messages=messages)]


def workload_from_ops(ops, fabric, *, bytes_per_packet: int = 8192,
                      strict: bool = True, name: str | None = None
                      ) -> Workload:
    """Lower a recorded collective sequence (:class:`CollectiveOp` s in
    program order) onto ``fabric``.

    ``fabric`` is anything :func:`repro_torch.fabric.make_fabric` accepts
    (or an ``(instance, n)`` tuple); ``bytes_per_packet`` sets the
    simulated link's per-cycle payload (message sizes round *up*, so the
    replayed bound never undercounts wire time).  Returns a phased
    :class:`Workload` replayable on both engines; raises if the sequence
    carries no lowerable collective.
    """
    if isinstance(fabric, Fabric):
        fab = fabric
    elif isinstance(fabric, tuple):
        fab = make_fabric(*fabric)
    else:
        fab = make_fabric(fabric)
    n = int(fab.num_switches)
    if bytes_per_packet < 1:
        raise ValueError(f"bytes_per_packet must be >= 1, "
                         f"got {bytes_per_packet}")
    seq = list(ops)
    phases: list[Phase] = []
    skipped = 0
    for op in seq:
        if op.kind != "collective-permute" and op.group_size != n:
            if strict:
                raise ValueError(
                    f"{op.kind} has replica group size {op.group_size} but "
                    f"fabric {fab.name!r} has {n} switches; extract with a "
                    f"matching fabric, or pass strict=False to skip "
                    f"mismatched ops")
            skipped += op.count
            continue
        if op.kind == "collective-permute":
            messages = max(1, math.ceil(op.raw_bytes / bytes_per_packet))
            per_op = _permute_phases(op, n, messages)
        else:
            sched_name, split_n = COLLECTIVE_TO_SCHEDULE[op.kind]
            div = bytes_per_packet * (n if split_n else 1)
            messages = max(1, math.ceil(op.raw_bytes / div))
            per_op = list(collective_workload(
                fab, sched_name, message_size=messages).phases)
        for _ in range(max(op.count, 1)):
            phases.extend(per_op)
    if not phases:
        raise ValueError(
            f"no lowerable collectives found for fabric {fab.name!r} "
            f"({len(seq)} parsed, {skipped} skipped on group-size "
            f"mismatch); was the program compiled for {n} devices?")
    return Workload(name or f"{fab.name}-ops", n, tuple(phases))


# ---------------------------------------------------------------------------
# The reference's three steps, built on the default process group.
# ---------------------------------------------------------------------------

def _check_world(num_devices: int):
    world = dist.get_world_size()
    if world != num_devices:
        raise ValueError(f"the default process group has {world} ranks, "
                         f"not num_devices={num_devices}")


def _mesh(shape, names, device):
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def _tiny_dense_cfg(name: str, *, num_layers: int, d_model: int):
    """The reference's small dense model, with two heads of ``d_model/2``
    in place of four of ``d_model/4`` (and one KV head in place of two):
    the same weight shapes in total, so the same collectives, and a head
    dim the card's attention kernel takes (16 at the default width)."""
    return ModelConfig(name=name, family="dense", num_layers=num_layers,
                       d_model=d_model, num_heads=2, num_kv_heads=1,
                       d_ff=2 * d_model, vocab_size=64)


def moe_step(num_devices: int, *, dp: int = 1, d_model: int = 32,
             d_ff: int = 16, num_experts: int | None = None, batch: int = 4,
             seq: int = 8, cfg=None, device="cuda"):
    """One expert-parallel MoE forward, ready to run: returns ``run() ->
    y``.  The EP axis spans ``num_devices // dp`` ranks (the ``"model"``
    mesh axis the LACIN dispatch/combine all-to-alls ride); this rank
    holds its slice of the experts and ``batch // dp`` rows of tokens.
    ``cfg`` (a model's config) replaces the small one the other arguments
    build, in its own ``dtype``; the small one runs in fp32, as the
    reference's does.  The losses are not computed: the reference's step
    returns ``y`` alone, so its compiled program drops them."""
    _check_world(num_devices)
    ep = num_devices // dp
    if ep * dp != num_devices:
        raise ValueError(f"dp={dp} must divide num_devices={num_devices}")
    if batch % dp:
        raise ValueError(f"batch={batch} must divide over dp={dp}")
    if cfg is None:
        cfg = ModelConfig(
            name="extract-moe", family="moe", num_layers=1, d_model=d_model,
            num_heads=4, num_kv_heads=2, d_ff=d_ff, vocab_size=64,
            num_experts=num_experts if num_experts is not None else ep,
            top_k=2, expert_pad_to=1, capacity_factor=2.0, dtype="float32")
    dtype = getattr(torch, cfg.dtype)
    mesh = _mesh((dp, ep), ("data", "model"), device)
    rules = AxisRules(dp=("data",), tp="model", mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    p = expert_slice(init_moe(gen, cfg, dtype), mesh.get_local_rank("model"),
                     ep)
    x = torch.randn((batch // dp, seq, cfg.d_model), generator=gen,
                    device=device).to(dtype)
    return lambda: apply_moe(p, x, cfg, rules, losses=False)[0]


def dp_step(num_devices: int, *, d_model: int = 32, num_layers: int = 1,
            batch: int = 8, seq: int = 8, compress: bool = False, cfg=None,
            data=None, device="cuda"):
    """One explicit-DP train step
    (:func:`repro_torch.runtime.manual_dp.make_manual_dp_train_step`),
    ready to run: returns ``run() -> (state, metrics)``; the LACIN
    reduce-scatter + all-gather gradient reduction posts one
    collective-permute per matching step.  ``cfg`` replaces the small
    model; ``data`` (the global batch, ``tokens`` and ``labels``) the
    reference's zeros of (batch, seq)."""
    _check_world(num_devices)
    if cfg is None:
        cfg = _tiny_dense_cfg("extract-dp", num_layers=num_layers,
                              d_model=d_model)
    if data is None:
        if batch % num_devices:
            raise ValueError(f"batch={batch} must divide over "
                             f"num_devices={num_devices}")
        zeros = torch.zeros((batch, seq), dtype=torch.int64, device=device)
        data = {"tokens": zeros, "labels": zeros}
    mesh = _mesh((num_devices,), ("data",), device)
    step = make_manual_dp_train_step(cfg, mesh, OptConfig(),
                                     compress=compress)
    state = init_train_state(0, cfg, device=device)
    return lambda: step(state, data)


def pipeline_step(num_devices: int, *, d_model: int = 32,
                  layers_per_stage: int = 1, n_micro: int = 2,
                  batch: int = 4, seq: int = 8, device="cuda"):
    """One GPipe-style pipeline loss
    (:func:`repro_torch.runtime.pipeline.make_pipeline_loss_fn`), ready to
    run: returns ``run() -> loss``; the stage-to-stage shifts post one
    collective-permute with neighbour pairs per tick."""
    _check_world(num_devices)
    cfg = _tiny_dense_cfg("extract-pipe",
                          num_layers=num_devices * layers_per_stage,
                          d_model=d_model)
    mesh = _mesh((num_devices,), ("pipe",), device)
    loss_fn = make_pipeline_loss_fn(cfg, mesh, n_micro=n_micro)
    params = init_params(0, cfg, device=device)
    zeros = torch.zeros((batch, seq), dtype=torch.int64, device=device)
    return lambda: loss_fn(params, {"tokens": zeros, "labels": zeros})


def record(run) -> list[CollectiveOp]:
    """The collectives ``run()`` posts, in program order."""
    with record_collectives() as ops:
        run()
    return ops


def moe_step_ops(num_devices: int, **kw) -> list[CollectiveOp]:
    """The ops of one :func:`moe_step` (its arguments and defaults are
    the reference's ``moe_step_hlo``'s)."""
    return record(moe_step(num_devices, **kw))


def dp_step_ops(num_devices: int, **kw) -> list[CollectiveOp]:
    """The ops of one :func:`dp_step` (the reference's ``dp_step_hlo``)."""
    return record(dp_step(num_devices, **kw))


def pipeline_step_ops(num_devices: int, **kw) -> list[CollectiveOp]:
    """The ops of one :func:`pipeline_step` (the reference's
    ``pipeline_step_hlo``)."""
    return record(pipeline_step(num_devices, **kw))


STEPS = {"moe": moe_step_ops, "dp": dp_step_ops,
         "pipeline": pipeline_step_ops}


# ---------------------------------------------------------------------------
# Running a step on every rank.
# ---------------------------------------------------------------------------

def ops_to_json(ops) -> list:
    return [[op.kind, op.raw_bytes, op.group_size, op.count,
             [list(pair) for pair in op.pairs]] for op in ops]


def ops_from_json(rows) -> list[CollectiveOp]:
    return [CollectiveOp(kind, raw, group, count,
                         tuple(tuple(pair) for pair in pairs))
            for kind, raw, group, count, pairs in rows]


def same_ops(per_rank) -> list[CollectiveOp]:
    """The one sequence every rank recorded; raises where they differ.

    Ranks of different groups of one mesh axis (an MoE step with ``dp >
    1``) record the same ops with each group's own pairs: those are
    united, sorted by source, as one SPMD program's permute holds every
    group's pairs."""
    first = per_rank[0]
    for r, ops in enumerate(per_rank):
        shape = [(o.kind, o.raw_bytes, o.group_size, o.count) for o in ops]
        if shape != [(o.kind, o.raw_bytes, o.group_size, o.count)
                     for o in first]:
            raise AssertionError(f"rank {r} recorded other collectives than "
                                 f"rank 0")
    if all(ops == first for ops in per_rank):
        return list(first)
    merged = []
    for i, op in enumerate(first):
        pairs = {p for ops in per_rank for p in ops[i].pairs}
        sources = [a for a, _ in pairs]
        targets = [b for _, b in pairs]
        if (len(set(sources)) != len(sources)
                or len(set(targets)) != len(targets)):
            raise AssertionError(f"op {i}: the ranks' pairs {sorted(pairs)} "
                                 f"are not one permutation")
        merged.append(CollectiveOp(op.kind, op.raw_bytes, op.group_size,
                                   op.count, tuple(sorted(pairs))))
    return merged


_RANK_CHILD = r"""
import datetime, json, sys
import torch, torch.distributed as dist
a = json.loads(sys.argv[1])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(a["store"], a["world"]),
                        rank=a["rank"], world_size=a["world"],
                        timeout=datetime.timedelta(seconds=a["timeout"]))
from repro_torch.workload.extract import STEPS, ops_to_json
ops = STEPS[a["step"]](a["world"], device="cpu", **a["step_kw"])
dist.barrier()
dist.destroy_process_group()
print(json.dumps(ops_to_json(ops)))
"""


def _gloo_ops(step: str, num_devices: int, step_kw: dict,
              timeout: float) -> list[list[CollectiveOp]]:
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK_CHILD, json.dumps(dict(
                store=store, world=num_devices, rank=r, step=step,
                step_kw=step_kw, timeout=timeout))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(num_devices)]
        outs, errors = [], []
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        try:
            for r, p in enumerate(procs):
                left = (deadline - datetime.datetime.now()).total_seconds()
                try:
                    out, err = p.communicate(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    errors.append(f"rank {r}: no result in {timeout} s")
                    continue
                if p.returncode:
                    errors.append(f"rank {r}: exit {p.returncode}\n"
                                  f"{err[-3000:]}")
                else:
                    outs.append(ops_from_json(json.loads(
                        out.strip().splitlines()[-1])))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


@contextlib.contextmanager
def recording_group(num_devices: int, rank: int = 0):
    """This process as ``rank`` of a ``num_devices``-rank default group
    under torch's ``"fake"`` backend for the block: every collective
    completes at once and moves nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "recording group needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=num_devices)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_ops(step: str, num_devices: int, step_kw: dict, device,
              ranks) -> list[list[CollectiveOp]]:
    outs = []
    for rank in ranks:
        with recording_group(num_devices, rank):
            outs.append(STEPS[step](num_devices, device=device, **step_kw))
    return outs


def extract_ops(step: str, num_devices: int, *, group: str = "fake",
                device="cuda", timeout: float = 240.0,
                **step_kw) -> list[CollectiveOp]:
    """The ops of one ``step`` ("moe", "dp" or "pipeline", with
    ``step_kw``) on ``num_devices`` ranks, checked equal on every rank
    that ran it (:func:`same_ops`).

    ``group="gloo"``: every rank a process of its own on the CPU (a
    ``FileStore`` in a temporary directory, ``timeout`` seconds in all).
    ``group="fake"``: in this process, as rank 0 of the recording group
    on ``device`` (an MoE step with ``dp > 1``: once as the first rank of
    each EP group)."""
    if step not in STEPS:
        raise ValueError(f"unknown step {step!r}; choose from {sorted(STEPS)}")
    if group == "gloo":
        per_rank = _gloo_ops(step, num_devices, step_kw, timeout)
    elif group == "fake":
        device = resolve_device(device)
        dp = step_kw.get("dp", 1) if step == "moe" else 1
        per_rank = _fake_ops(step, num_devices, step_kw, device,
                             range(0, num_devices, max(num_devices // dp, 1)))
    else:
        raise ValueError(f"group must be 'fake' or 'gloo', got {group!r}")
    return same_ops(per_rank)
