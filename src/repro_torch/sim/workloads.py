"""Collective replay: drive the packet simulator with LACIN schedules.

The paper's central claim is algebraic: isoport wiring makes every
1-factor step of a LACIN schedule contention-free
(:meth:`~repro_torch.core.schedule.LacinSchedule.is_contention_free`), so an
all-to-all completes in exactly ``num_steps`` link-serialization cycles.
This module *measures* that claim: it converts the repo's own schedules
— a flat :class:`~repro_torch.core.schedule.LacinSchedule`, the dimension-order
``all_to_all_grid`` step sequence of a HyperX, or the two-level
``all_reduce_two_level`` sequence of a Dragonfly (the reference's
``repro.fabric.collectives``) — into a :class:`Workload` and replays
it through the cycle-driven engines with queueing, credits, and VCs in
the loop.

A :class:`Workload` is an ordered list of *phases*.  Phase ``k``'s
packets become injection-eligible only once every packet of phases
``< k`` has been **delivered** (ejected at its destination) — the
bulk-synchronous discipline of a stepwise collective, where step ``k+1``
exchanges data that step ``k`` produced.  Both engines implement the
barrier natively (:class:`repro_torch.sim.engine.Engine` gates injection
candidates on the released phase; the torch cycle engine
:mod:`repro_torch.sim.xengine` carries the barrier in its step, so the
whole replay runs as one CUDA graph), and both report the cycle at which
each phase completed.

The headline comparison is measured completion against the schedule
algebra's contention-free lower bound (:attr:`Workload.ideal_cycles` =
``sum of per-phase messages`` = ``num_steps * message_size`` for uniform
messages): a phase that is a matching on its fabric meets the bound
exactly; the Dragonfly global steps — ``group_size`` flows sharing one
global link — exceed it by precisely the serialization the hierarchy
trades for 1/a-sized payloads.

Entry points, lowest to highest level::

    w = Workload.from_schedule(make_schedule("xor", 16))
    w = collective_workload(fabric, "all_to_all", message_size=2)
    stats = replay(topo, "minimal", w)            # on the card by default
    stats = fabric.replay("all_to_all")           # one-call Fabric surface

and declaratively, ``TrafficSpec("workload", {"collective": ...})`` runs
replays through :mod:`repro_torch.studies` (the bundled ``collective_replay``
spec compares CIN-16 / HyperX-256 / Dragonfly-72).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from .metrics import RunStats
from .traffic import Traffic

__all__ = ["Phase", "Workload", "collective_workload", "replay"]


@dataclass(frozen=True)
class Phase:
    """One barrier-delimited step: ``messages`` packets per (src, dst) pair.

    ``src[i] -> dst[i]`` are the step's flows (idle devices simply do not
    appear).  A schedule step that is a matching has each switch at most
    once on each side; the replay machinery does not require that — the
    anisoport ``cyclic`` baseline and hierarchical global steps are plain
    permutations/flows — but every pair must be a real move
    (``src != dst``).
    """
    src: tuple[int, ...]
    dst: tuple[int, ...]
    messages: int = 1

    def __post_init__(self):
        if len(self.src) != len(self.dst):
            raise ValueError(f"phase src/dst length mismatch: "
                             f"{len(self.src)} != {len(self.dst)}")
        if self.messages < 1:
            raise ValueError(f"messages must be >= 1, got {self.messages}")
        if any(a == b for a, b in zip(self.src, self.dst)):
            raise ValueError("a phase pair must move between distinct "
                             "switches (drop idle devices instead)")

    @property
    def num_packets(self) -> int:
        return len(self.src) * self.messages


@dataclass(frozen=True)
class Workload:
    """A phase-structured closed workload over ``num_switches`` switches.

    Replay semantics: all of phase ``k``'s packets inject (at most one
    per terminal per cycle) once phases ``< k`` are fully delivered.
    The packet-level ``gen`` field of the emitted :class:`Traffic`
    stores the phase *ordinal* (the barrier it waits behind), not a
    wall-clock generation cycle.
    """
    name: str
    num_switches: int
    phases: tuple[Phase, ...]

    def __post_init__(self):
        for k, ph in enumerate(self.phases):
            for v in ph.src + ph.dst:
                if not 0 <= v < self.num_switches:
                    raise ValueError(
                        f"{self.name}: phase {k} references switch {v} "
                        f"outside [0, {self.num_switches})")

    @property
    def num_phases(self) -> int:
        return len(self.phases)

    @property
    def num_packets(self) -> int:
        return sum(ph.num_packets for ph in self.phases)

    @property
    def ideal_cycles(self) -> int:
        """Contention-free lower bound on completion, in cycles.

        Each phase needs at least ``messages`` cycles of link time on
        its busiest link (one packet per directed link per cycle), and
        phases are barrier-serialized, so completion cannot beat the sum
        — ``num_steps * message_size`` for uniform messages.  The bound
        is *met with equality* when every phase is contention-free on
        the fabric (one flow per directed link, e.g. 1-factor steps on
        the CIN that defined them, under minimal routing).
        """
        return sum(ph.messages for ph in self.phases)

    # -- engine-facing form -------------------------------------------------
    def traffic(self) -> Traffic:
        """The closed :class:`Traffic` the engines replay.

        ``gen`` holds each packet's phase ordinal (its barrier), which
        also keeps the per-terminal FIFO order phase-monotone;
        ``offered == 0`` marks the workload closed, so engines default
        to drain mode.
        """
        if self.num_phases:
            src = np.concatenate([
                np.repeat(np.asarray(ph.src, dtype=np.int64), ph.messages)
                for ph in self.phases])
            dst = np.concatenate([
                np.repeat(np.asarray(ph.dst, dtype=np.int64), ph.messages)
                for ph in self.phases])
            gen = np.concatenate([
                np.full(ph.num_packets, k, dtype=np.int64)
                for k, ph in enumerate(self.phases)])
        else:
            src = dst = gen = np.zeros(0, dtype=np.int64)
        return Traffic(f"replay-{self.name}", src, dst, gen,
                       offered=0.0, horizon=max(self.num_phases, 1),
                       workload=self)

    def phase_cum(self, num_phases: int | None = None) -> np.ndarray:
        """Cumulative packet counts per phase (padded to ``num_phases``
        by repeating the total — padding phases complete instantly)."""
        counts = np.array([ph.num_packets for ph in self.phases],
                          dtype=np.int64)
        cum = np.cumsum(counts) if counts.size else np.zeros(0, np.int64)
        if num_phases is not None and num_phases > cum.size:
            total = cum[-1] if cum.size else 0
            cum = np.concatenate(
                [cum, np.full(num_phases - cum.size, total, np.int64)])
        return cum

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_schedule(cls, schedule, *, message_size: int = 1,
                      name: str | None = None) -> "Workload":
        """One phase per step of a :class:`~repro_torch.core.schedule.LacinSchedule`
        (idle devices — odd-N Circle — are dropped from their step)."""
        return cls(name or f"{schedule.instance}-{schedule.n}-a2a",
                   schedule.n,
                   tuple(_schedule_phases(schedule, message_size)))

    def to_dict(self) -> dict:
        return {"name": self.name, "num_switches": self.num_switches,
                "phases": [{"src": list(ph.src), "dst": list(ph.dst),
                            "messages": ph.messages}
                           for ph in self.phases]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Workload":
        phases = tuple(
            Phase(tuple(int(v) for v in ph["src"]),
                  tuple(int(v) for v in ph["dst"]),
                  messages=int(ph.get("messages", 1)))
            for ph in d["phases"])
        return cls(str(d["name"]), int(d["num_switches"]), phases)


# ---------------------------------------------------------------------------
# Builders: the repo's own collective step sequences, per fabric family.
# ---------------------------------------------------------------------------

def _grid_phase_lists(dims: Sequence[int], schedules, coord_of, index_of,
                      message_size: int) -> list[list[Phase]]:
    """Per-dimension phase lists, innermost dimension first (the order
    reference's ``all_to_all_grid`` composes): one
    phase per step of that dimension's schedule, exchanging along that
    dimension only."""
    n = math.prod(dims)
    coords = np.array([coord_of(s) for s in range(n)], dtype=np.int64)
    out = []
    for d in reversed(range(len(dims))):
        sched = schedules[d]
        phases = []
        for step in range(sched.num_steps):
            row = sched.partners(step)
            src, dst = [], []
            for s in range(n):
                digit = int(coords[s, d])
                partner = int(row[digit])
                if partner == digit:
                    continue                       # idle in this step
                nc = coords[s].copy()
                nc[d] = partner
                src.append(s)
                dst.append(index_of(tuple(nc.tolist())))
            phases.append(Phase(tuple(src), tuple(dst),
                                messages=message_size))
        out.append(phases)
    return out


def _grid_phases(dims: Sequence[int], schedules, coord_of, index_of,
                 message_size: int) -> list[Phase]:
    """Flattened dimension-order phases (the grid all-to-all sequence)."""
    return [ph for sub in _grid_phase_lists(dims, schedules, coord_of,
                                            index_of, message_size)
            for ph in sub]


def _cin_all_to_all(fab, message_size: int) -> Workload:
    return Workload.from_schedule(fab.schedule(), message_size=message_size,
                                  name=f"{fab.name}-a2a")


def _hyperx_all_to_all(fab, message_size: int) -> Workload:
    cfg = fab.config
    index_of = {tuple(cfg.switch_coord(s)): s
                for s in range(cfg.num_switches)}
    phases = _grid_phases(cfg.dims, fab.schedule(), cfg.switch_coord,
                          lambda c: index_of[c], message_size)
    return Workload(f"{fab.name}-a2a", cfg.num_switches, tuple(phases))


def _dragonfly_all_to_all(fab, message_size: int) -> Workload:
    """Dragonfly a2a as a (local x global) grid: local matching steps
    first (intra-group), then global steps pairing whole groups — each
    global step routes ``group_size`` flows l-g-l over one global link
    per group pair, the serialization the replay is there to measure."""
    c = fab.config
    a, g = c.group_size, c.num_groups
    sched = fab.schedule()
    phases = _grid_phases(
        (g, a), (sched["global"], sched["local"]),
        lambda s: (s // a, s % a),
        lambda coord: coord[0] * a + coord[1], message_size)
    return Workload(f"{fab.name}-a2a", c.switches, tuple(phases))


def _chain(*phase_lists) -> tuple[Phase, ...]:
    out: list[Phase] = []
    for pl in phase_lists:
        out.extend(pl)
    return tuple(out)


def _schedule_phases(sched, message_size: int, *, repeat: int = 1,
                     to_pairs=None) -> list[Phase]:
    """Phases of one schedule pass, optionally lifted to composite switch
    ids via ``to_pairs(step_row) -> (src, dst)`` lists."""
    phases = []
    for _ in range(repeat):
        for step in range(sched.num_steps):
            row = sched.partners(step)
            if to_pairs is None:
                s = np.arange(sched.n)
                live = row != s
                src = tuple(int(v) for v in s[live])
                dst = tuple(int(v) for v in row[live])
            else:
                src, dst = to_pairs(row)
            phases.append(Phase(src, dst, messages=message_size))
    return phases


def _cin_all_reduce(fab, message_size: int) -> Workload:
    """Flat all-reduce = reduce-scatter chain + all-gather chain: two
    passes over the 1-factor schedule."""
    sched = fab.schedule()
    phases = _schedule_phases(sched, message_size, repeat=2)
    return Workload(f"{fab.name}-allreduce", fab.num_switches, tuple(phases))


def _hyperx_all_reduce(fab, message_size: int) -> Workload:
    """Dimension-wise reduce-scatter (innermost dim first), then the
    all-gather passes in reverse dimension order."""
    cfg = fab.config
    index_of = {tuple(cfg.switch_coord(s)): s
                for s in range(cfg.num_switches)}
    # One phase list per dimension, innermost first (the RS order); the
    # AG passes replay them in reverse.
    per_dim = _grid_phase_lists(cfg.dims, fab.schedule(), cfg.switch_coord,
                                lambda c: index_of[c], message_size)
    phases = _chain(*per_dim, *reversed(per_dim))
    return Workload(f"{fab.name}-allreduce", cfg.num_switches, phases)


def _dragonfly_all_reduce(fab, message_size: int) -> Workload:
    """The reference's ``all_reduce_two_level`` step
    sequence: local reduce-scatter -> global all-reduce of the scattered
    shards -> local all-gather.  Global phases carry
    ``ceil(message_size / group_size)`` messages per pair — the 1/a
    payload shrink the two-level hierarchy buys."""
    c = fab.config
    a, g = c.group_size, c.num_groups
    sched = fab.schedule()
    g_msg = max(1, -(-message_size // a))        # ceil(message_size / a)

    def local_pairs(row):
        src, dst = [], []
        for grp in range(g):
            for s in range(a):
                t = int(row[s])
                if t != s:
                    src.append(grp * a + s)
                    dst.append(grp * a + t)
        return tuple(src), tuple(dst)

    def global_pairs(row):
        src, dst = [], []
        for grp in range(g):
            peer = int(row[grp])
            if peer == grp:
                continue
            for s in range(a):
                src.append(grp * a + s)
                dst.append(peer * a + s)
        return tuple(src), tuple(dst)

    local_rs = _schedule_phases(sched["local"], message_size,
                                to_pairs=local_pairs)
    global_ar = _schedule_phases(sched["global"], g_msg, repeat=2,
                                 to_pairs=global_pairs)
    local_ag = _schedule_phases(sched["local"], message_size,
                                to_pairs=local_pairs)
    return Workload(f"{fab.name}-allreduce", c.switches,
                    _chain(local_rs, global_ar, local_ag))


def _cin_half_reduce(fab, message_size: int, tag: str) -> Workload:
    """One pass over the 1-factor schedule — the reduce-scatter (or,
    identically as a step sequence, the all-gather) half of the flat
    all-reduce."""
    phases = _schedule_phases(fab.schedule(), message_size)
    return Workload(f"{fab.name}-{tag}", fab.num_switches, tuple(phases))


def _hyperx_half_reduce(fab, message_size: int, tag: str,
                        gather: bool) -> Workload:
    """One dimension-order sweep: innermost-first for the reduce-scatter
    half, reversed (outermost-first) for the all-gather half — exactly
    the two halves :func:`_hyperx_all_reduce` chains."""
    cfg = fab.config
    index_of = {tuple(cfg.switch_coord(s)): s
                for s in range(cfg.num_switches)}
    per_dim = _grid_phase_lists(cfg.dims, fab.schedule(), cfg.switch_coord,
                                lambda c: index_of[c], message_size)
    phases = _chain(*(reversed(per_dim) if gather else per_dim))
    return Workload(f"{fab.name}-{tag}", cfg.num_switches, phases)


def _dragonfly_half_reduce(fab, message_size: int, tag: str,
                           gather: bool) -> Workload:
    """Half of the two-level sequence: local RS then one global pass
    (scatter), or one global pass then local AG (gather).  Global phases
    carry the 1/a-shrunk payload, as in :func:`_dragonfly_all_reduce`."""
    c = fab.config
    a, g = c.group_size, c.num_groups
    sched = fab.schedule()
    g_msg = max(1, -(-message_size // a))

    def local_pairs(row):
        src, dst = [], []
        for grp in range(g):
            for s in range(a):
                t = int(row[s])
                if t != s:
                    src.append(grp * a + s)
                    dst.append(grp * a + t)
        return tuple(src), tuple(dst)

    def global_pairs(row):
        src, dst = [], []
        for grp in range(g):
            peer = int(row[grp])
            if peer == grp:
                continue
            for s in range(a):
                src.append(grp * a + s)
                dst.append(peer * a + s)
        return tuple(src), tuple(dst)

    local = _schedule_phases(sched["local"], message_size,
                             to_pairs=local_pairs)
    global_half = _schedule_phases(sched["global"], g_msg,
                                   to_pairs=global_pairs)
    phases = (_chain(global_half, local) if gather
              else _chain(local, global_half))
    return Workload(f"{fab.name}-{tag}", c.switches, phases)


def collective_workload(fabric, collective: str = "all_to_all", *,
                        message_size: int = 1) -> Workload:
    """The replayable step sequence of ``collective`` on ``fabric``.

    * ``"all_to_all"`` — flat 1-factor schedule (CIN), dimension-order
      grid schedule (HyperX), or (local x global) grid (Dragonfly);
    * ``"all_reduce"`` — reduce-scatter + all-gather chains (CIN /
      HyperX per dimension), or the two-level Dragonfly sequence;
    * ``"reduce_scatter"`` / ``"all_gather"`` — the corresponding half
      of the all-reduce sequence (what ZeRO-style sharded data
      parallelism issues as separate collectives).

    ``message_size`` is the packets per (src, dst) pair per phase; the
    Dragonfly ``all_reduce``/half-sequence global phases carry
    ``ceil(message_size / group_size)`` (the hierarchical payload
    shrink).
    """
    from repro_torch.fabric import (CINFabric, DragonflyFabric, HyperXFabric,
                              make_fabric)
    fabric = make_fabric(fabric)
    builders = {
        ("all_to_all", CINFabric): _cin_all_to_all,
        ("all_to_all", HyperXFabric): _hyperx_all_to_all,
        ("all_to_all", DragonflyFabric): _dragonfly_all_to_all,
        ("all_reduce", CINFabric): _cin_all_reduce,
        ("all_reduce", HyperXFabric): _hyperx_all_reduce,
        ("all_reduce", DragonflyFabric): _dragonfly_all_reduce,
        ("reduce_scatter", CINFabric):
            lambda f, m: _cin_half_reduce(f, m, "rs"),
        ("reduce_scatter", HyperXFabric):
            lambda f, m: _hyperx_half_reduce(f, m, "rs", gather=False),
        ("reduce_scatter", DragonflyFabric):
            lambda f, m: _dragonfly_half_reduce(f, m, "rs", gather=False),
        ("all_gather", CINFabric):
            lambda f, m: _cin_half_reduce(f, m, "ag"),
        ("all_gather", HyperXFabric):
            lambda f, m: _hyperx_half_reduce(f, m, "ag", gather=True),
        ("all_gather", DragonflyFabric):
            lambda f, m: _dragonfly_half_reduce(f, m, "ag", gather=True),
    }
    builder = builders.get((collective, type(fabric)))
    if builder is None:
        known = sorted({k for k, _ in builders})
        raise ValueError(
            f"no {collective!r} workload builder for "
            f"{type(fabric).__name__}; collectives: {known}")
    return builder(fabric, message_size)


# ---------------------------------------------------------------------------
# Replay entry point.
# ---------------------------------------------------------------------------

def replay(topo, policy, workload: Workload, *, backend: str = "torch",
           terminals: int | None = None, eject_bw: int | None = None,
           num_vcs: int | None = None, queue_capacity: int = 4,
           max_cycles: int | None = None, seed: int = 0,
           trace=None, failures=None, bucket: bool | None = None,
           devices=None, device="cuda") -> RunStats:
    """Replay ``workload`` on ``topo`` under ``policy``; returns the
    engine's :class:`~repro_torch.sim.metrics.RunStats` with the replay fields
    set: ``phase_cycles`` (per-phase durations), ``completion_cycles``
    (the cycle the last packet delivered), and ``ideal_cycles`` (the
    contention-free bound) — ``completion_cycles >= ideal_cycles``
    always, with equality iff no phase ever left its bottleneck link
    idle or contended.

    ``backend="torch"`` (the default) runs the cycle engine on ``device``
    (default ``"cuda"``, which raises where CUDA is absent; ``"cpu"`` runs
    the same step eagerly); ``"numpy"`` runs the oracle.  ``failures=``
    replays on the degraded fabric (:func:`repro_torch.faults.degrade`).
    """
    from .engine import simulate
    from .policies import make_policy
    if isinstance(policy, str):
        policy = make_policy(policy)
    if workload.num_switches != topo.num_switches:
        raise ValueError(
            f"workload {workload.name!r} spans {workload.num_switches} "
            f"switches but topology {topo.name!r} has {topo.num_switches}")
    return simulate(topo, policy, workload.traffic(), terminals=terminals,
                    eject_bw=eject_bw, num_vcs=num_vcs,
                    queue_capacity=queue_capacity, warmup=0,
                    max_cycles=max_cycles, seed=seed, backend=backend,
                    trace=trace, failures=failures, bucket=bucket,
                    devices=devices, device=device)
