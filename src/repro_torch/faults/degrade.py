"""Degraded topologies: failure masking + table-based fallback routing.

:func:`degrade` turns a pristine :class:`~repro_torch.sim.topology.SimTopology`
plus a :class:`~repro_torch.faults.spec.FailureSpec` into a degraded
``SimTopology`` that every backend consumes through the seams it already
has:

* the neighbor/port structure is masked (dead slots -> ``-1``), so the
  numpy engine's feasibility checks, ``xengine``'s credit accounting
  (unwired queues are credit-starved), and the flow model's wired-link
  capacities all see the surviving fabric automatically;
* residual connectivity is verified by a BFS component sweep
  (``policy="strict"`` raises :class:`FabricDisconnectedError` when the
  survivors split);
* fallback routing is precomputed as a dense ``(N, N)`` next-hop table
  and installed through the existing ``minimal_port`` /
  ``minimal_port_table`` seam.  Pairs whose *entire* pristine route
  survives keep their pristine next hop (minimal routing semantics —
  and load balance — are untouched for unaffected traffic; with nothing
  failed the table is therefore bit-identical to the pristine
  ``minimal_port_table``).  Broken pairs fall back to shortest paths
  over the surviving graph, computed by vectorized multi-source BFS and
  tie-broken deterministically (prefer the pristine port when it still
  lies on a shortest path, else the smallest valid port).  The pristine
  route is *not* always graph-shortest (Dragonfly's canonical l-g-l
  route may skip a shorter global detour), which is exactly why the
  intact-path check — not a shortest-path membership test — guards the
  pristine collapse.  Mixed routes terminate: shortest-path hops
  strictly shrink the distance to the target, and once a packet reaches
  a switch whose pristine route to the target is intact, every suffix
  of that route is intact too.

The degraded topology carries a ``meta["faults"]`` block (spec, alive
mask, component labels, dead/rerouted link masks, pristine diameter)
that downstream layers key off: engines collapse Valiant mids that fall
outside the source's component, traffic/workload masking drops packets
whose endpoints died, and ``repro_torch.obs`` classes rerouted link
utilization separately.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.topology import SimTopology

from .spec import FailureSpec

__all__ = [
    "FabricDisconnectedError", "degrade", "residual_report",
    "bfs_distances", "build_fallback_table",
    "packet_keep", "mask_traffic", "mask_workload", "filter_pairs",
]


class FabricDisconnectedError(ValueError):
    """Raised when ``policy='strict'`` failures disconnect the surviving
    fabric.  Subclasses :class:`ValueError` so callers that only know
    "bad spec" still catch it."""


def _dead_mask(topo: SimTopology, spec: FailureSpec):
    """Sample/collect failures: ``(alive switches, dead (N, P) slots)``.

    Draw order is part of the spec contract (see ``FailureSpec``):
    switches first, then links, from one ``default_rng(seed)`` stream.
    Random link failures sample the *pristine* undirected link pool in
    canonical ``(switch, port)`` order; overlap with dead switches is
    coincidental and harmless (the slot is dead either way).
    """
    n, p = topo.num_switches, topo.num_ports
    nbr, rev = topo.neighbor, topo.rev_port
    flat = nbr.reshape(-1)
    rflat = rev.reshape(-1)
    rng = np.random.default_rng(spec.seed)

    alive = np.ones(n, dtype=bool)
    k_s = int(round(spec.switch_fraction * n))
    if k_s:
        alive[rng.permutation(n)[:k_s]] = False
    for s in spec.dead_switches:
        if not 0 <= s < n:
            raise ValueError(f"dead switch {s} outside [0, {n}) "
                             f"on {topo.name}")
        alive[s] = False

    slot = np.arange(n * p)
    canonical = np.flatnonzero((flat >= 0) & (flat > slot // p))
    kill = []
    k_l = int(round(spec.link_fraction * canonical.size))
    if k_l:
        kill.append(canonical[rng.permutation(canonical.size)[:k_l]])
    for a, b in spec.dead_links:
        hits = np.flatnonzero(nbr[a] == b) if 0 <= a < n else \
            np.empty(0, dtype=np.int64)
        if hits.size == 0:
            raise ValueError(f"dead link ({a}, {b}) does not exist "
                             f"on {topo.name}")
        kill.append(a * p + hits)

    dead = np.zeros(n * p, dtype=bool)
    if kill:
        ids = np.concatenate(kill)
        dead[ids] = True
        dead[flat[ids] * p + rflat[ids]] = True  # far side of each wire
    if not alive.all():
        down = ~alive[slot // p] & (flat >= 0)
        dead |= down
        ids = np.flatnonzero(down)
        dead[flat[ids] * p + rflat[ids]] = True
    dead &= flat >= 0
    return alive, dead.reshape(n, p)


def _components(neighbor: np.ndarray, alive: np.ndarray):
    """Flood-fill component labels over the masked graph.

    Returns ``(comp, count)``: ``comp[s]`` is the component id of alive
    switch ``s`` (ids are dense, assigned in ascending switch order) and
    ``-1`` for dead switches.
    """
    n = alive.size
    comp = np.full(n, -1, dtype=np.int64)
    cid = 0
    todo = np.flatnonzero(alive)
    while todo.size:
        frontier = todo[:1]
        comp[frontier] = cid
        while frontier.size:
            nxt = neighbor[frontier].reshape(-1)
            nxt = nxt[nxt >= 0]
            nxt = np.unique(nxt)
            nxt = nxt[comp[nxt] < 0]
            comp[nxt] = cid
            frontier = nxt
        cid += 1
        todo = np.flatnonzero(alive & (comp < 0))
    return comp, cid


def bfs_distances(neighbor: np.ndarray) -> np.ndarray:
    """All-pairs hop distances over a masked ``(N, P)`` neighbor matrix.

    Multi-source BFS on ``(N, W)`` uint64 reachability bitsets: each
    round ORs every port column's neighbor rows into the running set and
    stamps newly-set bits with the round number.  ``O(diameter)`` rounds
    of ``N * N/64 * P`` word operations — dense but vectorized, which is
    the regime the dense fallback table needs anyway.  Returns int32;
    ``-1`` marks unreachable pairs (and every pair touching a dead
    switch).
    """
    n, p = neighbor.shape
    words = (n + 63) // 64
    reach = np.zeros((n, words), dtype=np.uint64)
    idx = np.arange(n)
    reach[idx, idx >> 6] = np.uint64(1) << np.uint64(idx & 63)
    dist = np.full((n, n), -1, dtype=np.int32)
    dist[idx, idx] = 0
    cols = [q for q in range(p) if (neighbor[:, q] >= 0).any()]
    rounds = 0
    while True:
        rounds += 1
        new = reach.copy()
        for q in cols:
            nb = neighbor[:, q]
            m = nb >= 0
            new[m] |= reach[nb[m]]
        diff = new & ~reach
        if not diff.any():
            break
        bits = np.unpackbits(diff.view(np.uint8), axis=1,
                             bitorder="little")[:, :n]
        dist[bits.astype(bool)] = rounds
        reach = new
    return dist


def _shortest_table(nbr: np.ndarray, dist: np.ndarray,
                    pristine: np.ndarray) -> np.ndarray:
    """Shortest-path next hops over the masked graph, tie-broken
    deterministically: the pristine port when it still lies on a
    shortest path, else the smallest valid port.  Unreachable pairs and
    the diagonal get port 0 (masked traffic never asks for them)."""
    n, p = nbr.shape
    table = np.zeros((n, n), dtype=np.int64)
    # Chunk source rows so the (C, P, N) neighbor-distance gather stays
    # ~32 MB even at the 4k-switch benchmark tier.
    chunk = max(1, (1 << 23) // max(p * n, 1))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        nb = nbr[lo:hi]
        du = dist[lo:hi]
        dn = dist[np.where(nb >= 0, nb, 0)]          # (C, P, N)
        valid = (nb >= 0)[:, :, None] & (dn >= 0) \
            & (dn == du[:, None, :] - 1)
        pp = pristine[lo:hi]
        pref = np.take_along_axis(valid, pp[:, None, :], axis=1)[:, 0, :]
        first = np.argmax(valid, axis=1)
        rows = np.where(pref, pp, first)
        table[lo:hi] = np.where(du > 0, rows, 0)
    return table


def _intact_pristine(topo: SimTopology, pristine: np.ndarray,
                     dead: np.ndarray) -> np.ndarray:
    """Bool ``(N, N)``: pairs whose *entire* pristine route survives.

    Fixpoint over route suffixes: after ``k`` rounds, pairs whose
    pristine route has length <= ``k`` and crosses no dead slot are
    marked; pristine routes are at most ``topo.diameter`` hops, so the
    iteration converges in ``diameter`` rounds.
    """
    n = topo.num_switches
    rows = np.arange(n)[:, None]
    cols = np.arange(n)[None, :]
    nxt = topo.neighbor[rows, pristine]
    link_ok = ~dead[rows, pristine]
    intact = np.zeros((n, n), dtype=bool)
    np.fill_diagonal(intact, True)
    for _ in range(max(topo.diameter, 1)):
        new = link_ok & intact[nxt, cols]
        np.fill_diagonal(new, True)
        if np.array_equal(new, intact):
            break
        intact = new
    return intact


def _route_lengths(nbr: np.ndarray, table: np.ndarray, dist: np.ndarray,
                   cap: int) -> np.ndarray:
    """Exact per-pair hop counts induced by walking ``table`` — validates
    that the composed (intact-pristine + shortest-fallback) table is
    loop-free and yields the degraded diameter the engines size their
    VC ladders by.  ``-1`` for unreachable pairs."""
    n = nbr.shape[0]
    cols = np.arange(n)[None, :]
    nxt = nbr[np.arange(n)[:, None], table]
    nxt_safe = np.where(nxt >= 0, nxt, 0)
    lengths = np.full((n, n), -1, dtype=np.int32)
    np.fill_diagonal(lengths, 0)
    reachable = dist >= 0
    for _ in range(cap):
        if (lengths[reachable] >= 0).all():
            return lengths
        hop = lengths[nxt_safe, cols]
        lengths = np.where((lengths < 0) & reachable & (hop >= 0),
                           hop + 1, lengths)
    if not (lengths[reachable] >= 0).all():
        raise AssertionError("fallback routing table walked into a loop "
                             "— this is a repro_torch.faults bug")
    return lengths


def build_fallback_table(topo: SimTopology, *, dead=None, neighbor=None,
                         dist=None, pristine=None) -> np.ndarray:
    """Dense ``(N, N)`` next-hop fallback table for ``topo`` with the
    ``dead`` directed-slot mask applied (default: nothing dead).

    Pairs whose entire pristine route survives keep the pristine
    ``minimal_port_table`` entry — so with ``dead`` all-False the result
    is bit-identical to ``minimal_port_table``, the closed-form collapse
    the pristine baseline needs.  Broken pairs take shortest paths over
    the surviving graph (see :func:`_shortest_table` for the
    deterministic tie-break).
    """
    n = topo.num_switches
    if pristine is None:
        pristine = topo.minimal_port_table()
    if dead is None:
        dead = (np.zeros_like(topo.neighbor, dtype=bool) if neighbor is None
                else (neighbor != topo.neighbor))
    if neighbor is None:
        neighbor = np.where(dead, -1, topo.neighbor)
    if dist is None:
        dist = bfs_distances(neighbor)
    intact = _intact_pristine(topo, pristine, dead)
    short = _shortest_table(neighbor, dist, pristine)
    offdiag = ~np.eye(n, dtype=bool)
    return np.where(intact & offdiag, pristine, short)


def residual_report(topo: SimTopology, failures) -> dict:
    """Cheap connectivity check — no distance/table build.

    Returns ``{"alive", "comp", "num_components", "connected"}`` for the
    surviving graph under ``failures``.  This is the early check
    ``repro_torch.studies`` runs before committing to a backend, and what the
    ``strict`` policy enforces inside :func:`degrade`.
    """
    spec = FailureSpec.coerce(failures)
    n = topo.num_switches
    if spec is None or spec.is_null:
        return {"alive": np.ones(n, dtype=bool),
                "comp": np.zeros(n, dtype=np.int64),
                "num_components": 1 if n else 0, "connected": True}
    alive, dead = _dead_mask(topo, spec)
    comp, count = _components(np.where(dead, -1, topo.neighbor), alive)
    return {"alive": alive, "comp": comp, "num_components": count,
            "connected": count <= 1}


#: Degraded builds memoized per pristine topology (see :func:`degrade`).
#: Bounded: a failure-rate x seed sweep touches a handful of specs per
#: fabric; an unbounded map would pin every 4k-switch table a long-lived
#: process ever built.
_DEGRADE_CACHE_MAX = 16


def degrade(topo: SimTopology, failures) -> SimTopology:
    """Pristine topology + failures -> degraded ``SimTopology``.

    A null spec (or ``None``) returns ``topo`` itself — same object,
    same caches, trivially bit-identical results.  Otherwise the
    degraded topology is fully built eagerly: masked neighbor/rev_port,
    component labels, all-pairs distances, the fallback next-hop table
    (pre-seeded into the ``minimal_port_table`` cache), the surviving
    graph's diameter, and the ``meta["faults"]`` block described in the
    module docstring.

    Builds are memoized on the pristine topology object, keyed by the
    spec's canonical JSON: experiments that degrade the same fabric with
    the same ``FailureSpec`` (a :class:`repro_torch.studies.runner.Study`
    sweeping loads x seeds, a flow-model saturation bisection, repeated
    ``simulate(failures=...)`` calls) pay the table build — ~40 s at the
    4k-switch benchmark tier — once.  The build itself is deterministic
    (seeded draws, deterministic tie-breaks), so the cached object is
    exactly what a fresh build would return.
    """
    spec = FailureSpec.coerce(failures)
    if spec is None or spec.is_null:
        return topo
    meta = topo.meta or {}
    if "faults" in meta:
        raise ValueError(f"{topo.name} is already degraded; apply the "
                         f"FailureSpec to the pristine topology instead")
    cache = topo.__dict__.setdefault("_degrade_cache", {})
    ckey = spec.to_json()
    hit = cache.get(ckey)
    if hit is not None:
        return hit
    n, p = topo.num_switches, topo.num_ports
    alive, dead = _dead_mask(topo, spec)
    new_nbr = np.where(dead, -1, topo.neighbor)
    new_rev = np.where(dead, -1, topo.rev_port)
    comp, count = _components(new_nbr, alive)
    if spec.policy == "strict" and count > 1:
        sizes = np.bincount(comp[comp >= 0], minlength=count)
        raise FabricDisconnectedError(
            f"{topo.name}: failures {spec.label!r} leave the surviving "
            f"fabric in {count} components (sizes "
            f"{sorted(sizes.tolist(), reverse=True)}); policy='strict' "
            f"requires a connected residual fabric — use policy='drop' "
            f"to drop unreachable pairs, or lower the failure fraction "
            f"/ change the seed")

    pristine = topo.minimal_port_table()
    dist = bfs_distances(new_nbr)
    intact = _intact_pristine(topo, pristine, dead)
    short = _shortest_table(new_nbr, dist, pristine)
    table = np.where(intact & ~np.eye(n, dtype=bool), pristine, short)
    lengths = _route_lengths(new_nbr, table, dist,
                             cap=int(dist.max()) + topo.diameter + 2)
    diameter = max(int(lengths.max()), 1)

    # Directed link slots carrying rerouted traffic: the degraded first
    # hop of every reachable pair whose pristine route broke.
    changed = ~intact & (dist > 0)
    rerouted = np.zeros(n * p, dtype=bool)
    u, t = np.nonzero(changed)
    rerouted[u * p + table[u, t]] = True
    unreachable = int(np.sum((dist < 0) & alive[:, None] & alive[None, :]))

    def minimal_port(cur, tgt):
        return table[np.asarray(cur, dtype=np.int64),
                     np.asarray(tgt, dtype=np.int64)]

    new_meta = dict(meta)
    new_meta["faults"] = {
        "spec": spec,
        "alive": alive,
        "comp": comp,
        "num_components": count,
        "dead_links": dead,                  # (N, P) directed slot mask
        "rerouted": rerouted,                # (N*P,) flat directed mask
        "unreachable_pairs": unreachable,
        "pristine_diameter": int(topo.diameter),
        "pristine_name": topo.name,
    }
    out = SimTopology(
        name=f"{topo.name}+{spec.label}", num_switches=n, num_ports=p,
        neighbor=new_nbr, rev_port=new_rev, minimal_port=minimal_port,
        diameter=diameter, meta=new_meta)
    out.__dict__["_minimal_port_table"] = table
    out.validate()
    if len(cache) >= _DEGRADE_CACHE_MAX:
        cache.pop(next(iter(cache)))        # evict oldest (insertion order)
    cache[ckey] = out
    return out


def _faults_of(topo) -> dict | None:
    meta = getattr(topo, "meta", None) or {}
    return meta.get("faults")


def packet_keep(topo, src, dst) -> np.ndarray:
    """Bool mask over ``(src, dst)`` pairs that still exist on ``topo``:
    both endpoints alive and mutually reachable.  All-True on pristine
    topologies."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    faults = _faults_of(topo)
    if faults is None:
        return np.ones(src.size, dtype=bool)
    alive, comp = faults["alive"], faults["comp"]
    return alive[src] & alive[dst] & (comp[src] == comp[dst])


def filter_pairs(topo, src, dst, rate):
    """Drop demand entries whose endpoints died or were disconnected —
    the flow-model counterpart of :func:`mask_traffic`."""
    faults = _faults_of(topo)
    if faults is None:
        return src, dst, rate
    keep = packet_keep(topo, src, dst)
    if keep.all():
        return src, dst, rate
    return (np.asarray(src)[keep], np.asarray(dst)[keep],
            np.asarray(rate)[keep])


def mask_workload(workload, topo):
    """Rebuild a :class:`~repro_torch.sim.workloads.Workload` for a degraded
    topology: per-phase, drop pairs whose endpoints died or were
    disconnected; drop phases masked empty entirely (so the engines'
    delivered-count phase barrier tracks the surviving traffic).
    Returns ``workload`` unchanged on pristine topologies or when
    nothing is masked."""
    faults = _faults_of(topo)
    if faults is None:
        return workload
    from repro_torch.sim.workloads import Phase, Workload
    phases = []
    dirty = False
    for ph in workload.phases:
        src = np.asarray(ph.src, dtype=np.int64)
        dst = np.asarray(ph.dst, dtype=np.int64)
        keep = packet_keep(topo, src, dst)
        if keep.all():
            phases.append(ph)
            continue
        dirty = True
        if keep.any():
            phases.append(Phase(tuple(int(v) for v in src[keep]),
                                tuple(int(v) for v in dst[keep]),
                                ph.messages))
    if not dirty:
        return workload
    return Workload(f"{workload.name}+degraded", workload.num_switches,
                    tuple(phases))


def mask_traffic(traffic, topo):
    """Drop packets whose endpoints died or were disconnected.

    Open-loop traffic is filtered in place (src/dst/gen rows); workload
    replays rebuild the workload via :func:`mask_workload` and re-emit
    its traffic so phase boundaries stay consistent with the surviving
    packet counts.  No-op on pristine topologies.
    """
    faults = _faults_of(topo)
    if faults is None:
        return traffic
    if traffic.workload is not None:
        masked = mask_workload(traffic.workload, topo)
        return traffic if masked is traffic.workload else masked.traffic()
    keep = packet_keep(topo, traffic.src, traffic.dst)
    if keep.all():
        return traffic
    from dataclasses import replace
    return replace(traffic,
                   src=np.asarray(traffic.src)[keep],
                   dst=np.asarray(traffic.dst)[keep],
                   gen=np.asarray(traffic.gen)[keep],
                   request=(np.asarray(traffic.request)[keep]
                            if traffic.request is not None else None))
