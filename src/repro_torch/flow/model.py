"""Flow-level model: demands, routes, and calibrated link capacities.

This module turns a ``SimTopology`` plus a traffic description into the
three arrays the max-min solver consumes:

* a **demand vector** — one entry per (src, dst[, class]) flow, in
  packets/cycle offered;
* a **route incidence** — each flow's directed-link ids in CSR form,
  traced hop-by-hop with ``minimal_port`` (never the dense O(N²) route
  table, so 10k-switch fabrics stay cheap);
* a **capacity vector** — per directed link, in packets/cycle.

Capacity calibration
--------------------
The cycle engines move at most one packet per directed link per cycle,
so raw capacity is 1.0.  But packets *entering* the fabric contend
differently from packets *crossing* it: each switch serves its T
terminal FIFOs into P output links head-of-line, and transit traffic
has priority.  Under sustained random load the injection stage only
achieves a fraction of link bandwidth — classic HOL behaviour, about
``1 - (1 - 1/P)**T`` ≈ 0.56 for the CIN-16 operating point and measured
at ≈0.55 effective across the bundled oracle sweeps.  We fold this into
the link, not the flow: a link whose demand is a mix of injection
(first-hop) and transit traffic gets

    C_l = ETA_INJECTION ** (injection_demand_l / total_demand_l)

i.e. capacity 1.0 for pure-transit links (the Dragonfly adversarial
oracle's exact ``accepted = 1/8`` plateau requires this) sliding to
``ETA_INJECTION`` for pure-injection links.  One scalar, calibrated
once against the CIN-16 oracle knees and validated on every other
bundled spec — see ``docs/flow_model.md`` for the derivation and the
constraint interval.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sim.topology import SimTopology

__all__ = [
    "ETA_INJECTION", "FlowParams", "FlowProblem",
    "trace_routes", "trace_routes_via",
    "uniform_demands", "permutation_demands", "hotspot_demands",
    "adversarial_demands", "demands_from_traffic", "link_capacities",
]

#: Injection-stage HOL efficiency: fraction of link bandwidth a
#: saturated injection stage achieves.  Theoretical estimate for the
#: CIN-16 operating point (T=12 FIFOs over P=15 links):
#: ``1-(1-1/15)**12 = 0.563``; the bundled oracle knees constrain the
#: effective value to [0.532, 0.578) and 0.55 sits mid-interval.
ETA_INJECTION = 0.55


@dataclass(frozen=True)
class FlowParams:
    """Knobs of the flow model; defaults reproduce the oracle knees."""
    eta_injection: float = ETA_INJECTION
    #: Above this many (src, dst) pairs, uniform traffic is sampled
    #: rather than enumerated (scale-out guard for 10k+ fabrics).
    max_pairs: int = 100_000
    #: Valiant flows enumerate all n-2 intermediates exactly while
    #: ``flows * (n-2)`` stays under this budget; sampled above it.
    split_budget: int = 500_000
    max_iters: int = 256
    #: ``maxmin_rates`` core: "auto" and "torch" run the torch core on the
    #: caller's device, "numpy" the numpy core.
    solver: str = "auto"
    #: UGAL-fluid detour rule: a flow leaves the minimal route when its
    #: worst-link utilization exceeds ``detour_weight`` times the fabric
    #: mean (and 1.0); mirrors AdaptivePolicy's weight=2 backlog test.
    detour_weight: float = 2.0
    #: RNG seed for the sampling fallbacks (pair/mid sampling).  The
    #: model itself is deterministic whenever it enumerates exactly.
    sample_seed: int = 0


@dataclass
class FlowProblem:
    """Solver input: flows (demand + CSR routes) over directed links.

    ``link_ids``/``flow_ptr`` follow CSR convention: flow f's route is
    ``link_ids[flow_ptr[f]:flow_ptr[f+1]]``, links as ``switch *
    num_ports + port``.  ``injection`` marks each entry that is a flow's
    first hop (segment-1 first hop only, for Valiant flows).
    """
    demand: np.ndarray       # (F,)
    link_ids: np.ndarray     # (nnz,)
    flow_ptr: np.ndarray     # (F+1,)
    injection: np.ndarray    # (nnz,) bool
    src: np.ndarray          # (F,)
    dst: np.ndarray          # (F,)

    @property
    def num_flows(self) -> int:
        return int(self.demand.size)


def _concat_problems(parts: list[FlowProblem]) -> FlowProblem:
    """Stack independent flow sets into one problem."""
    parts = [p for p in parts if p.num_flows]
    if len(parts) == 1:
        return parts[0]
    ptrs = [parts[0].flow_ptr]
    for p in parts[1:]:
        ptrs.append(p.flow_ptr[1:] + (ptrs[-1][-1] - p.flow_ptr[0]))
    return FlowProblem(
        demand=np.concatenate([p.demand for p in parts]),
        link_ids=np.concatenate([p.link_ids for p in parts]),
        flow_ptr=np.concatenate(ptrs),
        injection=np.concatenate([p.injection for p in parts]),
        src=np.concatenate([p.src for p in parts]),
        dst=np.concatenate([p.dst for p in parts]))


# ---------------------------------------------------------------------------
# Route tracing


def trace_routes(topo: SimTopology, src: np.ndarray,
                 dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Minimal routes for each (src[i], dst[i]) pair, CSR-encoded.

    Walks all pairs in lockstep with vectorized ``minimal_port`` calls —
    at most ``topo.diameter`` rounds over flat arrays, no dense route
    table.  Returns ``(link_ids, flow_ptr)``.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    F = src.size
    cur = src.copy()
    hops_f: list[np.ndarray] = []   # flow index per collected hop
    hops_l: list[np.ndarray] = []   # link id per collected hop
    pending = np.arange(F)
    for _ in range(max(topo.diameter, 1) + 1):
        alive = cur[pending] != dst[pending]
        pending = pending[alive]
        if pending.size == 0:
            break
        c = cur[pending]
        port = np.asarray(topo.minimal_port(c, dst[pending]))
        nxt = topo.neighbor[c, port]
        if (nxt < 0).any():
            # Only reachable on degraded fabrics: the fallback table
            # gives port 0 for unreachable pairs and port 0 may be dead.
            # Raise here, by name, rather than let the -1 wrap into a
            # wandering walk that fails the convergence check cryptically.
            bad = nxt < 0
            raise RuntimeError(
                f"route tracing on {topo.name} stepped onto an unwired "
                f"port for {int(bad.sum())} pair(s) (first: switch "
                f"{int(c[bad][0])} -> {int(dst[pending][bad][0])}); on a "
                f"degraded fabric this means the pair is unreachable — "
                f"filter demands with repro_torch.faults.filter_pairs (policy="
                f"'drop') or use a connected FailureSpec")
        hops_f.append(pending.copy())
        hops_l.append(c * topo.num_ports + port)
        cur[pending] = nxt
    else:
        left = pending[cur[pending] != dst[pending]]
        if left.size:
            raise RuntimeError(
                f"minimal routing did not converge within diameter "
                f"{topo.diameter} for {left.size} pairs on {topo.name}")
    if not hops_f:
        return (np.zeros(0, dtype=np.int64),
                np.zeros(F + 1, dtype=np.int64))
    flow_of = np.concatenate(hops_f)
    link_of = np.concatenate(hops_l)
    # Hop-major → flow-major, preserving hop order within each flow
    # (stable sort; hops were appended in walk order).
    order = np.argsort(flow_of, kind="stable")
    counts = np.bincount(flow_of, minlength=F)
    flow_ptr = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(counts, out=flow_ptr[1:])
    return link_of[order], flow_ptr


def trace_routes_via(topo: SimTopology, src: np.ndarray, mid: np.ndarray,
                     dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Two-segment (Valiant) routes src→mid→dst as single CSR flows.

    Each flow's entries are segment-1 hops followed by segment-2 hops,
    so the solver sees the full path as one coupled flow.
    """
    l1, p1 = trace_routes(topo, src, mid)
    l2, p2 = trace_routes(topo, mid, dst)
    c1 = np.diff(p1)
    c2 = np.diff(p2)
    total = c1 + c2
    ptr = np.zeros(total.size + 1, dtype=np.int64)
    np.cumsum(total, out=ptr[1:])
    out = np.empty(int(ptr[-1]), dtype=np.int64)
    # Vectorized interleave: per-flow destinations for each segment.
    idx1 = np.repeat(ptr[:-1], c1) + _ranges(c1)
    idx2 = np.repeat(ptr[:-1] + c1, c2) + _ranges(c2)
    out[idx1] = l1
    out[idx2] = l2
    return out, ptr


def _ranges(counts: np.ndarray) -> np.ndarray:
    """``concatenate([arange(c) for c in counts])`` without the loop."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    nz = counts > 0
    out[starts[nz]] = 0
    first = starts[nz][1:]
    out[first] -= (counts[nz][:-1] - 1)
    return np.cumsum(out)


def _injection_mask(flow_ptr: np.ndarray) -> np.ndarray:
    """First entry of every non-empty flow route."""
    mask = np.zeros(int(flow_ptr[-1]), dtype=bool)
    starts = flow_ptr[:-1]
    nonempty = np.diff(flow_ptr) > 0
    mask[starts[nonempty]] = True
    return mask


# ---------------------------------------------------------------------------
# Demand builders (one per declarative traffic pattern)


def _merge_duplicate_pairs(src, dst, rate, n):
    """Sum rates of repeated (src, dst) pairs into unique flows."""
    key = src.astype(np.int64) * n + dst
    uniq, inverse = np.unique(key, return_inverse=True)
    merged = np.bincount(inverse, weights=rate)
    return uniq // n, uniq % n, merged


def uniform_demands(topo: SimTopology, load: float, terminals: int,
                    params: FlowParams):
    """All-to-all uniform: every ordered pair at ``T·o/(n-1)``.

    Exact enumeration while ``n(n-1) <= max_pairs``; above that, pairs
    are sampled with replacement and rates scaled to preserve the total
    offered traffic (the max-min allocation of uniform traffic is
    insensitive to which symmetric subset represents it).
    """
    n = topo.num_switches
    total = n * (n - 1)
    per_pair = terminals * load / max(n - 1, 1)
    if total <= params.max_pairs:
        src = np.repeat(np.arange(n), n - 1)
        # dst enumeration without the O(n^2) python loop: for each src s,
        # dsts are 0..n-1 minus s, via the shift-remap trick.
        k = np.tile(np.arange(n - 1), n)
        dst = k + (k >= np.repeat(np.arange(n), n - 1))
        rate = np.full(total, per_pair)
        return src, dst, rate
    rng = np.random.default_rng(params.sample_seed)
    k = params.max_pairs
    src = rng.integers(0, n, size=k)
    raw = rng.integers(0, n - 1, size=k)
    dst = raw + (raw >= src)
    rate = np.full(k, terminals * load * n / k)
    return _merge_duplicate_pairs(src, dst, rate, n)


def permutation_demands(topo: SimTopology, load: float, terminals: int,
                        params: FlowParams, *, perm=None):
    n = topo.num_switches
    src = np.arange(n)
    dst = np.asarray(perm) if perm is not None else (src + n // 2) % n
    keep = src != dst
    return src[keep], dst[keep], np.full(int(keep.sum()),
                                         float(terminals) * load)


def hotspot_demands(topo: SimTopology, load: float, terminals: int,
                    params: FlowParams, *, hot_fraction: float = 0.8,
                    hot_dst: int | None = None, partner_shift=None):
    """Each switch sends ``hot_fraction`` to a fixed partner (or one
    shared ``hot_dst``) and the rest uniformly — mirrors
    ``sim.traffic.hotspot``'s analytic mix."""
    n = topo.num_switches
    src = np.arange(n)
    if hot_dst is not None:
        hot = np.full(n, int(hot_dst))
    else:
        shift = partner_shift if partner_shift is not None else max(n // 2, 1)
        hot = (src + shift) % n
    hot_rate = np.full(n, terminals * load * hot_fraction)
    u_src, u_dst, u_rate = uniform_demands(topo, load * (1 - hot_fraction),
                                           terminals, params)
    src = np.concatenate([src, u_src])
    dst = np.concatenate([hot, u_dst])
    rate = np.concatenate([hot_rate, u_rate])
    keep = src != dst
    return _merge_duplicate_pairs(src[keep], dst[keep], rate[keep], n)


def adversarial_demands(topo: SimTopology, load: float, terminals: int,
                        params: FlowParams):
    """Dragonfly worst case: group g sends only to group g+1, dst
    uniform over that group's switches — ``g·a²`` exact pairs."""
    cfg = topo.meta.get("config")
    a = cfg.group_size
    g = cfg.num_groups
    grp = np.arange(g)
    src_local = np.arange(a)
    dst_local = np.arange(a)
    src = (grp[:, None, None] * a + src_local[None, :, None])
    dst = ((grp[:, None, None] + 1) % g * a + dst_local[None, None, :])
    src = np.broadcast_to(src, (g, a, a)).ravel()
    dst = np.broadcast_to(dst, (g, a, a)).ravel()
    rate = np.full(src.size, terminals * load / a)
    return src, dst, rate


def demands_from_traffic(traffic, num_switches: int):
    """Empirical demand matrix from a generated ``Traffic`` object —
    the fallback for inline/custom patterns and ``simulate(backend=
    "flow")``: unique (src, dst) pair counts over the horizon."""
    src = np.asarray(traffic.src, dtype=np.int64)
    dst = np.asarray(traffic.dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    horizon = max(int(traffic.horizon), 1)
    rate = np.full(src.size, 1.0 / horizon)
    return _merge_duplicate_pairs(src, dst, rate, num_switches)


# ---------------------------------------------------------------------------
# Capacities


def link_capacities(topo: SimTopology, problem: FlowProblem,
                    params: FlowParams) -> np.ndarray:
    """Per-directed-link capacity, injection-share calibrated.

    ``C_l = eta ** (injection_demand_l / total_demand_l)`` — 1.0 for
    pure-transit links, ``eta`` for pure-injection links (see module
    docstring).  Links with no demand get capacity 1.0.
    """
    L = topo.num_switches * topo.num_ports
    entry_rate = np.repeat(problem.demand, np.diff(problem.flow_ptr))
    total = np.bincount(problem.link_ids, weights=entry_rate, minlength=L)
    inj = np.bincount(problem.link_ids[problem.injection],
                      weights=entry_rate[problem.injection], minlength=L)
    share = np.divide(inj, total, out=np.zeros(L), where=total > 0)
    return params.eta_injection ** share
