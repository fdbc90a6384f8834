"""Adapters: the flow model behind the repo's existing seams.

Everything here speaks the vocabulary of the cycle engines —
``SimTopology`` + policy + traffic in, :class:`repro_torch.sim.metrics.RunStats`
out — so the flow backend slots into ``simulate(backend="flow")``,
``Study`` grids, and ``Fabric.replay`` without new call sites.

Three entry points:

* :func:`solve_flows` — the raw model: (src, dst, rate) demands under a
  routing discipline → max-min rates + bottleneck link sets
  (:class:`FlowSolution`);
* :func:`simulate_flow` / :func:`study_point_stats` — RunStats-shaped
  estimates for open-loop saturation grids (analytic demand matrices
  for the declarative patterns, empirical ones for inline traffic);
* :func:`replay_estimate` / :func:`replay_stats` — phase-by-phase
  collective completion bounds (``completion_cycles`` etc.).

Fidelity contract: the flow model predicts *rates and completion*, not
queueing dynamics.  ``accepted``/``saturated``/``completion_cycles``
are cross-validated against the numpy oracle (tests/test_flow.py);
latency fields are hop-count lower-bound proxies and ``link_util_*``
are offered-rate utilizations — present so downstream tables render,
but not knee-comparable across fidelities.  ``Result.fidelity ==
"flow"`` marks every record produced here.

Route tracing, demands and capacities are host numpy; the max-min solve
runs on ``device`` (default ``"cuda"``, which raises where CUDA is
absent), an argument of every entry point here and never a field of
:class:`FlowParams`, so specs and records are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.sim.metrics import RunStats
from repro_torch.sim.topology import SimTopology

from .model import (FlowParams, FlowProblem, _concat_problems,
                    _injection_mask, adversarial_demands,
                    demands_from_traffic, hotspot_demands, link_capacities,
                    permutation_demands, trace_routes, trace_routes_via,
                    uniform_demands)
from ..sim.xengine import _resolve_device
from .solver import maxmin_rates

__all__ = ["FlowSolution", "solve_flows", "pattern_demands",
           "simulate_flow", "study_point_stats", "replay_estimate",
           "replay_stats", "serving_stats", "saturation_load"]

#: Routing disciplines the flow model understands (the three in-repo
#: policies; anything else must come through inline traffic + minimal).
ROUTINGS = ("minimal", "valiant", "adaptive")


@dataclass
class FlowSolution:
    """A solved flow problem: rates, capacities, and where it binds."""
    topo: SimTopology
    routing: str
    problem: FlowProblem
    capacity: np.ndarray        # (L,) per directed link
    rates: np.ndarray           # (F,) max-min allocation
    params: FlowParams = field(default_factory=FlowParams)

    @property
    def offered_rate(self) -> float:
        """Total offered demand, packets/cycle fabric-wide."""
        return float(self.problem.demand.sum())

    @property
    def delivered_rate(self) -> float:
        """Total max-min throughput, packets/cycle fabric-wide."""
        return float(self.rates.sum())

    @property
    def served(self) -> np.ndarray:
        """Carried rate per directed link (packets/cycle)."""
        L = self.topo.num_switches * self.topo.num_ports
        entry = np.repeat(self.rates, np.diff(self.problem.flow_ptr))
        return np.bincount(self.problem.link_ids, weights=entry, minlength=L)

    def bottleneck_links(self, top: int = 10) -> list[dict]:
        """The ``top`` most-utilized wired links (served/capacity), the
        flow model's answer to "where would this fabric bind first"."""
        P = self.topo.num_ports
        wired = self.topo.neighbor.reshape(-1) >= 0
        util = np.where(self.capacity > 0, self.served / self.capacity, 0.0)
        util = np.where(wired, util, -1.0)
        order = np.argsort(-util)[:top]
        return [{
            "switch": int(l // P),
            "port": int(l % P),
            "neighbor": int(self.topo.neighbor.reshape(-1)[l]),
            "utilization": round(float(util[l]), 4),
            "capacity": round(float(self.capacity[l]), 4),
            "served": round(float(self.served[l]), 4),
        } for l in order if util[l] >= 0]


# ---------------------------------------------------------------------------
# Problem assembly per routing discipline


def _minimal_problem(topo, src, dst, rate) -> FlowProblem:
    link_ids, ptr = trace_routes(topo, src, dst)
    return FlowProblem(demand=np.asarray(rate, np.float64),
                       link_ids=link_ids, flow_ptr=ptr,
                       injection=_injection_mask(ptr),
                       src=np.asarray(src), dst=np.asarray(dst))


def _valiant_problem(topo, src, dst, rate,
                     params: FlowParams) -> FlowProblem:
    """Valiant load balancing as flow splitting: each demand spreads
    over intermediates ``mid ∉ {src, dst}``, both segments coupled into
    one flow per (pair, mid).  Exact enumeration within
    ``params.split_budget``; uniform mid *sampling* above it (the
    symmetric split a large fabric converges to anyway)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    rate = np.asarray(rate, np.float64)
    n = topo.num_switches
    if n < 3:
        return _minimal_problem(topo, src, dst, rate)
    F = src.size
    if F * (n - 2) <= params.split_budget:
        m = n - 2
        raw = np.tile(np.arange(m), F)
    else:
        m = max(1, params.split_budget // max(F, 1))
        rng = np.random.default_rng(params.sample_seed)
        raw = rng.integers(0, n - 2, size=F * m)
    s = np.repeat(src, m)
    d = np.repeat(dst, m)
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    mid = raw + (raw >= lo)
    mid += (mid >= hi)
    demand = np.repeat(rate / m, m)
    faults = (topo.meta or {}).get("faults")
    if faults is not None:
        # Degraded fabric: only mids alive and in the source's component
        # can relay.  Drop the rest and renormalize each pair's split
        # over its surviving mids; pairs with no surviving mid at all
        # route minimally (the same collapse the cycle engines apply).
        comp = faults["comp"]
        keep = comp[mid] == comp[s]
        if not keep.all():
            pair = np.repeat(np.arange(F), m)[keep]
            counts = np.bincount(pair, minlength=F)
            s, d, mid = s[keep], d[keep], mid[keep]
            demand = rate[pair] / np.maximum(counts[pair], 1)
            parts = []
            if s.size:
                link_ids, ptr = trace_routes_via(topo, s, mid, d)
                parts.append(FlowProblem(
                    demand=demand, link_ids=link_ids, flow_ptr=ptr,
                    injection=_injection_mask(ptr), src=s, dst=d))
            lost = counts == 0
            if lost.any():
                parts.append(_minimal_problem(topo, src[lost], dst[lost],
                                              rate[lost]))
            return _concat_problems(parts)
    link_ids, ptr = trace_routes_via(topo, s, mid, d)
    return FlowProblem(demand=demand,
                       link_ids=link_ids, flow_ptr=ptr,
                       injection=_injection_mask(ptr), src=s, dst=d)


def _adaptive_problem(topo, src, dst, rate,
                      params: FlowParams) -> FlowProblem:
    """UGAL in the fluid limit, matching ``AdaptivePolicy``'s backlog
    test structurally: route minimally, find the flows whose worst link
    would run ``detour_weight`` times hotter than the fabric average
    (and above nominal capacity), and send them Valiant.

    One engine behaviour needs modelling beyond per-flow detours: a
    switch's terminals share injection FIFOs, so when *any* of its
    flows backs up enough to detour, the colocated flows see the same
    backlog signal and detour with it.  Hence the escalation — every
    flow sourced at a switch hosting a detoured flow goes Valiant too.
    This reproduces the oracle's adaptive knees (hotspot 0.6 rather
    than the no-saturation a pure per-flow rule would predict)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    rate = np.asarray(rate, np.float64)
    minimal = _minimal_problem(topo, src, dst, rate)
    cap = link_capacities(topo, minimal, params)
    L = cap.size
    entry_rate = np.repeat(minimal.demand, np.diff(minimal.flow_ptr))
    load_l = np.bincount(minimal.link_ids, weights=entry_rate, minlength=L)
    rho_l = load_l / cap
    entry_flow = np.repeat(np.arange(src.size), np.diff(minimal.flow_ptr))
    rho_f = np.zeros(src.size)
    np.maximum.at(rho_f, entry_flow, rho_l[minimal.link_ids])
    wired = topo.neighbor.reshape(-1) >= 0
    rho_bar = float(rho_l[wired].mean()) if wired.any() else 0.0
    detour = rho_f > max(params.detour_weight * rho_bar, 1.0)
    if not detour.any() or topo.num_switches < 3:
        return minimal
    go_valiant = np.isin(src, np.unique(src[detour]))
    parts = []
    if (~go_valiant).any():
        parts.append(_minimal_problem(topo, src[~go_valiant],
                                      dst[~go_valiant], rate[~go_valiant]))
    parts.append(_valiant_problem(topo, src[go_valiant], dst[go_valiant],
                                  rate[go_valiant], params))
    return _concat_problems(parts)


def solve_flows(topo: SimTopology, routing: str, src, dst, rate, *,
                params: FlowParams | None = None,
                device="cuda") -> FlowSolution:
    """Build and solve the flow problem for one demand matrix.

    On a degraded topology (:func:`repro_torch.faults.degrade`), demand
    entries whose endpoints died or were disconnected are dropped here —
    the one choke point every demand source (analytic patterns,
    empirical traffic, direct calls) passes through — mirroring the
    packet masking the cycle engines apply.  Offered load stays measured
    against the pristine switch count, so throughput retention curves
    read directly as survivability.  The solver runs on ``device``.
    """
    params = params or FlowParams()
    if (topo.meta or {}).get("faults") is not None:
        from repro_torch.faults import filter_pairs
        src, dst, rate = filter_pairs(topo, src, dst, rate)
    if routing == "minimal":
        problem = _minimal_problem(topo, src, dst, rate)
    elif routing == "valiant":
        problem = _valiant_problem(topo, src, dst, rate, params)
    elif routing == "adaptive":
        problem = _adaptive_problem(topo, src, dst, rate, params)
    else:
        raise ValueError(f"flow backend supports routing policies "
                         f"{ROUTINGS}, got {routing!r}")
    capacity = link_capacities(topo, problem, params)
    rates = maxmin_rates(problem.demand, problem.link_ids,
                         problem.flow_ptr, capacity,
                         max_iters=params.max_iters, solver=params.solver,
                         device=device)
    return FlowSolution(topo=topo, routing=routing, problem=problem,
                        capacity=capacity, rates=rates, params=params)


# ---------------------------------------------------------------------------
# Declarative pattern → demand matrix


def pattern_demands(topo: SimTopology, pattern: str, load: float,
                    terminals: int, params: FlowParams,
                    traffic_params: dict | None = None):
    """(src, dst, rate) for a declarative ``TrafficSpec`` pattern —
    the *expected* demand matrix of the stochastic generator, so no
    generation-sized arrays exist at 10k-switch scale."""
    kw = dict(traffic_params or {})
    kw.pop("seed", None)        # fixed generator seed: irrelevant in the mean
    if pattern == "uniform":
        return uniform_demands(topo, load, terminals, params)
    if pattern == "permutation":
        return permutation_demands(topo, load, terminals, params,
                                   perm=kw.get("perm"))
    if pattern == "hotspot":
        return hotspot_demands(
            topo, load, terminals, params,
            hot_fraction=float(kw.get("hot_fraction", 0.8)),
            hot_dst=kw.get("hot_dst"),
            partner_shift=kw.get("partner_shift"))
    if pattern == "adversarial":
        return adversarial_demands(topo, load, terminals, params)
    raise ValueError(f"flow backend has no analytic demand model for "
                     f"traffic pattern {pattern!r}")


_TRAFFIC_NAMES = {"uniform": "uniform", "permutation": "permutation",
                  "hotspot": "hotspot",
                  "adversarial": "adversarial-same-group"}


# ---------------------------------------------------------------------------
# RunStats synthesis


def _weighted_percentile(values, weights, q) -> float:
    order = np.argsort(values)
    v, w = np.asarray(values)[order], np.asarray(weights)[order]
    cum = np.cumsum(w)
    if cum[-1] <= 0:
        return 0.0
    return float(v[np.searchsorted(cum, q / 100.0 * cum[-1])])


def _stats_from_solution(sol: FlowSolution, *, policy: str, traffic: str,
                         offered: float, cycles: int, warmup: int,
                         terminals: int) -> RunStats:
    """A RunStats whose throughput fields carry the flow prediction.

    Latency fields are **hop-count proxies** (``hops + 1``, the
    engines' contention-free minimum) and link utilization is offered-
    rate based — documented lower bounds, not queueing estimates."""
    topo = sol.topo
    n = topo.num_switches
    meas = max(cycles - warmup, 1)
    hops = np.diff(sol.problem.flow_ptr)
    w = sol.rates
    total = float(w.sum())
    lat = hops + 1
    if total > 0:
        lat_mean = float((lat * w).sum() / total)
        lat_p50 = _weighted_percentile(lat, w, 50)
        lat_p99 = _weighted_percentile(lat, w, 99)
        lat_max = int(lat[w > 0].max())
    else:
        lat_mean = lat_p50 = 0.0
        lat_p99 = 0.0
        lat_max = 0
    hist_counts = np.round(
        np.bincount(lat, weights=w) * meas).astype(np.int64) \
        if lat.size else np.zeros(1, dtype=np.int64)
    served = sol.served
    wired = topo.neighbor.reshape(-1) >= 0
    util = served[wired]
    mean = float(util.mean()) if util.size else 0.0
    cv = float(util.std() / mean) if mean > 0 else 0.0
    delivered_window = int(round(total * meas))
    return RunStats(
        topology=topo.name, policy=policy, traffic=traffic,
        offered=offered, cycles=cycles, warmup=warmup,
        num_switches=n, terminals=terminals,
        packets_generated=int(round(sol.offered_rate * cycles)),
        packets_delivered=int(round(total * cycles)),
        delivered_in_window=delivered_window,
        accepted=total / (n * max(terminals, 1)),
        latency_mean=lat_mean, latency_p50=lat_p50, latency_p99=lat_p99,
        latency_max=lat_max, latency_histogram=hist_counts,
        link_loads=np.round(served * cycles).astype(np.int64),
        link_util_max=float(util.max()) if util.size else 0.0,
        link_util_mean=mean, link_util_cv=cv,
        in_flight_at_end=0,
    )


# ---------------------------------------------------------------------------
# Collective replay estimation


def replay_estimate(topo: SimTopology, workload
                    ) -> tuple[list[int], np.ndarray]:
    """Per-phase completion bound: a phase of ``messages`` packets per
    pair whose worst directed link carries ``k`` overlapping pair
    routes serializes to ``messages * k`` cycles (the engine moves one
    packet per link per cycle and phases are barriered, so stochastic
    HOL losses don't apply — deterministic schedules drain their links
    back-to-back).  Returns ``(phase_cycles, lifetime link loads)``.

    This is exactly how the Dragonfly all-to-all's ~4.4x plateau
    arises: each global step funnels ``a`` pair routes over one global
    link (k = a), while CIN/HyperX LACIN schedules keep k = 1 and meet
    the contention-free bound.
    """
    L = topo.num_switches * topo.num_ports
    loads = np.zeros(L)
    phase_cycles: list[int] = []
    for ph in workload.phases:
        link_ids, _ptr = trace_routes(topo, np.asarray(ph.src),
                                      np.asarray(ph.dst))
        if link_ids.size:
            counts = np.bincount(link_ids, minlength=L)
            k = int(counts.max())
            loads += counts * int(ph.messages)
        else:
            k = 1
        phase_cycles.append(int(ph.messages) * max(k, 1))
    return phase_cycles, loads


def replay_stats(topo: SimTopology, policy: str, traffic, workload, *,
                 terminals: int) -> RunStats:
    """RunStats for a collective replay, flow-level fidelity."""
    phase_cycles, loads = replay_estimate(topo, workload)
    completion = int(sum(phase_cycles))
    horizon = max(completion, 1)
    n = topo.num_switches
    # Latency proxy: per-phase route lengths + 1, message-weighted.
    lat_vals: list[np.ndarray] = []
    lat_w: list[np.ndarray] = []
    packets = 0
    for ph in workload.phases:
        _ids, ptr = trace_routes(topo, np.asarray(ph.src),
                                 np.asarray(ph.dst))
        lat_vals.append(np.diff(ptr) + 1)
        lat_w.append(np.full(len(ph.src), float(ph.messages)))
        packets += len(ph.src) * int(ph.messages)
    lat = np.concatenate(lat_vals) if lat_vals else np.zeros(0, np.int64)
    w = np.concatenate(lat_w) if lat_w else np.zeros(0)
    total_w = float(w.sum())
    wired = topo.neighbor.reshape(-1) >= 0
    util = loads[wired] / horizon
    mean = float(util.mean()) if util.size else 0.0
    stats = RunStats(
        topology=topo.name, policy=policy, traffic=traffic.name,
        offered=float(traffic.offered), cycles=completion, warmup=0,
        num_switches=n, terminals=terminals,
        packets_generated=packets, packets_delivered=packets,
        delivered_in_window=packets,
        accepted=packets / (n * max(terminals, 1) * horizon),
        latency_mean=float((lat * w).sum() / total_w) if total_w else 0.0,
        latency_p50=_weighted_percentile(lat, w, 50) if total_w else 0.0,
        latency_p99=_weighted_percentile(lat, w, 99) if total_w else 0.0,
        latency_max=int(lat.max()) if lat.size else 0,
        latency_histogram=(np.bincount(lat, weights=w).astype(np.int64)
                           if lat.size else np.zeros(1, np.int64)),
        link_loads=loads.astype(np.int64),
        link_util_max=float(util.max()) if util.size else 0.0,
        link_util_mean=mean,
        link_util_cv=float(util.std() / mean) if mean > 0 else 0.0,
        in_flight_at_end=0,
    )
    stats.phase_cycles = tuple(int(c) for c in phase_cycles)
    stats.completion_cycles = completion
    stats.ideal_cycles = int(workload.ideal_cycles)
    return stats


# ---------------------------------------------------------------------------
# Serving streams


def serving_stats(topo: SimTopology, routing: str, traffic, *,
                  terminals: int, cycles: int, warmup: int = 0,
                  params: FlowParams | None = None,
                  device="cuda") -> RunStats:
    """RunStats for a serving request stream at flow fidelity.

    Throughput comes from the max-min solution of the stream's empirical
    demand matrix (:func:`repro_torch.workload.serving_demands`).
    Per-request latency is the contention-free lower bound ``hops + P`` (a
    request's ``P`` packets serialize through one injection FIFO, so the
    last packet cannot deliver before ``hops + 1 + (P - 1)`` cycles after
    arrival), and requests on *saturated* pairs — allocated below their
    demanded rate — count as SLO misses outright.  Flow attainment is
    therefore an optimistic bound away from the knee and a hard zeroing
    at it: the same capacity cliff the cycle engines measure, at 10k+
    switch scale.  The solver runs on ``device``.
    """
    from repro_torch.workload.serving import serving_demands
    params = params or FlowParams()
    n = topo.num_switches
    src, dst, rate = serving_demands(traffic, n)
    sol = solve_flows(topo, routing, src, dst, rate, params=params,
                      device=device)
    stats = _stats_from_solution(sol, policy=routing, traffic=traffic.name,
                                 offered=float(traffic.offered),
                                 cycles=cycles, warmup=warmup,
                                 terminals=terminals)
    slo = getattr(traffic, "slo", None)
    stats.slo_target = float(slo) if slo is not None else None
    if traffic.request is None or traffic.num_packets == 0:
        stats.request_count = 0
        return stats
    pair_in = src * n + dst                      # sorted (np.unique output)
    # Allocated rate per input pair: the solution's flows keep their
    # originating (src, dst) even when valiant splits them over mids.
    alloc = np.zeros(pair_in.size)
    pkey = (np.asarray(sol.problem.src, np.int64) * n
            + np.asarray(sol.problem.dst, np.int64))
    idx = np.searchsorted(pair_in, pkey)
    ok = idx < pair_in.size
    ok[ok] &= pair_in[idx[ok]] == pkey[ok]
    np.add.at(alloc, idx[ok], sol.rates[ok])
    sat_pair = alloc < rate * (1.0 - 1e-6)
    # Minimal-route hop counts per pair; pairs a degraded fabric dropped
    # stay untraced and count as misses (the engines mask their packets).
    keep = np.ones(pair_in.size, dtype=bool)
    if (topo.meta or {}).get("faults") is not None:
        from repro_torch.faults import filter_pairs
        ksrc, kdst, _kr = filter_pairs(topo, src, dst, rate)
        keep = np.isin(pair_in, ksrc * n + kdst)
    hops = np.zeros(pair_in.size, dtype=np.int64)
    if keep.any():
        _ids, ptr = trace_routes(topo, src[keep], dst[keep])
        hops[keep] = np.diff(ptr)
    uniq, first, counts = np.unique(traffic.request, return_index=True,
                                    return_counts=True)
    r_pair = (traffic.src[first].astype(np.int64) * n
              + traffic.dst[first].astype(np.int64))
    pidx = np.searchsorted(pair_in, r_pair)
    lat = hops[pidx] + counts                    # hops + 1 + (P - 1)
    complete = keep[pidx] & ~sat_pair[pidx]
    stats.request_count = int(uniq.size)
    done = lat[complete]
    if done.size:
        p50, p95, p99 = np.percentile(done, [50, 95, 99])
        stats.request_latency_p50 = round(float(p50), 3)
        stats.request_latency_p95 = round(float(p95), 3)
        stats.request_latency_p99 = round(float(p99), 3)
    if slo is not None and uniq.size:
        met = int((done <= float(slo)).sum())
        stats.slo_attainment = round(met / uniq.size, 4)
    return stats


# ---------------------------------------------------------------------------
# Engine / Study seams


def _routing_from_policy(policy) -> tuple[str, FlowParams]:
    name = getattr(policy, "name", str(policy))
    if name not in ROUTINGS:
        raise ValueError(f"flow backend supports routing policies "
                         f"{ROUTINGS}, got {name!r}")
    params = FlowParams(detour_weight=float(getattr(policy, "weight", 2.0)))
    return name, params


def simulate_flow(topo: SimTopology, policy, traffic, *,
                  terminals: int | None = None, cycles: int | None = None,
                  warmup: int = 0, params: FlowParams | None = None,
                  device="cuda", **_engine_kw) -> RunStats:
    """The ``simulate(backend="flow")`` seam: same call shape as the
    cycle engines, flow-level fidelity out.  Queue-level knobs
    (``queue_capacity``, ``num_vcs``, ``eject_bw``, ``seed``, ...) are
    accepted and ignored — the fluid model has no queues.  The solver
    runs on ``device``."""
    from repro_torch.sim.traffic import resolve_terminals
    _resolve_device(device)
    routing, pparams = _routing_from_policy(policy)
    params = params or pparams
    T = resolve_terminals(traffic, terminals)
    if traffic.workload is not None:
        return replay_stats(topo, routing, traffic, traffic.workload,
                            terminals=T)
    if traffic.request is not None:
        horizon = (cycles if cycles is not None
                   else max(int(traffic.horizon), 1))
        return serving_stats(topo, routing, traffic, terminals=T,
                             cycles=horizon, warmup=warmup, params=params,
                             device=device)
    src, dst, rate = demands_from_traffic(traffic, topo.num_switches)
    # Empirical per-horizon rates are per-fabric totals already; the
    # generator drew them at `offered * terminals` per switch.
    sol = solve_flows(topo, routing, src, dst, rate, params=params,
                      device=device)
    horizon = cycles if cycles is not None else max(int(traffic.horizon), 1)
    return _stats_from_solution(sol, policy=routing, traffic=traffic.name,
                                offered=float(traffic.offered),
                                cycles=horizon, warmup=warmup, terminals=T)


def study_point_stats(exp, topo: SimTopology, tf, load: float, seed: int, *,
                      params: FlowParams | None = None,
                      device="cuda") -> RunStats:
    """One Study grid point at flow fidelity.

    Declarative open-loop patterns use their *analytic* demand matrix
    (nothing generation-sized is materialized, which is what makes the
    10k-switch grid points cheap); ``workload`` traffic goes through
    the replay estimator; inline traffic falls back to the empirical
    matrix of the generated packets.  The solver runs on ``device``.
    """
    _resolve_device(device)
    routing = exp.routing.label
    if routing not in ROUTINGS:
        raise ValueError(f"flow backend supports routing policies "
                         f"{ROUTINGS}, got {routing!r}")
    rparams = dict(exp.routing.params or {})
    params = params or FlowParams(
        detour_weight=float(rparams.get("weight", 2.0)))
    terminals = exp.terminals if exp.terminals is not None else 1
    sweep = exp.sweep
    pattern = exp.traffic.pattern

    if pattern == "workload":
        traffic = tf(load, seed)
        return replay_stats(topo, routing, traffic, traffic.workload,
                            terminals=terminals)
    if pattern == "serving":
        traffic = tf(load, seed)
        cycles = (sweep.cycles if sweep.cycles is not None
                  else max(int(traffic.horizon), 1))
        warmup = sweep.warmup if sweep.warmup is not None else 0
        return serving_stats(topo, routing, traffic, terminals=terminals,
                             cycles=cycles, warmup=warmup, params=params,
                             device=device)
    if pattern in _TRAFFIC_NAMES:
        src, dst, rate = pattern_demands(topo, pattern, load, terminals,
                                         params, dict(exp.traffic.params))
        sol = solve_flows(topo, routing, src, dst, rate, params=params,
                          device=device)
        cycles = sweep.cycles if sweep.cycles is not None else 1
        warmup = (sweep.warmup if sweep.warmup is not None
                  else cycles // 4)
        return _stats_from_solution(
            sol, policy=routing, traffic=_TRAFFIC_NAMES[pattern],
            offered=load, cycles=cycles, warmup=warmup,
            terminals=terminals)
    # Inline traffic: generate once and read off the empirical matrix.
    traffic = tf(load, seed)
    cycles = (sweep.cycles if sweep.cycles is not None
              else max(int(traffic.horizon), 1))
    warmup = (sweep.warmup if sweep.warmup is not None
              else 0 if traffic.workload is not None else cycles // 4)
    return simulate_flow(topo, type("P", (), {"name": routing})(), traffic,
                         terminals=terminals, cycles=cycles, warmup=warmup,
                         params=params, device=device)


# ---------------------------------------------------------------------------
# Saturation search (benchmarks / examples)


def saturation_load(topo: SimTopology, *, routing: str = "minimal",
                    pattern: str = "uniform", terminals: int = 1,
                    params: FlowParams | None = None,
                    traffic_params: dict | None = None,
                    lo: float = 0.01, hi: float = 2.0, tol: float = 0.005,
                    threshold: float = 0.95, device="cuda") -> float | None:
    """The flow model's saturation knee by bisection: the smallest
    offered load where accepted throughput drops below ``threshold *
    offered``.  Returns ``None`` when the fabric never saturates below
    ``hi`` (per-terminal loads above 1.0 are not injectable anyway).
    Every probe's solver runs on ``device``.
    """
    params = params or FlowParams()

    def saturated(load: float) -> bool:
        src, dst, rate = pattern_demands(topo, pattern, load, terminals,
                                         params, traffic_params)
        sol = solve_flows(topo, routing, src, dst, rate, params=params,
                          device=device)
        accepted = sol.delivered_rate / (topo.num_switches
                                         * max(terminals, 1))
        return accepted < threshold * load

    if not saturated(hi):
        return None
    if saturated(lo):
        return lo
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if saturated(mid):
            hi = mid
        else:
            lo = mid
    return round(hi, 4)
