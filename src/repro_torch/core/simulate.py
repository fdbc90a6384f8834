"""Flow-level network simulation for CIN / HyperX fabrics.

Validates the paper's structural claims without packet-level machinery:

* **Delivery**: every (src, dst) pair routed by the instance's table-free
  function arrives (diameter 1 for a CIN; <= D for HyperX DOR).
* **Contention-freedom of isoport step schedules**: in step ``i`` of a
  1-factor schedule every link of factor ``i`` carries exactly one flow in
  each direction; an anisoport (Swap-column) "schedule" concentrates
  endpoints and serializes.
* **Uniform-traffic link loads**: on a CIN every network link carries
  exactly ``2 / N``-normalized load under all-to-all switch traffic (each
  unordered pair exchanges two directed flows over its dedicated link).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .port_matrix import IDLE, port_matrix
from .routing import route
from .dragonfly import DragonflyConfig
from .hyperx import HyperXConfig


# ---------------------------------------------------------------------------
# CIN all-to-all (directed) link loads.
# ---------------------------------------------------------------------------

def cin_link_loads(instance: str, n: int) -> dict[tuple[int, int], int]:
    """Directed flow counts per (src_switch, dst_switch) link under
    all-to-all: every ordered pair (a, b), a != b, sends one unit flow.

    In a CIN the minimal path is the direct link, so every directed link
    carries exactly one flow — the ideal load balance the paper leverages.
    """
    P = port_matrix(instance, n)
    loads: dict[tuple[int, int], int] = {}
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            i = int(route(instance, a, b, n))
            t = int(P[a, i])
            assert t == b, f"{instance} N={n}: route({a},{b})={i} lands on {t}"
            loads[(a, b)] = loads.get((a, b), 0) + 1
    return loads


# ---------------------------------------------------------------------------
# Step schedules: 1-factor (isoport) vs column-of-Swap (anisoport).
# ---------------------------------------------------------------------------

@dataclass
class StepReport:
    step: int
    flows: int
    max_link_load: int      # flows sharing one directed link
    max_endpoint_in: int    # flows terminating at one switch
    idle_switches: int


def schedule_step_report(instance: str, n: int) -> list[StepReport]:
    """Simulate the step-wise exchange in which, at step ``i``, every switch
    sends through its port ``i`` (paper refs [8, 9]).

    Isoport instances: step ``i`` is 1-factor ``i`` — a perfect matching —
    so ``max_link_load == 1`` and ``max_endpoint_in == 1``.
    Swap: column ``i`` concentrates endpoints on switches ``i`` / ``i+1``.
    """
    P = port_matrix(instance, n)
    reports = []
    for i in range(P.shape[1]):
        col = P[:, i]
        in_counts = np.zeros(n, dtype=np.int64)
        link_counts: dict[tuple[int, int], int] = {}
        flows = idle = 0
        for s in range(n):
            t = int(col[s])
            if t == IDLE:
                idle += 1
                continue
            flows += 1
            in_counts[t] += 1
            link_counts[(s, t)] = link_counts.get((s, t), 0) + 1
        reports.append(StepReport(
            step=i, flows=flows,
            # default=0: a step can be all-idle (odd-N Circle columns).
            max_link_load=max(link_counts.values(), default=0),
            max_endpoint_in=int(in_counts.max()),
            idle_switches=idle))
    return reports


def all_to_all_steps(instance: str, n: int) -> int:
    """Steps for a full personalized all-to-all using the step schedule.

    Isoport: N-1 steps (N even) or N (odd; one idle per step).  Swap's
    column schedule is not a matching, so the serialized step count is the
    sum over columns of the max endpoint multiplicity.
    """
    reports = schedule_step_report(instance, n)
    if instance == "swap":
        return int(sum(r.max_endpoint_in for r in reports))
    return len(reports)


# ---------------------------------------------------------------------------
# Non-minimal (Valiant) routing — the paper's §3 adaptive sketch.
# ---------------------------------------------------------------------------

def valiant_link_loads(instance: str, n: int, flows: list[tuple[int, int, float]],
                       seed: int = 0, spread: bool = True) -> dict:
    """Two-hop Valiant routing on a CIN for a *hot-flow* traffic pattern.

    ``flows``: (src, dst, demand).  Minimal routing puts each flow on its
    single dedicated link (max link load = demand); Valiant splits the
    demand over all N-2 two-hop paths via random intermediates — the §3
    observation that non-minimal adaptivity needs either restricted routes
    or 2 VCs for deadlock freedom, traded for hot-link relief.

    Returns {max_min, max_valiant, vc_required}.
    """
    loads_min: dict[tuple[int, int], float] = {}
    loads_val: dict[tuple[int, int], float] = {}
    for a, b, demand in flows:
        if a == b:
            continue
        loads_min[(a, b)] = loads_min.get((a, b), 0.0) + demand
        mids = [m for m in range(n) if m not in (a, b)]
        if not spread or not mids:
            loads_val[(a, b)] = loads_val.get((a, b), 0.0) + demand
            continue
        share = demand / len(mids)
        for m in mids:
            loads_val[(a, m)] = loads_val.get((a, m), 0.0) + share
            loads_val[(m, b)] = loads_val.get((m, b), 0.0) + share
    return {
        "max_min": max(loads_min.values(), default=0.0),
        "max_valiant": max(loads_val.values(), default=0.0),
        "vc_required": 2,   # one VC per hop class (paper §3)
    }


# ---------------------------------------------------------------------------
# Hop-count accounting: the CIN diameter-1 advantage vs ring schedules.
# ---------------------------------------------------------------------------

def schedule_hop_counts(n: int) -> dict:
    """Datum-hops for an all-to-all: LACIN 1-factor schedules deliver every
    chunk in ONE hop (dedicated link); a ring schedule forwards chunk k
    through k intermediate devices."""
    lacin_total = n * (n - 1) * 1
    ring_total = n * sum(range(1, n))         # chunk to distance-k: k hops
    return {
        "lacin_hops_total": lacin_total,
        "ring_hops_total": ring_total,
        "lacin_max_hops": 1,
        "ring_max_hops": n - 1,
        "ratio": ring_total / lacin_total,
    }


# ---------------------------------------------------------------------------
# HyperX DOR link loads (uniform endpoint traffic).
# ---------------------------------------------------------------------------

def hyperx_link_loads(cfg: HyperXConfig, sample_pairs: int | None = None,
                      seed: int = 0) -> dict:
    """Directed network-link loads under uniform switch-to-switch traffic
    routed with DOR.  Returns summary stats; exact for small configs.
    """
    rng = np.random.default_rng(seed)
    n = cfg.num_switches
    coords = [cfg.switch_coord(s) for s in range(n)]
    loads: dict[tuple[tuple, tuple], int] = {}

    def add(a: tuple, b: tuple):
        loads[(a, b)] = loads.get((a, b), 0) + 1

    if sample_pairs is None:
        pairs = [(a, b) for a in range(n) for b in range(n) if a != b]
    else:
        pairs = []
        while len(pairs) < sample_pairs:
            a, b = rng.integers(0, n, 2)
            if a != b:
                pairs.append((int(a), int(b)))

    total_hops = 0
    for a, b in pairs:
        cur = list(coords[a])
        for d in range(cfg.num_dims):
            if cur[d] == coords[b][d]:
                continue
            nxt = cur.copy()
            nxt[d] = coords[b][d]
            add(tuple(cur), tuple(nxt))
            cur = nxt
            total_hops += 1
        assert tuple(cur) == coords[b]

    vals = np.array(list(loads.values()))
    return {
        "pairs": len(pairs),
        "total_hops": total_hops,
        "avg_hops": total_hops / len(pairs),
        "links_used": len(loads),
        "max_link_load": int(vals.max()),
        "min_link_load": int(vals.min()),
        "mean_link_load": float(vals.mean()),
        "load_cv": float(vals.std() / vals.mean()),
    }


# ---------------------------------------------------------------------------
# Dragonfly closed-form link loads (local/global split).
# ---------------------------------------------------------------------------

def dragonfly_link_loads(cfg: DragonflyConfig) -> dict:
    """Closed-form directed link loads under uniform switch-to-switch
    all-to-all (one unit per ordered switch pair), minimal l-g-l routing.

    Every directed *global* link carries exactly ``a**2`` units (all
    ordered switch pairs between its two groups) — the perfect balance of
    one dedicated link per group pair.  A directed *local* link
    ``(g, s) -> (g, t)`` carries::

        1  +  a * cnt_g[t]  +  a * cnt_g[s]

    where ``cnt_g[x]`` counts the peer groups whose global colour (the
    global CIN's port index ``route(g, peer)``) lives on switch ``x`` of
    group ``g``: the direct intra-group flow, plus source-side transit
    (``s`` sending to the ``a`` switches of each peer group exiting at
    ``t``), plus destination-side transit (flows from each peer group
    entering at ``s``, fanning out to ``t``).

    Returns ``{"local": {(g, s, t): load}, "global": {(g, h): a*a},
    "summary": {...}}``; cross-checked link-for-link against the packet
    simulator's :func:`repro_torch.sim.topology.dragonfly_topology` in tests.
    """
    a, g = cfg.group_size, cfg.num_groups
    local: dict[tuple[int, int, int], int] = {}
    glob: dict[tuple[int, int], int] = {}
    owner_counts = np.zeros((g, a), dtype=np.int64)
    for grp in range(g):
        for peer in range(g):
            if peer == grp:
                continue
            sw, _ = cfg.global_port_owner(grp, peer)
            owner_counts[grp, sw] += 1
            glob[(grp, peer)] = a * a
    for grp in range(g):
        cnt = owner_counts[grp]
        for s in range(a):
            for t in range(a):
                if s == t:
                    continue
                local[(grp, s, t)] = int(1 + a * cnt[t] + a * cnt[s])
    lvals = np.array(list(local.values())) if local else np.zeros(1)
    return {
        "local": local,
        "global": glob,
        "summary": {
            "global_link_load": a * a,
            "global_links_used": len(glob),
            "local_links_used": len(local),
            "local_max": int(lvals.max()),
            "local_min": int(lvals.min()),
            "local_mean": float(lvals.mean()),
            "total_units": int(sum(local.values()) + sum(glob.values())),
        },
    }
