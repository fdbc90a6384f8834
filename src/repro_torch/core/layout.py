"""LACIN linear layouts: wire length and crossing analysis (paper §4).

Switches sit on a line at integer positions ``0..N-1``.  In an isoport
instance every link joins two ports with the same index, so links run
straight inside per-port-index "columns": link (a, b) has length ``|a-b|``.
The paper's claims reproduced here:

* K_N on a line needs ``w`` wires of length ``N-w`` (``1 <= w <= N-1``) and
  total wire length ``(N^3 - N) / 6`` — the minimum of any 1-D layout.
* Anisoport Swap needs oblique wires: a link with vertical span ``k`` has a
  horizontal run ``k-1`` (port offset), length ``sqrt(k^2 + (k-1)^2)``;
  asymptotically ``sqrt(2)`` times LACIN's total.
* Circle admits a crossing-free layout: each 1-factor ``i`` has >= N/2 - 1
  parallel links plus the single link (i, N-1) which crosses ``i`` of them
  for ``0 <= i <= N/2-1`` and ``N-2-i`` for ``N/2 <= i <= N-2``; routing the
  parallel wires right of the port column and the crossing wire left of it
  removes all crossings.
* XOR layouts keep in-factor crossings that grow with N.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .factorization import factors
from .port_matrix import IDLE, port_matrix, swap_peer_port


# ---------------------------------------------------------------------------
# Wire length.
# ---------------------------------------------------------------------------

def wire_length_histogram(n: int) -> dict[int, int]:
    """#wires at each length for any complete graph on a line.

    Length ``d`` occurs ``N - d`` times; equivalently ``w`` wires of length
    ``N - w``.
    """
    return {d: n - d for d in range(1, n)}


def lacin_total_wire_length(n: int) -> int:
    """Exact total wire length of a LACIN: sum_d d*(N-d) = (N^3 - N)/6."""
    return (n ** 3 - n) // 6


def lacin_total_wire_length_enumerated(n: int) -> int:
    """Same total, by explicit enumeration (cross-check for tests)."""
    return sum(d * c for d, c in wire_length_histogram(n).items())


def swap_total_wire_length(n: int) -> float:
    """Exact oblique total for the linear Swap layout.

    Every K_N edge appears once; a Swap link between switches at vertical
    distance ``k`` connects ports whose indices differ by ``k - 1``
    (``P[S,i] ~ P[i+1,S]``: |i - S| = k-1 for S <= i), hence length
    ``sqrt(k^2 + (k-1)^2)`` under the paper's similar-spacing assumption.
    """
    P = port_matrix("swap", n)
    total = 0.0
    seen = set()
    for s in range(n):
        for i in range(n - 1):
            t = int(P[s, i])
            j = int(swap_peer_port(s, i))
            key = tuple(sorted(((s, i), (t, j))))
            if key in seen:
                continue
            seen.add(key)
            k = abs(t - s)
            h = abs(j - i)
            total += math.hypot(k, h)
    return total


def swap_to_lacin_ratio(n: int) -> float:
    """Swap oblique total / LACIN straight total — approaches sqrt(2)."""
    return swap_total_wire_length(n) / lacin_total_wire_length(n)


# ---------------------------------------------------------------------------
# Crossing analysis.
# ---------------------------------------------------------------------------

def _pairs_cross(e1: tuple[int, int], e2: tuple[int, int]) -> bool:
    """Two links drawn as arcs in the same column cross iff they interleave."""
    (a1, b1), (a2, b2) = sorted(e1), sorted(e2)
    if (a1, b1) == (a2, b2):
        return False
    return (a1 < a2 < b1 < b2) or (a2 < a1 < b2 < b1)


def factor_crossings(edges: list[tuple[int, int]]) -> int:
    """Number of crossing pairs among same-column (same 1-factor) links."""
    c = 0
    for x in range(len(edges)):
        for y in range(x + 1, len(edges)):
            if _pairs_cross(edges[x], edges[y]):
                c += 1
    return c


def instance_crossings(instance: str, n: int) -> list[int]:
    """Per-1-factor crossing counts for a naive single-track-per-column layout."""
    P = port_matrix(instance, n)
    return [factor_crossings(f) for f in factors(P)]


def circle_predicted_crossings(n: int) -> list[int]:
    """Paper §4 closed form: 1-factor ``i``'s crossing link (i, N-1) crosses
    ``i`` parallel links for i < N/2 and ``N-2-i`` for i >= N/2."""
    assert n % 2 == 0
    return [i if i <= n // 2 - 1 else n - 2 - i for i in range(n - 1)]


def circle_layout_crossings_with_rule(n: int) -> int:
    """Crossings after the paper's left/right rule — always zero.

    Parallel wires of factor ``i`` run on the right sub-track of column
    ``i``; the single potentially-crossing wire (i, N-1) runs on the left
    sub-track.  Two wires on different sub-tracks cannot cross; parallel
    wires of the same factor are nested/disjoint (never interleave).
    """
    P = port_matrix("circle", n)
    total = 0
    for i, f in enumerate(factors(P)):
        special = tuple(sorted((i, n - 1))) if n % 2 == 0 else None
        parallels = [e for e in f if e != special]
        # left sub-track: the special wire alone -> 0 crossings there.
        # right sub-track: parallel wires only.
        total += factor_crossings(parallels)
    return total


@dataclass(frozen=True)
class LayoutRow:
    """One row of the paper's Table 1."""
    instance: str
    isoport: bool
    sizes: str
    wire_length_norm: float  # total wire length / LACIN minimum (asymptotic)
    routing_cost: int | None  # extra adders/comparators vs XOR


def table1(n: int = 64) -> list[LayoutRow]:
    """Reproduce Table 1 (normalized wire length evaluated at ``n``)."""
    from .routing import ROUTING_COST
    return [
        LayoutRow("swap", False, "Any", swap_to_lacin_ratio(n), ROUTING_COST["swap"]),
        LayoutRow("circle", True, "Any", 1.0, ROUTING_COST["circle"]),
        LayoutRow("xor", True, "N=2^n", 1.0, ROUTING_COST["xor"]),
    ]


# ---------------------------------------------------------------------------
# Deployment report: per-column track usage (cable organisation, §2 end).
# ---------------------------------------------------------------------------

def column_report(instance: str, n: int) -> list[dict]:
    """Per port-index 'colour': #links, total length, crossings — the
    cable-organisation view the paper argues isoport instances enable."""
    P = port_matrix(instance, n)
    out = []
    if instance == "swap":
        # Anisoport: columns are not matchings; report endpoint concentration.
        from .factorization import column_contention
        cont = column_contention(P)
        for i in range(P.shape[1]):
            out.append({"column": i, "matching": False,
                        "max_endpoint_multiplicity": int(cont[i])})
        return out
    for i, f in enumerate(factors(P)):
        out.append({
            "column": i,
            "matching": True,
            "num_links": len(f),
            "total_length": sum(b - a for a, b in f),
            "naive_crossings": factor_crossings(f),
        })
    return out
