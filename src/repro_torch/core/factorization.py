"""1-factorizations of K_N extracted from isoport P matrices (paper §2).

A *1-factor* of an even-order graph is a perfect matching; a
*1-factorization* of K_N (N even) partitions its N(N-1)/2 edges into N-1
1-factors.  Isoport CIN instances use the N ports of index ``i`` to build
1-factor ``i`` — this is the structural property behind both the cabling
discipline (§4) and the step-wise all-to-all schedules (§2, refs [8,9]).
"""
from __future__ import annotations

import numpy as np

from .port_matrix import IDLE, port_matrix


def factor(P: np.ndarray, i: int) -> list[tuple[int, int]]:
    """Edge list of 1-factor ``i`` (column ``i``) of an isoport P matrix."""
    col = P[:, i]
    edges = set()
    for s, t in enumerate(col):
        t = int(t)
        if t == IDLE:
            continue
        edges.add((min(s, t), max(s, t)))
    return sorted(edges)


def factors(P: np.ndarray) -> list[list[tuple[int, int]]]:
    """All 1-factors of an isoport P matrix."""
    return [factor(P, i) for i in range(P.shape[1])]


def is_perfect_matching(edges: list[tuple[int, int]], n: int) -> bool:
    """Every vertex covered exactly once (n even) or exactly one idle (odd)."""
    seen: set[int] = set()
    for a, b in edges:
        if a == b or a in seen or b in seen:
            return False
        seen.update((a, b))
    if n % 2 == 0:
        return len(seen) == n
    return len(seen) == n - 1  # one idle switch per factor for odd N


def is_one_factorization(P: np.ndarray) -> bool:
    """Columns are disjoint perfect matchings that cover K_N."""
    n = P.shape[0]
    all_edges: set[tuple[int, int]] = set()
    for i in range(P.shape[1]):
        f = factor(P, i)
        if not is_perfect_matching(f, n):
            return False
        fs = set(f)
        if all_edges & fs:
            return False  # factors must be edge-disjoint
        all_edges |= fs
    return all_edges == {(a, b) for a in range(n) for b in range(a + 1, n)}


def factorization(instance: str, n: int) -> list[list[tuple[int, int]]]:
    """The 1-factorization induced by an isoport instance."""
    if instance == "swap":
        raise ValueError("swap is anisoport: its columns are not 1-factors")
    return factors(port_matrix(instance, n))


def column_contention(P: np.ndarray) -> np.ndarray:
    """Per-column max endpoint multiplicity.

    1.0 for isoport instances (each column is a matching).  For Swap this
    quantifies why the 'port i' step is NOT contention-free: column ``i``
    concentrates endpoints on switches ``i`` and ``i+1``.
    """
    n, p = P.shape
    out = np.zeros(p, dtype=np.int64)
    for i in range(p):
        col = P[:, i]
        counts = np.zeros(n, dtype=np.int64)
        for s, t in enumerate(col):
            if int(t) == IDLE:
                continue
            counts[int(t)] += 1
        out[i] = counts.max()
    return out
