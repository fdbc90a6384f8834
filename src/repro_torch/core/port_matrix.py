"""Port-pairing matrices for Complete Interconnection Networks (paper §2).

A CIN of ``N`` switches is modeled by a port-pairing matrix ``P`` with ``N``
rows (switches) and ``N-1`` columns (network ports).  ``P[S, i]`` records the
*neighbour switch* reached through port ``i`` of switch ``S``.  The
``N*(N-1)`` ports are paired by ``N*(N-1)/2`` links forming the complete
graph K_N; different pairings are different *CIN instances*.

This module holds the *primitive* neighbour functions of the paper's
three instances (Figure 2):

* ``swap``   — anisoport baseline: successively connect each switch to all
  the others using the first available ports.  ``P[S, i]`` pairs with
  ``P[i+1, S]`` when ``S <= i`` and with ``P[i, S-1]`` when ``S > i``.
* ``circle`` — isoport, any ``N``.  Round-robin-tournament 1-factorization
  (paper Algorithm 1).  Odd ``N`` is obtained from the even ``N+1`` matrix
  by deleting the last row (one idle port per switch remains).
* ``xor``    — isoport, ``N = 2**n``.  Port index ``i = A ^ B - 1``; since
  XOR is self-inverse, ``P[S, i]`` pairs with ``P[S ^ (i+1), i]``.

Instance *dispatch* lives in the :mod:`repro_torch.fabric.registry`: the
primitives below are registered there as built-ins, and
:func:`port_matrix` / :func:`verify_instance` resolve names through the
registry — so ``repro_torch.fabric.register_instance`` extends them (and every
downstream consumer) without edits here.

Everything here is plain ``numpy`` — these are construction/verification
tools, not traced code.  The branchless torch routing used inside the
cycle engine lives in :mod:`repro_torch.core.routing`.
"""
from __future__ import annotations

import numpy as np

# Sentinel for an idle (unconnected) port.  Only appears for odd-N Circle.
IDLE = -1


def _require_positive(n: int) -> None:
    if n < 2:
        raise ValueError(f"CIN needs at least 2 switches, got N={n}")


def is_power_of_two(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------------
# Neighbour functions (scalar semantics, vectorized over numpy arrays).
# ---------------------------------------------------------------------------

def swap_neighbor(s, i):
    """Neighbour of switch ``s`` through port ``i`` in the Swap instance."""
    s = np.asarray(s)
    i = np.asarray(i)
    return np.where(s <= i, i + 1, i)


def swap_peer_port(s, i):
    """Port index used on the *other* end of Swap link (s, i) — anisoport."""
    s = np.asarray(s)
    i = np.asarray(i)
    return np.where(s <= i, s, s - 1)


def circle_neighbor(s, i, n):
    """Neighbour of switch ``s`` through port ``i`` in the Circle instance.

    Implements paper Algorithm 1 for even ``n``.  For odd ``n`` the matrix
    is the even ``n+1`` construction with the last row removed; port ``i``
    of switch ``i`` becomes IDLE.
    """
    s = np.asarray(s)
    i = np.asarray(i)
    if n % 2 == 0:
        m = n - 1  # modulus
        parallel = np.mod(2 * i - s, m)
        out = np.where(s == n - 1, i, np.where(s == i, n - 1, parallel))
        return out
    # Odd n: even construction on n+1 switches, last switch removed.
    m = n  # (n+1) - 1
    parallel = np.mod(2 * i - s, m)
    return np.where(s == i, IDLE, parallel)


def xor_neighbor(s, i):
    """Neighbour of switch ``s`` through port ``i`` in the XOR instance."""
    s = np.asarray(s)
    i = np.asarray(i)
    return s ^ (i + 1)


# ---------------------------------------------------------------------------
# P-matrix builders.
# ---------------------------------------------------------------------------

def swap_matrix(n: int) -> np.ndarray:
    """Swap (anisoport) P matrix, any ``N >= 2`` (paper Fig. 2a)."""
    _require_positive(n)
    s = np.arange(n)[:, None]
    i = np.arange(n - 1)[None, :]
    return swap_neighbor(s, i).astype(np.int64)


def circle_matrix(n: int) -> np.ndarray:
    """Circle (isoport) P matrix, any ``N >= 2`` (paper Alg. 1 / Fig. 2b)."""
    _require_positive(n)
    s = np.arange(n)[:, None]
    if n % 2 == 0:
        i = np.arange(n - 1)[None, :]
        return circle_neighbor(s, i, n).astype(np.int64)
    # Odd N: ports 0..n-1 exist (from the (n+1)-even construction) but we
    # keep the canonical n-1+1 = n columns?  The even construction on n+1
    # switches has n ports per switch; after deleting the last switch every
    # remaining switch keeps n ports, one of which is idle.
    i = np.arange(n)[None, :]
    return circle_neighbor(s, i, n).astype(np.int64)


def xor_matrix(n: int) -> np.ndarray:
    """XOR (isoport) P matrix, ``N = 2**n`` only (paper Fig. 2c)."""
    _require_positive(n)
    if not is_power_of_two(n):
        raise ValueError(f"XOR CIN instance requires N to be a power of two, got {n}")
    s = np.arange(n)[:, None]
    i = np.arange(n - 1)[None, :]
    return xor_neighbor(s, i).astype(np.int64)


def port_matrix(instance: str, n: int) -> np.ndarray:
    """P matrix of any registered CIN instance (resolved via the
    :mod:`repro_torch.fabric` registry).

    ``P[s, i]`` is the switch that port ``i`` of switch ``s`` links to;
    for isoport instances the far end uses the *same* port index — the
    paper's cabling discipline:

    >>> port_matrix("xor", 4)
    array([[1, 2, 3],
           [0, 3, 2],
           [3, 0, 1],
           [2, 1, 0]])
    >>> int(port_matrix("xor", 4)[port_matrix("xor", 4)[1, 2], 2])
    1
    """
    from repro_torch.fabric.registry import get_instance
    return get_instance(instance).matrix(n)


# ---------------------------------------------------------------------------
# Structural checks (used by tests and by the simulator).
# ---------------------------------------------------------------------------

def is_complete(P: np.ndarray) -> bool:
    """Every switch sees every other switch exactly once across its ports."""
    n = P.shape[0]
    for s in range(n):
        row = P[s]
        row = row[row != IDLE]
        expect = sorted(set(range(n)) - {s})
        if sorted(row.tolist()) != expect:
            return False
    return True


def is_isoport(P: np.ndarray) -> bool:
    """True iff every link pairs ports with the same index.

    Port ``i`` of ``S`` reaches ``T = P[S, i]``; the instance is isoport iff
    ``P[T, i] == S`` for every non-idle entry — i.e. each column is an
    involution (a perfect matching = 1-factor).
    """
    n, p = P.shape
    for i in range(p):
        col = P[:, i]
        for s in range(n):
            t = col[s]
            if t == IDLE:
                continue
            if not (0 <= t < n) or col[t] != s:
                return False
    return True


def links(P: np.ndarray, peer_port=None) -> set[tuple[tuple[int, int], tuple[int, int]]]:
    """The set of links as ((switch, port), (switch, port)) endpoint pairs.

    ``peer_port(s, i)`` gives the far-end port index; defaults to the
    isoport rule (same index).  Each link appears once (endpoints sorted).
    """
    n, p = P.shape
    out = set()
    for s in range(n):
        for i in range(p):
            t = int(P[s, i])
            if t == IDLE:
                continue
            j = int(peer_port(s, i)) if peer_port is not None else i
            a, b = (s, i), (t, j)
            out.add((a, b) if a <= b else (b, a))
    return out


def edge_set(P: np.ndarray) -> set[tuple[int, int]]:
    """The set of undirected switch pairs covered by the instance."""
    return {tuple(sorted((s, int(t)))) for s in range(P.shape[0])
            for t in P[s] if t != IDLE}


def verify_instance(instance: str, n: int) -> dict:
    """Full structural verification of a registered CIN instance.

    The far-end port rule comes from the registry spec: isoport instances
    pair same-index ports; anisoport ones supply ``peer_port``.
    """
    from repro_torch.fabric.registry import get_instance
    spec = get_instance(instance)
    P = spec.matrix(n)
    peer = None if spec.isoport else (lambda s, i: spec.peer_port(s, i, n))
    L = links(P, peer_port=peer)
    n_idle = int(np.sum(P == IDLE))
    expected_links = (n * (n - 1)) // 2
    report = {
        "instance": instance,
        "n": n,
        "complete": is_complete(P),
        "isoport": is_isoport(P),
        "num_links": len(L),
        "expected_links": expected_links,
        "num_idle_ports": n_idle,
        "covers_K_N": edge_set(P) == {(a, b) for a in range(n) for b in range(a + 1, n)},
    }
    report["ok"] = (report["complete"] and report["covers_K_N"]
                    and report["num_links"] == report["expected_links"])
    return report
