"""Minimal table-free routing for CIN instances (paper §3, Algorithm 2).

A computer has a two-digit global address ``C = (C1, C0)``: switch and
edge-port.  Intra-switch (``A1 == B1``) or after the single network hop the
packet ejects through port ``B0``.  For ``A1 != B1`` the network port is a
pure function of ``(A1, B1)`` — no routing tables:

* **XOR**:    ``i = A ^ B - 1``                       (logic gates + decrementer)
* **Swap**:   ``i = B - 1 if A < B else B``           (comparator + decrementer)
* **Circle**: paper Algorithm 2 (a handful of adds/compares), equivalent to
  the closed form ``i = (A + B) * inv2 mod (N-1)`` with ``inv2 = N/2``
  (since ``2 * N/2 = N ≡ 1 (mod N-1)``), plus the two ``N-1`` special cases.

NOTE (erratum): §3's prose states Swap routing as ``i = B if A <= B else
B + 1``, which contradicts §2's pairing rule ``P[S,i] ~ P[i+1,S] (S<=i)``;
routing consistent with the §2 construction is ``i = B-1 if A < B else B``.
We implement the §2-consistent form and verify ``route∘neighbor == id``
exhaustively in tests.

Two implementation tiers:
* ``route_*``      — scalar/numpy, faithful branch structure, used by the
                     simulator, benchmarks, and the hardware cost model.
* ``route_*_torch`` — branchless torch versions of the reference's
                     ``route_*_jnp`` twins: elementwise on tensors of any
                     device, no host synchronisation, safe inside a CUDA
                     graph.

Name-based dispatch (:func:`route` / :func:`route_torch` /
:func:`routing_ops`) resolves through the :mod:`repro_torch.fabric` registry,
so instances added via ``register_instance`` route here too.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Scalar / numpy routing (vectorized over arrays, faithful semantics).
# ---------------------------------------------------------------------------

def route_swap(a, b):
    """Port used at switch ``a`` to reach switch ``b`` (Swap instance)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return np.where(a < b, b - 1, b)


def route_xor(a, b):
    """Port used at switch ``a`` to reach switch ``b`` (XOR instance)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return (a ^ b) - 1


def route_circle(a, b, n):
    """Port used at switch ``a`` to reach ``b`` (Circle; paper Algorithm 2).

    Faithful to the published branch structure for even ``n``; odd ``n``
    uses the (n+1)-even construction (no ``n-1`` special cases, modulus n).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if n % 2 == 0:
        m = n - 1
        t = a + b
        parallel_even = t // 2
        parallel_odd_lo = (t + m) // 2          # T odd, T < N-1
        parallel_odd_hi = (t - m) // 2          # T odd, T > N-1
        parallel = np.where(
            t == m, 0,
            np.where(t % 2 == 0, parallel_even,
                     np.where(t < m, parallel_odd_lo, parallel_odd_hi)))
        return np.where(a == n - 1, b, np.where(b == n - 1, a, parallel))
    # Odd n: modulus n, inverse of 2 is (n+1)//2.
    inv2 = (n + 1) // 2
    return np.mod((a + b) * inv2, n)


def route_circle_closed(a, b, n):
    """Closed form of Algorithm 2: ``i = (A+B) * inv2 mod (N-1)`` (+ specials).

    Used to cross-check the faithful branch structure.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if n % 2 == 0:
        m = n - 1
        inv2 = n // 2  # 2 * (n/2) = n ≡ 1 (mod n-1)
        parallel = np.mod((a + b) * inv2, m)
        return np.where(a == n - 1, b, np.where(b == n - 1, a, parallel))
    inv2 = (n + 1) // 2
    return np.mod((a + b) * inv2, n)


def route(instance: str, a, b, n: int):
    """Routing for any registered CIN instance (via :mod:`repro_torch.fabric`):
    the port used at ``a`` to reach ``b``, computed table-free (§3).

    Routing is the inverse of the P matrix in the port argument:

    >>> int(route("xor", 5, 3, 8))        # 5 ^ 3 = 6 -> port 6 - 1
    5
    >>> from repro_torch.core.port_matrix import port_matrix
    >>> int(port_matrix("xor", 8)[5, route("xor", 5, 3, 8)])
    3
    """
    from repro_torch.fabric.registry import get_instance
    return get_instance(instance).route(a, b, n)


# ---------------------------------------------------------------------------
# Branchless torch routing (the reference's ``route_*_jnp`` twins).
# ---------------------------------------------------------------------------

def route_swap_torch(a, b):
    return torch.where(a < b, b - 1, b)


def route_xor_torch(a, b):
    return torch.bitwise_xor(a, b) - 1


def route_circle_torch(a, b, n: int):
    if n % 2 == 0:
        m = n - 1
        inv2 = n // 2
        parallel = torch.remainder((a + b) * inv2, m)
        return torch.where(a == n - 1, b,
                           torch.where(b == n - 1, a, parallel))
    inv2 = (n + 1) // 2
    return torch.remainder((a + b) * inv2, n)


def route_torch(instance: str, a, b, n: int):
    """Branchless routing on tensors for any registered instance providing
    one (the reference's ``route_jnp``)."""
    from repro_torch.fabric.registry import get_instance
    spec = get_instance(instance)
    if spec.route_torch is None:
        raise ValueError(
            f"CIN instance {instance!r} registered no branchless "
            f"route_torch; pass one to register_instance")
    return spec.route_torch(a, b, n)


# ---------------------------------------------------------------------------
# Hardware cost model (paper Table 1, 'Routing cost' column).
# ---------------------------------------------------------------------------

#: Number of adder/comparator-class operations on the routing critical path,
#: *additional to XOR* (whose cost is gates + one decrementer).  Matches the
#: paper's Table 1: Swap = 1 (one comparator), Circle = 5.
ROUTING_COST = {"xor": 0, "swap": 1, "circle": 5}


def routing_ops(instance: str) -> dict:
    """Arithmetic on the routing critical path, from the registry spec.

    For the paper's instances (Table 1): XOR is gates + one decrementer;
    Swap adds one comparator; Circle (Algorithm 2) adds T = A+B, compares
    against N-1 and a parity test, then one of T/2, (T+N-1)/2, (T-N+1)/2.
    """
    from repro_torch.fabric.registry import get_instance
    spec = get_instance(instance)
    if spec.routing_ops is None:
        raise ValueError(f"CIN instance {instance!r} registered no "
                         f"routing-cost breakdown")
    return dict(spec.routing_ops)


# ---------------------------------------------------------------------------
# End-to-end address routing (two-digit addresses, §3).
# ---------------------------------------------------------------------------

def route_packet(instance: str, n: int, src: tuple[int, int],
                 dst: tuple[int, int]) -> list[tuple[int, int]]:
    """Full minimal path as a list of (switch, port) hops.

    ``src``/``dst`` are (switch, edge_port) computer addresses.  Returns the
    sequence of (switch, output-port) decisions: at most one network hop
    followed by the ejection port ``B0``.
    """
    a1, _ = src
    b1, b0 = dst
    hops: list[tuple[int, int]] = []
    if a1 != b1:
        hops.append((a1, int(route(instance, a1, b1, n))))
    hops.append((b1, int(b0)))  # ejection through edge port B0
    return hops
