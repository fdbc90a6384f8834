"""The ``mirror`` instance: Circle with reversed port colouring.

Registered purely through :func:`repro_torch.fabric.register_instance` — no
dispatch code anywhere in ``repro_torch.core`` knows about it — as the proof
that the registry is a complete extension point: P-matrix construction,
table-free routing, 1-factor schedules, simulator topologies, Fabric
objects, and the registry-parametrized verification suite all pick it up
automatically.

Construction: relabel the switches of the Circle instance by the modular
reflection ``r(s) = (m - s) mod m`` (``m = N-1`` for even ``N``, ``m = N``
odd; the special switch ``N-1`` is fixed).  Conjugating every 1-factor by
``r`` preserves matchings, edge-disjointness and K_N coverage, and works
out to a pure *column reversal* of the Circle matrix: mirror port ``i``
is Circle port ``(-i) mod ports``.  The result is a genuinely different
isoport P matrix (different port colours on every wire for ``N > 3``)
whose routing function is one extra modular negation on top of
Algorithm 2.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.port_matrix import circle_neighbor
from repro_torch.core.routing import route_circle, route_circle_torch

from .registry import register_instance


def _ports(n: int) -> int:
    return n - 1 if n % 2 == 0 else n


def mirror_neighbor(s, i, n):
    """Neighbour of switch ``s`` through port ``i``: Circle column ``-i``."""
    i = np.asarray(i)
    c = _ports(n)
    return circle_neighbor(s, np.mod(-i, c), n)


def mirror_route(a, b, n):
    """Port at ``a`` towards ``b``: the reflected Circle port index."""
    c = _ports(n)
    return np.mod(-np.asarray(route_circle(a, b, n)), c)


def mirror_route_torch(a, b, n):
    """:func:`mirror_route` on tensors, branchless (reference
    ``mirror_route_jnp``)."""
    c = _ports(n)
    return torch.remainder(-route_circle_torch(a, b, n), c)


spec = register_instance(
    "mirror",
    neighbor=mirror_neighbor,
    route=mirror_route,
    route_torch=mirror_route_torch,
    num_ports=_ports,
    routing_ops={"xor_gates": 0, "add_sub": 3, "compare": 3,
                 "total_extra_vs_xor": 6},
    description="isoport reflected Circle (reversed port colours), any N — "
                "registered via the public registry API")
