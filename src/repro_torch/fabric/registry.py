"""CIN instance registry: one extension point for every topology layer.

The paper (§2) defines a CIN *instance* as a pairing of the ``N*(N-1)``
switch ports into the ``N*(N-1)/2`` links of K_N.  Everything an instance
needs downstream — P-matrix construction (:mod:`repro_torch.core.port_matrix`),
table-free routing (:mod:`repro_torch.core.routing`), 1-factor step schedules
(:mod:`repro_torch.core.schedule`), simulator adapters
(:mod:`repro_torch.sim.topology`), and the :class:`~repro_torch.fabric.Fabric`
implementations — is derived from four functions:

* ``neighbor(s, i, n)``   — switch reached through port ``i`` of ``s``
  (vectorized over numpy arrays; :data:`IDLE` marks an unwired port);
* ``route(a, b, n)``      — port used at ``a`` to reach ``b`` (the
  inverse of ``neighbor`` in the port argument);
* ``peer_port(s, i, n)``  — far-end port index of link ``(s, i)``.
  ``None`` declares the instance *isoport* (same index at both ends) —
  the paper's cabling discipline, and the property that makes every
  P-matrix column a 1-factor usable as a collective schedule step;
* ``route_torch(a, b, n)`` — optional branchless routing on torch
  tensors, safe inside a CUDA graph.  This slot is the reference's
  ``route_jnp``, renamed for what it now holds.

Registering an instance here makes it available to ``port_matrix()``,
``route()``, ``make_schedule()``, ``cin_topology()``, the Fabric API,
and the registry-parametrized verification suite in
``tests/test_port_matrix.py`` / ``tests/test_routing.py`` — with zero
edits to any of those modules.  The paper's ``swap`` / ``circle`` /
``xor`` instances are registered as built-ins below;
:mod:`repro_torch.fabric.mirror` registers a fourth purely through this public
API as proof.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.port_matrix import (IDLE, circle_neighbor,
                                          is_power_of_two, swap_neighbor,
                                          swap_peer_port, xor_neighbor)
from repro_torch.core.routing import (route_circle, route_circle_torch,
                                      route_swap, route_swap_torch, route_xor,
                                      route_xor_torch)


def _default_num_ports(n: int) -> int:
    return n - 1


@dataclass(frozen=True)
class InstanceSpec:
    """A registered CIN instance: construction + routing + metadata."""
    name: str
    neighbor: Callable          # (s, i, n) -> neighbor switch (IDLE = unwired)
    route: Callable             # (a, b, n) -> port index at a towards b
    peer_port: Callable | None = None   # (s, i, n) -> far-end port; None = isoport
    route_torch: Callable | None = None  # branchless torch routing, optional
    constraints: Callable | None = None  # (n) -> None, raises ValueError
    num_ports: Callable = _default_num_ports  # columns of the P matrix
    routing_ops: dict | None = None     # Table-1 style critical-path breakdown
    description: str = ""

    @property
    def isoport(self) -> bool:
        """True iff links pair same-index ports (``peer_port is None``)."""
        return self.peer_port is None

    def check(self, n: int) -> None:
        """Raise ``ValueError`` if the instance is undefined for size ``n``."""
        if n < 2:
            raise ValueError(f"CIN needs at least 2 switches, got N={n}")
        if self.constraints is not None:
            self.constraints(n)

    def supports(self, n: int) -> bool:
        try:
            self.check(n)
        except ValueError:
            return False
        return True

    def matrix(self, n: int) -> np.ndarray:
        """The (N, ports) port-pairing P matrix."""
        self.check(n)
        s = np.arange(n)[:, None]
        i = np.arange(self.num_ports(n))[None, :]
        return np.asarray(self.neighbor(s, i, n)).astype(np.int64)

    def peer_matrix(self, n: int) -> np.ndarray:
        """Far-end port index per (switch, port); ``-1`` on unwired ports."""
        P = self.matrix(n)
        ports = P.shape[1]
        if self.isoport:
            rev = np.broadcast_to(np.arange(ports, dtype=np.int64),
                                  P.shape).copy()
        else:
            s = np.arange(n)[:, None]
            i = np.arange(ports)[None, :]
            rev = np.asarray(self.peer_port(s, i, n)).astype(np.int64)
        return np.where(P == IDLE, -1, rev)


_REGISTRY: dict[str, InstanceSpec] = {}


def register_instance(name: str, *, neighbor, route, peer_port=None,
                      route_torch=None, constraints=None, num_ports=None,
                      routing_ops=None, description: str = "",
                      overwrite: bool = False) -> InstanceSpec:
    """Register a CIN instance under ``name`` and return its spec.

    All callables take the size ``n`` as their last argument (vectorized
    numpy semantics).  ``peer_port=None`` declares the instance isoport.
    Registration makes the instance usable everywhere a built-in is.
    """
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"CIN instance {name!r} is already registered; "
                         f"pass overwrite=True to replace it")
    if name in _REGISTRY:
        _drop_schedule_cache()  # re-registration invalidates cached tables
    spec = InstanceSpec(
        name=name, neighbor=neighbor, route=route, peer_port=peer_port,
        route_torch=route_torch, constraints=constraints,
        num_ports=num_ports or _default_num_ports,
        routing_ops=routing_ops, description=description)
    _REGISTRY[name] = spec
    return spec


def _drop_schedule_cache() -> None:
    """Invalidate registry-derived lru caches (if their modules are loaded):
    schedule tables and Dragonfly idle-column maps both memoize on the
    instance *name*, which a re-registration rebinds."""
    import sys
    sched = sys.modules.get("repro_torch.core.schedule")
    if sched is not None:
        sched.make_schedule.cache_clear()
    df = sys.modules.get("repro_torch.core.dragonfly")
    if df is not None:
        df._idle_columns.cache_clear()


def unregister_instance(name: str) -> None:
    """Remove a registered instance (primarily for tests)."""
    if _REGISTRY.pop(name, None) is not None:
        _drop_schedule_cache()


def get_instance(name: str) -> InstanceSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown CIN instance {name!r}; registered: "
            f"{instance_names()}") from None


def instance_names(isoport: bool | None = None) -> tuple[str, ...]:
    """Registered instance names, optionally filtered by the isoport flag."""
    return tuple(n for n, s in _REGISTRY.items()
                 if isoport is None or s.isoport == isoport)


def registered_instances() -> dict[str, InstanceSpec]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-ins: the paper's three instances (Figure 2).
# ---------------------------------------------------------------------------

def _pow2_constraint(n: int) -> None:
    if not is_power_of_two(n):
        raise ValueError(
            f"XOR CIN instance requires N to be a power of two, got {n}")


def _circle_num_ports(n: int) -> int:
    # Odd N: the (N+1)-even construction keeps N ports, one idle per switch.
    return n - 1 if n % 2 == 0 else n


register_instance(
    "swap",
    neighbor=lambda s, i, n: swap_neighbor(s, i),
    route=lambda a, b, n: route_swap(a, b),
    peer_port=lambda s, i, n: swap_peer_port(s, i),
    route_torch=lambda a, b, n: route_swap_torch(a, b),
    routing_ops={"xor_gates": 0, "add_sub": 1, "compare": 1,
                 "total_extra_vs_xor": 1},
    description="anisoport first-available pairing (paper Fig. 2a)")

register_instance(
    "circle",
    neighbor=circle_neighbor,
    route=route_circle,
    route_torch=route_circle_torch,
    num_ports=_circle_num_ports,
    routing_ops={"xor_gates": 0, "add_sub": 2, "compare": 3,
                 "total_extra_vs_xor": 5},
    description="isoport round-robin 1-factorization, any N "
                "(paper Alg. 1 / Fig. 2b)")

register_instance(
    "xor",
    neighbor=lambda s, i, n: xor_neighbor(s, i),
    route=lambda a, b, n: route_xor(a, b),
    route_torch=lambda a, b, n: route_xor_torch(a, b),
    constraints=_pow2_constraint,
    routing_ops={"xor_gates": 1, "add_sub": 1, "compare": 0,
                 "total_extra_vs_xor": 0},
    description="isoport XOR pairing, N = 2^k (paper Fig. 2c)")
