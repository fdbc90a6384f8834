"""Routing policies: minimal, Valiant, and congestion-threshold adaptive.

A policy decides, *per packet at injection time*, the two-phase itinerary
``src -> mid -> dst`` (``mid == dst`` collapses to minimal).  In-network
forwarding is always the topology's table-free minimal route towards the
current phase's target, so every policy inherits the paper's §3 machinery;
non-minimal policies add the one extra decision the §3 sketch calls for.

Deadlock freedom uses distance-class virtual channels (the engine's VC
ladder: hop ``k`` travels in class ``min(k, V-1)``).  On a CIN this is
precisely the §3 argument: minimal routing needs 1 VC, any two-phase
non-minimal route needs 2 (``vc_required``); hierarchical compositions
scale the ladder with their diameter.
"""
from __future__ import annotations

import numpy as np


class RoutingPolicy:
    """Base: pure minimal routing (``mid = dst``)."""
    name = "minimal"
    vc_required = 1

    def on_inject(self, state, pids: np.ndarray) -> None:
        """Choose ``state.mid``/``state.phase`` for injection candidates.

        Called every cycle for every not-yet-injected candidate, so
        adaptive policies re-evaluate congestion until the packet wins
        injection arbitration.
        """
        state.mid[pids] = state.dst[pids]
        state.phase[pids] = 1


class MinimalPolicy(RoutingPolicy):
    """Table-free minimal routing (paper §3, Algorithm 2)."""


def _sample_mid(state, pids: np.ndarray) -> np.ndarray:
    """Uniform intermediate switch avoiding {src, dst} (shift-remap).

    On a degraded topology (``meta["faults"]``), mids that died or fell
    outside the source's component collapse to the destination — the
    packet routes minimally instead of detouring into a black hole.  The
    RNG draw happens unconditionally, so pristine runs consume the exact
    same stream (bit-identical behavior with no failures).
    """
    n = state.topo.num_switches
    s = state.src[pids]
    d = state.dst[pids]
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    r = state.rng.integers(0, n - 2, size=pids.size)
    r = r + (r >= lo)
    r = r + (r >= hi)
    faults = (state.topo.meta or {}).get("faults")
    if faults is not None:
        comp = faults["comp"]
        r = np.where(comp[r] == comp[s], r, d)
    return r


class ValiantPolicy(RoutingPolicy):
    """Two-phase Valiant: minimal to a random intermediate, then minimal to
    the destination.  Doubles the expected path length but randomizes any
    adversarial pattern into (two superimposed) uniform ones."""
    name = "valiant"
    vc_required = 2

    def on_inject(self, state, pids: np.ndarray) -> None:
        if state.topo.num_switches < 3 or pids.size == 0:
            super().on_inject(state, pids)
            return
        mid = _sample_mid(state, pids)
        state.mid[pids] = mid
        # A collapsed mid (degraded fabric) is already the destination:
        # skip phase 0 so the packet ejects on arrival.  Pristine mids
        # never equal the destination (shift-remap), so this is the
        # unconditional ``phase = 0`` of the pristine engine.
        state.phase[pids] = np.where(mid == state.dst[pids], 1, 0)


class AdaptivePolicy(RoutingPolicy):
    """Congestion-threshold adaptive (UGAL-style, local information).

    At injection, compare the congestion of the minimal first hop against
    a randomly sampled Valiant alternative, weighting the non-minimal side
    by its extra hop count: go non-minimal iff

        congestion_minimal > weight * congestion_valiant + threshold.

    Congestion is the engine's smoothed per-link *requested demand* plus
    the downstream credit occupancy: demand pressure exposes source-side
    contention (many heads wanting one hot link), credit occupancy exposes
    fabric-side backpressure.  With idle links everywhere this reduces to
    minimal routing; on a concentrated hot pair the minimal signal grows
    past the threshold and the policy detours — the §3 trade of hot-link
    relief for doubled hops.
    """
    name = "adaptive"
    vc_required = 2

    def __init__(self, threshold: float = 1.0, weight: float = 2.0):
        self.threshold = threshold
        self.weight = weight

    def _congestion(self, state, sw, port):
        return state.link_pressure(sw, port) + state.port_backlog(sw, port)

    def on_inject(self, state, pids: np.ndarray) -> None:
        if state.topo.num_switches < 3 or pids.size == 0:
            RoutingPolicy.on_inject(self, state, pids)
            return
        s = state.src[pids]
        d = state.dst[pids]
        c_min = self._congestion(state, s, state.topo.minimal_port(s, d))
        mid = _sample_mid(state, pids)
        c_val = self._congestion(state, s, state.topo.minimal_port(s, mid))
        # On degraded fabrics _sample_mid collapses unreachable mids to
        # the destination; treating that as "no detour" keeps the phase
        # bookkeeping exact.  Pristine mids never equal the destination.
        detour = (c_min > self.weight * c_val + self.threshold) & (mid != d)
        state.mid[pids] = np.where(detour, mid, d)
        state.phase[pids] = np.where(detour, 0, 1)


def make_policy(name: str, **kw) -> RoutingPolicy:
    if name == "minimal":
        return MinimalPolicy()
    if name == "valiant":
        return ValiantPolicy()
    if name == "adaptive":
        return AdaptivePolicy(**kw)
    raise ValueError(f"unknown routing policy {name!r}")
