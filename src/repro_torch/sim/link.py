"""Link model: flat link ids, downstream-queue arithmetic, load counters.

A directed link is identified by ``link_id = switch * num_ports + port``.
Each physical link feeds exactly one input port at its far end, so the
downstream (switch, input-port, VC) queue of a hop is a pure function of
the link id and the virtual channel — which is what makes the per-cycle
credit check a single gather.

Links have unit bandwidth (one packet per cycle per direction) and unit
latency (a packet popped from the upstream queue at cycle ``c`` is at the
head of the downstream queue no earlier than cycle ``c+1``).
"""
from __future__ import annotations

import numpy as np

from .topology import SimTopology


class LinkTable:
    @classmethod
    def for_topology(cls, topo: SimTopology, num_vcs: int) -> "LinkTable":
        """Memoized constructor: one table per (topology, num_vcs).

        A saturation sweep builds a fresh :class:`~repro_torch.sim.engine.Engine`
        per (load, seed) point over the *same* topology; the table is pure
        read-only topology data, so every point can share one instance
        instead of re-flattening the neighbour matrices each time.
        """
        cache = topo.__dict__.setdefault("_link_tables", {})
        table = cache.get(num_vcs)
        if table is None:
            table = cache[num_vcs] = cls(topo, num_vcs)
        return table

    def __init__(self, topo: SimTopology, num_vcs: int):
        self.topo = topo
        self.num_vcs = num_vcs
        self.num_ports = topo.num_ports
        self.neighbor_flat = topo.neighbor.reshape(-1)      # (N*P,)
        self.rev_flat = topo.rev_port.reshape(-1)           # (N*P,)
        self.wired = self.neighbor_flat >= 0
        self.num_link_slots = self.neighbor_flat.size

    def link_ids(self, switch: np.ndarray, port: np.ndarray) -> np.ndarray:
        return switch * self.num_ports + port

    def dest_queue(self, link_ids: np.ndarray, vc: np.ndarray) -> np.ndarray:
        """Queue index of the far-end (switch, input-port, VC) buffer."""
        nbr = self.neighbor_flat[link_ids]
        rp = self.rev_flat[link_ids]
        return (nbr * self.num_ports + rp) * self.num_vcs + vc

    def endpoints(self, link_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(src_switch, dst_switch) of each directed link id."""
        return link_ids // self.num_ports, self.neighbor_flat[link_ids]


class LinkLoadCounter:
    """Per-directed-link traversal counts: lifetime totals plus a
    measurement window (reset at the end of warmup)."""

    def __init__(self, table: LinkTable):
        self.table = table
        self.total = np.zeros(table.num_link_slots, dtype=np.int64)
        self.window = np.zeros(table.num_link_slots, dtype=np.int64)

    def record(self, link_ids: np.ndarray) -> None:
        # One winner per link per cycle -> ids are unique within a call.
        self.total[link_ids] += 1
        self.window[link_ids] += 1

    def reset_window(self) -> None:
        self.window[:] = 0

    def by_switch_pair(self, counts: np.ndarray | None = None
                       ) -> dict[tuple[int, int], int]:
        """{(src_switch, dst_switch): traversals} over wired links, matching
        the key convention of :func:`repro_torch.core.simulate.cin_link_loads`."""
        counts = self.total if counts is None else counts
        used = np.nonzero((counts > 0) & self.table.wired)[0]
        s, t = self.table.endpoints(used)
        return {(int(a), int(b)): int(c)
                for a, b, c in zip(s, t, counts[used])}

    def utilization(self, cycles: int) -> dict[str, float]:
        """Windowed per-link load summary, normalized to link bandwidth."""
        loads = self.window[self.table.wired] / max(cycles, 1)
        if loads.size == 0:
            return {"max": 0.0, "mean": 0.0, "cv": 0.0}
        mean = float(loads.mean())
        return {
            "max": float(loads.max()),
            "mean": mean,
            "cv": float(loads.std() / mean) if mean > 0 else 0.0,
        }
