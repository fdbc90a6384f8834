"""Dragonfly networks with LACIN wiring (paper §5, Figure 3).

A Dragonfly connects ``num_groups`` switch groups via a *global* CIN; each
group of ``group_size`` switches is itself wired as a *local* CIN.  The
paper observes that:

* one-rack groups can use a vertical LACIN along the rack (local CIN);
* the global network applied as a LACIN induces a linear rack organisation;
  with co-packaged photonics, larger groups become rack *rows* with a
  horizontal local LACIN and column-wise global LACIN wiring;
* the 2-level partitioned layout of Fig. 3 (and HPE's 2x4-partition racks)
  is an alternative 2-D arrangement whose bundles our arithmetic below
  reproduces: 4 partitions of 4 switches = 24 intra + 96 inter links in
  6 hoses of 16 wires; 8 partitions = 28 bundles of 16.

Minimal routing is hierarchical: local hop to the switch owning the right
global port, global hop, local hop (l-g-l), each hop resolved by the CIN
instance's table-free routing.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .routing import route
from .port_matrix import IDLE, is_power_of_two


@lru_cache(maxsize=None)
def _idle_columns(instance: str, n: int) -> tuple[int, ...] | None:
    """Per-switch idle-port column of an odd-size isoport construction.

    Odd-``n`` instances built from the even ``n+1`` matrix keep ``n`` port
    columns with exactly one idle per switch (Circle: column ``s``;
    mirror: column ``-s mod n``).  Returns ``None`` when every column is
    wired (even sizes / ``n-1``-column instances).
    """
    from repro_torch.fabric.registry import get_instance
    spec = get_instance(instance)
    if spec.num_ports(n) != n:
        return None
    P = spec.matrix(n)
    return tuple(int(np.argmax(P[s] == IDLE)) for s in range(n))


@dataclass(frozen=True)
class DragonflyConfig:
    """Balanced dragonfly: ``a`` switches/group, ``p`` terminals/switch,
    ``h`` global ports/switch; canonical balance a = 2p = 2h,
    num_groups <= a*h + 1."""
    group_size: int                     # a
    terminals_per_switch: int           # p
    global_ports_per_switch: int        # h
    num_groups: int                     # g
    local_instance: str = "circle"
    global_instance: str = "circle"

    def __post_init__(self):
        if self.num_groups > self.group_size * self.global_ports_per_switch + 1:
            raise ValueError("too many groups: need g <= a*h + 1 for a global CIN")
        for inst, n in ((self.local_instance, self.group_size),
                        (self.global_instance, self.num_groups)):
            if inst == "xor" and not is_power_of_two(n):
                raise ValueError(f"xor instance needs power-of-two size, got {n}")

    # -- arithmetic -----------------------------------------------------------
    @property
    def switches(self) -> int:
        return self.group_size * self.num_groups

    @property
    def endpoints(self) -> int:
        return self.switches * self.terminals_per_switch

    @property
    def radix(self) -> int:
        return (self.terminals_per_switch + (self.group_size - 1)
                + self.global_ports_per_switch)

    @property
    def local_links_per_group(self) -> int:
        a = self.group_size
        return a * (a - 1) // 2

    @property
    def global_links(self) -> int:
        g = self.num_groups
        return g * (g - 1) // 2  # one (logical) global link per group pair

    @property
    def total_links(self) -> int:
        return self.num_groups * self.local_links_per_group + self.global_links

    # -- global-port ownership --------------------------------------------------
    def global_port_owner(self, group: int, peer_group: int) -> tuple[int, int]:
        """(switch within group, global-port slot) that carries the link from
        ``group`` to ``peer_group``.

        The g-1 global 'colours' of the group are distributed round-robin
        over the a*h global ports: colour c lives on switch c // h, slot
        c % h.  The colour is the global CIN's port index route(group,
        peer_group) — an isoport global instance gives the same colour at
        both ends (the cabling discipline of §5).

        Odd-g instances with g port columns (Circle/mirror) leave one
        colour per group idle; the used colours are compacted around it
        so all g-1 fit on the a*h ports even at num_groups == a*h + 1
        (mirrors :func:`repro_torch.sim.topology.dragonfly_topology`).
        """
        colour = int(route(self.global_instance, group, peer_group, self.num_groups))
        idle = _idle_columns(self.global_instance, self.num_groups)
        if idle is not None:
            colour -= colour > idle[group]
        return colour // self.global_ports_per_switch, colour % self.global_ports_per_switch

    # -- minimal routing ----------------------------------------------------------
    def route_packet(self, src: tuple[int, int, int], dst: tuple[int, int, int]
                     ) -> list[tuple[str, tuple]]:
        """Minimal l-g-l path between (group, switch, terminal) addresses.

        Returns a list of hops: ('local', (group, src_sw, port)) /
        ('global', (group, sw, slot)) / ('eject', (group, sw, terminal)).
        """
        (ga, sa, _), (gb, sb, tb) = src, dst
        hops: list[tuple[str, tuple]] = []
        cur_sw = sa
        if ga != gb:
            exit_sw, slot = self.global_port_owner(ga, gb)
            if cur_sw != exit_sw:
                port = int(route(self.local_instance, cur_sw, exit_sw, self.group_size))
                hops.append(("local", (ga, cur_sw, port)))
                cur_sw = exit_sw
            hops.append(("global", (ga, cur_sw, slot)))
            # arrive at the peer group's owner of the same colour (isoport!)
            cur_sw, _ = self.global_port_owner(gb, ga)
        if cur_sw != sb:
            port = int(route(self.local_instance, cur_sw, sb, self.group_size))
            hops.append(("local", (gb, cur_sw, port)))
            cur_sw = sb
        hops.append(("eject", (gb, cur_sw, tb)))
        return hops

    def max_hops(self) -> int:
        return 3  # l-g-l (plus ejection)


# ---------------------------------------------------------------------------
# Figure 3 / HPE partitioned-rack arithmetic.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PartitionedCIN:
    """A CIN of ``partitions * partition_size`` switches arranged as a
    2-level hierarchy (paper Fig. 3): full CINs inside partitions, and a
    partition-level CIN whose 'links' are bundles of
    ``partition_size**2`` wires."""
    partitions: int
    partition_size: int

    @property
    def switches(self) -> int:
        return self.partitions * self.partition_size

    @property
    def intra_links(self) -> int:
        m = self.partition_size
        return self.partitions * (m * (m - 1) // 2)

    @property
    def inter_links(self) -> int:
        p, m = self.partitions, self.partition_size
        return (p * (p - 1) // 2) * m * m

    @property
    def bundles(self) -> int:
        p = self.partitions
        return p * (p - 1) // 2

    @property
    def wires_per_bundle(self) -> int:
        return self.partition_size ** 2

    @property
    def total_links(self) -> int:
        n = self.switches
        return n * (n - 1) // 2

    def report(self) -> dict:
        assert self.intra_links + self.inter_links == self.total_links
        return {
            "switches": self.switches,
            "partitions": self.partitions,
            "partition_size": self.partition_size,
            "total_links": self.total_links,
            "intra_links": self.intra_links,
            "inter_links": self.inter_links,
            "bundles": self.bundles,
            "wires_per_bundle": self.wires_per_bundle,
        }


def fig3_16() -> PartitionedCIN:
    """Fig. 3: CIN-16 as 4 partitions of 4 — 120 links = 24 intra + 96
    inter, the 96 grouped in 6 hoses of 16 wires."""
    return PartitionedCIN(partitions=4, partition_size=4)


def hpe_dragonfly_group() -> PartitionedCIN:
    """HPE dragonfly group: 32 switches as 2x4 partition columns — 28
    bundles of 16 wires (paper §4)."""
    return PartitionedCIN(partitions=8, partition_size=4)


def frontier_like() -> DragonflyConfig:
    """A Frontier-scale-ish dragonfly for deployment reports (74 groups is
    Frontier's shape; we use a CIN-sized example with LACIN wiring)."""
    return DragonflyConfig(group_size=32, terminals_per_switch=16,
                           global_ports_per_switch=3, num_groups=64,
                           local_instance="circle", global_instance="circle")
