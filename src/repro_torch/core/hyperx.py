"""HyperX networks wired with LACINs (paper §5, Figure 4).

A HyperX is the Cartesian product of complete graphs: switches carry a
coordinate vector ``(c_{D-1}, ..., c_0)`` with ``c_d in [0, K_d)``; switches
that differ in exactly one coordinate are connected — each "row" along a
dimension is a CIN of size ``K_d``.  The paper's flagship example is the
16x16x16 HyperX with 16 terminals per switch: 65,536 end-points, 4,096
radix-61 switches, wired with XOR LACINs (16 = 2^4).

This module provides addressing, per-dimension LACIN port selection,
dimension-order routing (DOR), and the physical deployment arithmetic
(racks, super-ports, hoses, colour classes) that §5 and Fig. 4 describe.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product

import numpy as np

from .routing import route
from .port_matrix import port_matrix, is_power_of_two


@dataclass(frozen=True)
class HyperXConfig:
    """A HyperX: ``dims[d]`` switches along dimension ``d``; ``terminals``
    end-points per switch; per-dimension CIN instance."""
    dims: tuple[int, ...]
    terminals: int
    instance: str = "xor"

    def __post_init__(self):
        if self.instance == "xor":
            for k in self.dims:
                if not is_power_of_two(k):
                    raise ValueError(
                        f"XOR LACIN needs power-of-two dimension sizes, got {self.dims}")

    # -- basic arithmetic ---------------------------------------------------
    @property
    def num_dims(self) -> int:
        return len(self.dims)

    @property
    def num_switches(self) -> int:
        return int(np.prod(self.dims))

    @property
    def num_endpoints(self) -> int:
        return self.num_switches * self.terminals

    @property
    def network_ports_per_switch(self) -> int:
        return sum(k - 1 for k in self.dims)

    @property
    def radix(self) -> int:
        return self.terminals + self.network_ports_per_switch

    @property
    def num_links(self) -> int:
        """Total network links: each dimension contributes
        (switches / K_d) rows * K_d(K_d-1)/2 links."""
        n = self.num_switches
        return sum((n // k) * (k * (k - 1) // 2) for k in self.dims)

    @property
    def diameter(self) -> int:
        return self.num_dims

    # -- addressing ----------------------------------------------------------
    def switch_coord(self, s: int) -> tuple[int, ...]:
        """Mixed-radix decode, dimension D-1 most significant."""
        c = []
        for k in reversed(self.dims):
            c.append(s % k)
            s //= k
        return tuple(reversed(c))

    def switch_index(self, coord: tuple[int, ...]) -> int:
        s = 0
        for c, k in zip(coord, self.dims):
            s = s * k + c
        return s

    def endpoint_address(self, e: int) -> tuple[tuple[int, ...], int]:
        """(switch coordinate vector, edge port C0)."""
        return self.switch_coord(e // self.terminals), e % self.terminals

    # -- port numbering ------------------------------------------------------
    # Global port layout on a switch: [terminals] + [dim D-1 ports] + ... +
    # [dim 0 ports]; dimension d's CIN uses K_d - 1 ports.
    def dim_port_base(self, d: int) -> int:
        return self.terminals + sum(self.dims[dd] - 1 for dd in range(d))

    def port_for(self, src: tuple[int, ...], d: int, dst_digit: int) -> int:
        """Global output port at ``src`` to move dimension ``d`` to
        ``dst_digit`` — the per-dimension LACIN routing function."""
        i = int(route(self.instance, src[d], dst_digit, self.dims[d]))
        return self.dim_port_base(d) + i

    # -- routing ---------------------------------------------------------------
    def dor_route(self, src: tuple[int, ...], dst: tuple[int, ...],
                  order: tuple[int, ...] | None = None) -> list[tuple[tuple[int, ...], int]]:
        """Dimension-order minimal route.

        Returns [(switch_coord, global output port), ...]; dimensions whose
        source/destination digits match are skipped (XOR of digits == 0 in
        the paper's formulation).  Deadlock-free with a single buffer class
        (paper §5: DOR in HyperX needs no virtual channels).
        """
        order = order if order is not None else tuple(range(self.num_dims))
        hops = []
        cur = list(src)
        for d in order:
            if cur[d] == dst[d]:
                continue  # dimension skipped
            hops.append((tuple(cur), self.port_for(tuple(cur), d, dst[d])))
            cur[d] = dst[d]
        assert tuple(cur) == tuple(dst)
        return hops

    def route_endpoint(self, a: int, b: int) -> list[tuple[tuple[int, ...], int]]:
        """End-point to end-point minimal path incl. final ejection port."""
        (asw, _), (bsw, b0) = self.endpoint_address(a), self.endpoint_address(b)
        hops = self.dor_route(asw, bsw) if asw != bsw else []
        hops.append((bsw, b0))
        return hops


# ---------------------------------------------------------------------------
# Physical deployment (paper §5 and Figure 4).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HyperXDeployment:
    """Rack/hose arithmetic for a 3-D HyperX whose Z dimension lives inside
    racks (one chassis per switch) and whose X/Y dimensions connect racks
    through super-ports and hoses."""
    config: HyperXConfig

    @property
    def chassis_per_rack(self) -> int:
        return self.config.dims[0]  # Z dimension (most-significant digit C3)

    @property
    def num_racks(self) -> int:
        return self.config.num_switches // self.chassis_per_rack

    @property
    def rack_grid(self) -> tuple[int, int]:
        return (self.config.dims[1], self.config.dims[2])  # Y x X

    # Z links live inside a rack: one LACIN of size K_z per rack.
    @property
    def z_links_per_rack(self) -> int:
        k = self.config.dims[0]
        return k * (k - 1) // 2

    @property
    def z_columns_per_rack(self) -> int:
        """LACIN port colours along the rack's vertical dimension."""
        return self.config.dims[0] - 1

    @property
    def z_wires_per_column(self) -> int:
        """Links per 1-factor: K_z / 2 (even K_z)."""
        return self.config.dims[0] // 2

    # X/Y super-ports: per rack, one super-port per port colour per dim.
    def super_ports_per_rack(self, dim: int) -> int:
        return self.config.dims[dim] - 1

    @property
    def wires_per_super_port(self) -> int:
        return self.chassis_per_rack  # one wire per chassis

    def hoses_per_line(self, dim: int) -> int:
        """Hoses (bundled cables) along one row/column of racks: the rack-
        level CIN of size K_dim has K(K-1)/2 hoses."""
        k = self.config.dims[dim]
        return k * (k - 1) // 2

    def hose_colour_classes(self, dim: int) -> tuple[int, int]:
        """(#colours, hoses per colour) along one rack line: K-1 colours of
        K/2 hoses each — the 1-factors of the rack-level LACIN."""
        k = self.config.dims[dim]
        return (k - 1, k // 2)

    def report(self) -> dict:
        c = self.config
        return {
            "dims": c.dims,
            "instance": c.instance,
            "switches": c.num_switches,
            "endpoints": c.num_endpoints,
            "radix": c.radix,
            "network_ports_per_switch": c.network_ports_per_switch,
            "total_links": c.num_links,
            "racks": self.num_racks,
            "rack_grid": self.rack_grid,
            "chassis_per_rack": self.chassis_per_rack,
            "z_links_per_rack": self.z_links_per_rack,
            "z_columns_per_rack": self.z_columns_per_rack,
            "z_wires_per_column": self.z_wires_per_column,
            "super_ports_per_rack_x": self.super_ports_per_rack(2),
            "super_ports_per_rack_y": self.super_ports_per_rack(1),
            "wires_per_super_port": self.wires_per_super_port,
            "hoses_per_rack_row": self.hoses_per_line(2),
            "hose_colours_x": self.hose_colour_classes(2),
        }


def paper_16cubed() -> HyperXDeployment:
    """The paper's flagship: 16x16x16 XOR HyperX, 16 terminals/switch."""
    return HyperXDeployment(HyperXConfig(dims=(16, 16, 16), terminals=16,
                                         instance="xor"))


def fig4_4cubed() -> HyperXDeployment:
    """Figure 4's illustrative 4x4x4 XOR HyperX."""
    return HyperXDeployment(HyperXConfig(dims=(4, 4, 4), terminals=4,
                                         instance="xor"))


def all_pairs_max_hops(cfg: HyperXConfig, sample: int | None = None,
                       seed: int = 0) -> int:
    """Max DOR hop count over (sampled) endpoint pairs — equals the number
    of differing digits, bounded by the diameter."""
    rng = np.random.default_rng(seed)
    n = cfg.num_switches
    coords = [cfg.switch_coord(s) for s in range(n)]
    if sample is None and n <= 256:
        pairs = [(a, b) for a in range(n) for b in range(n) if a != b]
    else:
        k = sample or 4096
        pairs = [tuple(rng.integers(0, n, 2)) for _ in range(k)]
        pairs = [(a, b) for a, b in pairs if a != b]
    best = 0
    for a, b in pairs:
        hops = cfg.dor_route(coords[a], coords[b])
        best = max(best, len(hops))
    return best
