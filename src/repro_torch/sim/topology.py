"""Switch-level topology adapters for the packet simulator.

A :class:`SimTopology` is the flattened, numpy-friendly view the engine
consumes: a ``(N, P)`` neighbour matrix (``-1`` = unwired port), the
far-end port index of every link (identical for isoport LACINs — the
paper's cabling discipline — and the registered ``peer_port`` rule for
anisoport instances like Swap), and a *vectorized* minimal-routing
function built from the table-free routing of :mod:`repro_torch.core.routing`.
Instance names resolve through the :mod:`repro_torch.fabric` registry, so
adapters work for any registered instance.

The adapters consume the existing construction objects unchanged:

* :func:`cin_topology`       — a single CIN from its P-matrix;
* :func:`hyperx_topology`    — a :class:`repro_torch.core.hyperx.HyperXConfig`
  (per-dimension LACINs + dimension-order routing);
* :func:`dragonfly_topology` — a :class:`repro_torch.core.dragonfly.DragonflyConfig`
  (local CIN + colour-owned global ports, minimal l-g-l routing).

:func:`routed_link_loads` walks the minimal route of every ordered
switch pair on any of these — the ground truth the closed forms in
:mod:`repro_torch.core.simulate` are cross-checked against.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.dragonfly import DragonflyConfig
from repro_torch.core.hyperx import HyperXConfig
from repro_torch.core.port_matrix import IDLE
from repro_torch.core.routing import route
from repro_torch.fabric.registry import get_instance


@dataclass
class SimTopology:
    """Flattened switch graph + vectorized minimal next-port function.

    ``minimal_port(cur, tgt)`` takes equal-length integer arrays with
    ``cur[i] != tgt[i]`` and returns the output-port index at ``cur[i]``
    on the minimal route towards ``tgt[i]``.
    """
    name: str
    num_switches: int
    num_ports: int
    neighbor: np.ndarray                  # (N, P) int64, IDLE = -1
    rev_port: np.ndarray                  # (N, P) int64, arrival port at far end
    minimal_port: Callable[[np.ndarray, np.ndarray], np.ndarray]
    diameter: int = 1
    meta: dict = field(default_factory=dict)

    @property
    def num_links(self) -> int:
        """Directed wired (switch, port) pairs / 2 = undirected links."""
        return int(np.sum(self.neighbor >= 0)) // 2

    def minimal_port_table(self) -> np.ndarray:
        """Dense ``(N, N)`` next-hop table: entry ``[cur, tgt]`` is the
        output port ``minimal_port`` picks at ``cur`` towards ``tgt``.

        The compiled engine (:mod:`repro_torch.sim.xengine`) consumes routing as
        a gather, so the table-free route is evaluated once here for every
        ordered pair and cached on the topology.  The diagonal is unused
        (a packet at its target ejects) and filled with 0.
        """
        tbl = self.__dict__.get("_minimal_port_table")
        if tbl is None:
            n = self.num_switches
            cur = np.repeat(np.arange(n), n)
            tgt = np.tile(np.arange(n), n)
            off = cur != tgt
            flat = np.zeros(n * n, dtype=np.int64)
            flat[off] = np.asarray(self.minimal_port(cur[off], tgt[off]),
                                   dtype=np.int64)
            tbl = flat.reshape(n, n)
            self.__dict__["_minimal_port_table"] = tbl
        return tbl

    def degrade(self, failures) -> "SimTopology":
        """Degraded copy of this topology under a
        :class:`repro_torch.faults.FailureSpec` (or its dict form): dead
        slots masked to ``-1``, ``minimal_port`` swapped for the fallback
        next-hop table over the surviving graph, ``diameter`` re-derived.
        A null spec (or ``None``) returns ``self`` unchanged.  See
        :func:`repro_torch.faults.degrade`."""
        from repro_torch.faults import degrade as _degrade
        return _degrade(self, failures)

    def validate(self) -> None:
        """Cheap structural sanity: links pair up (A's port i reaches B,
        and B's ``rev_port`` points back at A through the same wire)."""
        n, p = self.neighbor.shape
        s = np.repeat(np.arange(n), p)
        i = np.tile(np.arange(p), n)
        t = self.neighbor.reshape(-1)
        j = self.rev_port.reshape(-1)
        wired = t >= 0
        back = self.neighbor[t[wired], j[wired]]
        if not np.array_equal(back, s[wired]):
            raise ValueError(f"{self.name}: rev_port is not the link inverse")


# ---------------------------------------------------------------------------
# Single CIN.
# ---------------------------------------------------------------------------

def cin_topology(instance: str, n: int) -> SimTopology:
    """A CIN of ``n`` switches from its registered port-pairing rule."""
    spec = get_instance(instance)
    P = spec.matrix(n)
    ports = P.shape[1]
    # Isoport instances pair same-index ports (paper §2); anisoport ones
    # supply their peer_port rule via the registry.
    rev = spec.peer_matrix(n)

    def minimal_port(cur, tgt):
        return np.asarray(spec.route(cur, tgt, n), dtype=np.int64)

    topo = SimTopology(name=f"cin-{instance}-{n}", num_switches=n,
                       num_ports=ports, neighbor=P.astype(np.int64),
                       rev_port=rev, minimal_port=minimal_port, diameter=1,
                       meta={"instance": instance, "n": n})
    topo.validate()
    return topo


# ---------------------------------------------------------------------------
# HyperX: Cartesian product of CINs, dimension-order routing.
# ---------------------------------------------------------------------------

def hyperx_topology(cfg: HyperXConfig) -> SimTopology:
    """Network-port graph of a HyperX (terminals are modeled by the engine's
    injection/ejection bandwidth, not as graph ports)."""
    n = cfg.num_switches
    dims = cfg.dims
    coords = np.array([cfg.switch_coord(s) for s in range(n)], dtype=np.int64)
    index_of = {tuple(c): s for s, c in enumerate(coords.tolist())}

    spec = get_instance(cfg.instance)
    mats = [spec.matrix(k) for k in dims]
    peers = [spec.peer_matrix(k) for k in dims]
    cols = [m.shape[1] for m in mats]          # k-1, or k for odd-k Circle
    bases = np.concatenate([[0], np.cumsum(cols)[:-1]]).astype(np.int64)
    ports = int(sum(cols))

    neighbor = np.full((n, ports), -1, dtype=np.int64)
    rev = np.full((n, ports), -1, dtype=np.int64)
    for s in range(n):
        c = coords[s]
        for d, m in enumerate(mats):
            for i in range(cols[d]):
                digit = int(m[c[d], i])
                if digit == IDLE:
                    continue
                nc = c.copy()
                nc[d] = digit
                neighbor[s, bases[d] + i] = index_of[tuple(nc.tolist())]
                rev[s, bases[d] + i] = bases[d] + int(peers[d][c[d], i])

    def minimal_port(cur, tgt):
        cc = coords[cur]
        tc = coords[tgt]
        diff = cc != tc
        d = np.argmax(diff, axis=1)            # first differing dim = DOR order
        out = np.empty(len(cc), dtype=np.int64)
        for dd in range(len(dims)):
            m = d == dd
            if not m.any():
                continue
            out[m] = bases[dd] + np.asarray(
                route(cfg.instance, cc[m, dd], tc[m, dd], dims[dd]))
        return out

    topo = SimTopology(name=f"hyperx-{'x'.join(map(str, dims))}-{cfg.instance}",
                       num_switches=n, num_ports=ports, neighbor=neighbor,
                       rev_port=rev, minimal_port=minimal_port,
                       diameter=cfg.num_dims, meta={"config": cfg})
    topo.validate()
    return topo


# ---------------------------------------------------------------------------
# Dragonfly: local CIN per group + colour-owned global ports.
# ---------------------------------------------------------------------------

def dragonfly_topology(cfg: DragonflyConfig) -> SimTopology:
    """Switch graph of a Dragonfly; switch index = group * a + local index.

    Local ports come first (the local CIN's columns), then the ``h`` global
    ports.  Global colour ``c`` (the global CIN's port index) lives on
    switch ``c // h``, slot ``c % h`` in every group — an isoport global
    instance gives the same colour at both ends, so the far-end switch and
    slot coincide (§5's cabling discipline).
    """
    a, h, g = cfg.group_size, cfg.global_ports_per_switch, cfg.num_groups
    n = a * g
    lspec = get_instance(cfg.local_instance)
    Pl = lspec.matrix(a)
    Pl_rev = lspec.peer_matrix(a)
    Pg = get_instance(cfg.global_instance).matrix(g)
    la = Pl.shape[1]
    ports = la + h

    # Colour -> (owner switch, slot) assignment.  An odd-g construction
    # has g columns with one idle colour per group, so the g-1 *used*
    # colours are compacted around it — otherwise the top colour
    # (reachable when num_groups == a*h + 1) would land on switch a*h//h
    # == a, past the group.  The idle column is instance-specific
    # (Circle: grp; mirror: -grp mod g), so it is read off the P matrix.
    # Even/anisoport instances use colours 0..g-2 directly (identity).
    from repro_torch.core.dragonfly import _idle_columns
    idle_cols = _idle_columns(cfg.global_instance, g)

    def colour_owner(grp, colour):
        eff = colour - (colour > idle_cols[grp]) if idle_cols else colour
        return eff // h, eff % h

    def slot_colour(grp, s, j):
        """Inverse of colour_owner for (switch s, slot j) in group grp."""
        k = s * h + j
        if idle_cols:
            k = k + (k >= idle_cols[grp])
        return k

    neighbor = np.full((n, ports), -1, dtype=np.int64)
    rev = np.full((n, ports), -1, dtype=np.int64)
    for grp in range(g):
        for s in range(a):
            sw = grp * a + s
            for i in range(la):
                t = int(Pl[s, i])
                if t == IDLE:
                    continue
                neighbor[sw, i] = grp * a + t
                rev[sw, i] = int(Pl_rev[s, i])
            for slot in range(h):
                colour = slot_colour(grp, s, slot)
                if colour >= Pg.shape[1]:
                    continue                    # spare global port
                peer = int(Pg[grp, colour])
                if peer == IDLE:
                    continue
                # Far-end colour: the unique global port of ``peer`` that
                # reaches back to ``grp`` (== colour for isoport instances).
                far = int(route(cfg.global_instance, peer, grp, g))
                far_sw, far_slot = colour_owner(peer, far)
                neighbor[sw, la + slot] = peer * a + far_sw
                rev[sw, la + slot] = la + far_slot

    def minimal_port(cur, tgt):
        cur = np.asarray(cur)
        tgt = np.asarray(tgt)
        gc, sc = cur // a, cur % a
        gd, sd = tgt // a, tgt % a
        out = np.empty(cur.shape, dtype=np.int64)

        same = gc == gd
        if same.any():
            out[same] = np.asarray(
                route(cfg.local_instance, sc[same], sd[same], a))
        diff = ~same
        if diff.any():
            colour = np.asarray(
                route(cfg.global_instance, gc[diff], gd[diff], g))
            if idle_cols:
                colour = colour - (colour > np.asarray(idle_cols)[gc[diff]])
            exit_sw = colour // h
            slot = colour % h
            at_exit = sc[diff] == exit_sw
            sub = np.empty(int(diff.sum()), dtype=np.int64)
            sub[at_exit] = la + slot[at_exit]
            if (~at_exit).any():
                sub[~at_exit] = np.asarray(
                    route(cfg.local_instance, sc[diff][~at_exit],
                          exit_sw[~at_exit], a))
            out[diff] = sub
        return out

    topo = SimTopology(name=f"dragonfly-a{a}h{h}g{g}", num_switches=n,
                       num_ports=ports, neighbor=neighbor, rev_port=rev,
                       minimal_port=minimal_port, diameter=3,
                       meta={"config": cfg})
    topo.validate()
    return topo


# ---------------------------------------------------------------------------
# Ground-truth link loads by walking every minimal route.
# ---------------------------------------------------------------------------

def routed_link_loads(topo: SimTopology) -> dict[tuple[int, int], int]:
    """Directed (src_switch, dst_switch) link loads under uniform switch
    all-to-all, by following ``minimal_port`` hop by hop on the wired
    graph.  This is the routed ground truth the closed forms in
    :mod:`repro_torch.core.simulate` are checked against, link for link.
    """
    n = topo.num_switches
    loads: dict[tuple[int, int], int] = {}
    for src in range(n):
        for dst in range(n):
            if src == dst:
                continue
            cur = src
            for _ in range(topo.diameter):
                port = int(topo.minimal_port(np.array([cur]),
                                             np.array([dst]))[0])
                nxt = int(topo.neighbor[cur, port])
                assert nxt >= 0, (topo.name, cur, dst, port)
                loads[(cur, nxt)] = loads.get((cur, nxt), 0) + 1
                cur = nxt
                if cur == dst:
                    break
            assert cur == dst, (topo.name, src, dst)
    return loads
