"""Synthetic traffic for the packet simulator.

Open-loop generators produce a :class:`Traffic` — flat (src, dst,
generation-cycle) arrays — for a given *offered load*, expressed in
packets per terminal per cycle (each switch has ``terminals`` injectors
of unit bandwidth, so a switch's aggregate injection demand is
``terminals * offered``).

Patterns (the methodology of the Dragonfly/HyperX evaluation literature):

* :func:`uniform`      — independent uniform-random destinations;
* :func:`permutation`  — fixed one-to-one partner map;
* :func:`hotspot`      — fraction ``hot_fraction`` of each switch's packets
  go to its *hot partner* (distinct per source by default, concentrating
  load on N dedicated links — the pattern minimal CIN routing is worst at
  — or a single shared destination via ``hot_dst``), rest uniform;
* :func:`adversarial_same_group` — every switch in Dragonfly group ``g``
  targets group ``g+1``, funnelling all traffic through the single
  inter-group link (the classic Valiant motivator).

One-shot helpers produce closed workloads for validation against the
closed-form flow counts in :mod:`repro_torch.core.simulate`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.dragonfly import DragonflyConfig


@dataclass
class Traffic:
    """Flat packet descriptors; ``offered == 0`` marks a one-shot workload.

    ``terminals`` records the injector count the generator scaled its
    arrival rate by (``offered * terminals`` packets per switch per
    cycle); the engines default their own ``terminals`` to it and raise
    on an explicit mismatch, so the two can never silently disagree.
    ``None`` (one-shot workloads without an explicit ``terminals=``)
    leaves the engine default of 1.

    ``workload`` marks a phase-structured collective replay
    (:class:`repro_torch.sim.workloads.Workload`): ``gen`` then holds each
    packet's *phase ordinal* — the barrier it waits behind — rather
    than a generation cycle, and the engines gate injection on phase
    completion instead of simulated time.

    ``request`` marks *serving* traffic (:mod:`repro_torch.workload`): a
    per-packet request id grouping the packets of one inference request.
    The engines then report per-request latency percentiles and — when
    ``slo`` names a target in cycles — SLO attainment, on top of the
    usual per-packet statistics.  A request completes when its last
    packet delivers; its latency is measured from its arrival cycle.
    """
    name: str
    src: np.ndarray
    dst: np.ndarray
    gen: np.ndarray
    offered: float = 0.0        # packets / terminal / cycle
    horizon: int = 0            # generation window in cycles
    terminals: int | None = None  # injectors/switch the rate was scaled by
    workload: object | None = None  # repro_torch.sim.workloads.Workload for replays
    request: np.ndarray | None = None  # per-packet request id (serving)
    slo: float | None = None    # request-latency SLO target in cycles

    @property
    def num_packets(self) -> int:
        return self.src.size


def resolve_terminals(traffic: Traffic, terminals: int | None) -> int:
    """The engine-side injector count for ``traffic``.

    ``terminals=None`` defaults to what the traffic was generated with
    (1 when the traffic does not record it); an explicit value must
    agree with the traffic object's record.
    """
    if terminals is None:
        return traffic.terminals if traffic.terminals is not None else 1
    if traffic.terminals is not None and terminals != traffic.terminals:
        raise ValueError(
            f"terminals={terminals} disagrees with the {traffic.name!r} "
            f"traffic object, which was generated for "
            f"terminals={traffic.terminals}; drop the explicit kwarg "
            f"(engines default to the traffic's value) or regenerate "
            f"the traffic")
    return terminals


def _random_dst_excluding_src(rng, src: np.ndarray, n: int) -> np.ndarray:
    """Uniform destination != source, via the shift-remap trick."""
    d = rng.integers(0, n - 1, size=src.size)
    return np.where(d >= src, d + 1, d)


def _poisson_arrivals(rng, n: int, rate: float, cycles: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(src, gen) for Poisson(rate) arrivals per switch per cycle."""
    counts = rng.poisson(rate, size=(n, cycles))
    src = np.repeat(np.arange(n), counts.sum(axis=1))
    gen = np.repeat(np.tile(np.arange(cycles), n), counts.reshape(-1))
    return src.astype(np.int64), gen.astype(np.int64)


def uniform(n: int, *, offered: float, cycles: int, terminals: int = 1,
            seed: int = 0) -> Traffic:
    rng = np.random.default_rng(seed)
    src, gen = _poisson_arrivals(rng, n, offered * terminals, cycles)
    dst = _random_dst_excluding_src(rng, src, n)
    return Traffic("uniform", src, dst, gen, offered=offered,
                   horizon=cycles, terminals=terminals)


def permutation(n: int, *, offered: float, cycles: int, terminals: int = 1,
                perm: np.ndarray | None = None, seed: int = 0) -> Traffic:
    rng = np.random.default_rng(seed)
    if perm is None:
        perm = (np.arange(n) + n // 2) % n if n > 1 else np.arange(n)
    perm = np.asarray(perm)
    if (perm == np.arange(n)).any():
        raise ValueError("permutation traffic needs a fixed-point-free map")
    src, gen = _poisson_arrivals(rng, n, offered * terminals, cycles)
    return Traffic("permutation", src, perm[src], gen, offered=offered,
                   horizon=cycles, terminals=terminals)


def hotspot(n: int, *, offered: float, cycles: int, terminals: int = 1,
            hot_fraction: float = 0.8, hot_dst: int | None = None,
            partner_shift: int | None = None, seed: int = 0) -> Traffic:
    """Hot traffic rides N dedicated (src, partner) pairs by default
    (``partner_shift``), or converges on one destination via ``hot_dst``."""
    rng = np.random.default_rng(seed)
    src, gen = _poisson_arrivals(rng, n, offered * terminals, cycles)
    uniform_dst = _random_dst_excluding_src(rng, src, n)
    if hot_dst is not None:
        hot = np.full(src.size, hot_dst, dtype=np.int64)
    else:
        shift = partner_shift if partner_shift is not None else max(n // 2, 1)
        hot = (src + shift) % n
    take_hot = (rng.random(src.size) < hot_fraction) & (hot != src)
    dst = np.where(take_hot, hot, uniform_dst)
    return Traffic("hotspot", src, dst, gen, offered=offered,
                   horizon=cycles, terminals=terminals)


def adversarial_same_group(cfg: DragonflyConfig, *, offered: float,
                           cycles: int, terminals: int = 1, seed: int = 0
                           ) -> Traffic:
    """Dragonfly adversary: group ``g`` sends only to group ``g+1 mod G``."""
    a, g = cfg.group_size, cfg.num_groups
    rng = np.random.default_rng(seed)
    src, gen = _poisson_arrivals(rng, a * g, offered * terminals, cycles)
    peer_group = (src // a + 1) % g
    dst = peer_group * a + rng.integers(0, a, size=src.size)
    return Traffic("adversarial-same-group", src, dst, gen, offered=offered,
                   horizon=cycles, terminals=terminals)


# ---------------------------------------------------------------------------
# One-shot (closed) workloads for validation.
# ---------------------------------------------------------------------------

def one_shot_all_to_all(n: int, *, terminals: int | None = None) -> Traffic:
    """One packet per ordered switch pair, all generated at cycle 0 — the
    workload whose link loads :func:`repro_torch.core.simulate.cin_link_loads`
    counts in closed form.

    ``terminals`` is recorded on the traffic object exactly like the
    open-loop generators record theirs (:func:`resolve_terminals`): the
    engines then default to it and raise on an explicit mismatch.
    ``None`` keeps the legacy behaviour (engine default of 1, any
    explicit value accepted).
    """
    a = np.repeat(np.arange(n), n)
    b = np.tile(np.arange(n), n)
    keep = a != b
    return Traffic("one-shot-a2a", a[keep].astype(np.int64),
                   b[keep].astype(np.int64),
                   np.zeros(int(keep.sum()), dtype=np.int64), horizon=1,
                   terminals=terminals)


def one_shot_permutation(partners: np.ndarray, *,
                         terminals: int | None = None) -> Traffic:
    """One packet per switch to ``partners[s]`` (self/negative = idle) — a
    single step of a 1-factor schedule.  ``terminals`` is recorded the
    same way as :func:`one_shot_all_to_all`'s."""
    partners = np.asarray(partners)
    s = np.arange(partners.size)
    keep = (partners >= 0) & (partners != s)
    return Traffic("one-shot-perm", s[keep].astype(np.int64),
                   partners[keep].astype(np.int64),
                   np.zeros(int(keep.sum()), dtype=np.int64), horizon=1,
                   terminals=terminals)
