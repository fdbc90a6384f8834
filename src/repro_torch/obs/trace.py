"""Time-series trace containers shared by both simulation engines.

A :class:`Trace` is the sampled dynamics of one run: at every sampled
cycle (``cycle % stride == 0``, capped at ``max_samples`` rows) the
engine records four *raw channels* —

==============  ===========  ==============================================
``link_load``   ``(S, L)``   cumulative lifetime traversals per directed
                             link (``L = num_switches * num_ports``)
``queue_occ``   ``(S, N)``   instantaneous total queue occupancy per
                             switch (all ports x VCs)
``injected``    ``(S, N)``   cumulative injections per switch
``delivered``   ``(S,)``     cumulative delivered packets
==============  ===========  ==============================================

Channels are cumulative counters or instantaneous state *by design*:
that makes a stride-``k`` trace exactly the stride-1 trace downsampled
(:meth:`Trace.downsample`), and cross-engine equality a plain array
comparison (:meth:`Trace.equals`).  Per-cycle *rates* — link
utilization, delivery rate — are derived by differencing
(:meth:`Trace.link_util`).

The injection backlog is derived, not sampled: for open-loop traffic the
eligible-packet count per switch is a pure function of the generation
timestamps, and for replays of the recorded phase-completion cycles —
so both engines call the same :func:`derive_backlog` on identical
inputs rather than each re-deriving it in-loop (the compiled engine
would pay an O(packets) reduction every cycle for a value the host can
reconstruct exactly).

The numpy engine additionally records per-packet span ``events`` for K
sampled packets (see :class:`TraceConfig.packets`); the compiled engine
leaves ``events`` empty — hop-by-hop packet following is inherently a
scatter, which its hot loop forbids.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["TraceConfig", "Trace", "derive_backlog"]


@dataclass(frozen=True)
class TraceConfig:
    """What to record.  ``stride`` samples every k-th cycle;
    ``max_samples`` caps the rows (the compiled engine allocates its
    ring buffers statically, so an unbounded drain cannot grow them);
    ``packets`` asks the numpy engine to follow K sampled packets
    hop-by-hop (0 = off; ignored by the compiled engine)."""
    stride: int = 1
    max_samples: int = 4096
    packets: int = 0

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"trace stride must be >= 1, got {self.stride}")
        if self.max_samples < 1:
            raise ValueError(
                f"trace max_samples must be >= 1, got {self.max_samples}")
        if self.packets < 0:
            raise ValueError(f"trace packets must be >= 0, got {self.packets}")

    @classmethod
    def coerce(cls, value) -> "TraceConfig | None":
        """The engines' lenient ``trace=`` argument: ``None``/``False``
        -> off, ``True`` -> defaults, a mapping -> kwargs (the form a
        declarative ``ExperimentSpec.engine`` dict carries), or an
        existing config passed through."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**{k: int(v) for k, v in value.items()})
        raise TypeError(f"cannot build a TraceConfig from {value!r}")


def derive_backlog(cycles: np.ndarray, injected: np.ndarray,
                   gen: np.ndarray, blk_start: np.ndarray,
                   blk_end: np.ndarray, phase_done=None) -> np.ndarray:
    """Per-switch injection backlog at each sampled cycle: packets that
    are injection-eligible but not yet injected.

    ``gen``/``blk_start``/``blk_end`` are the engine's packet layout —
    generation timestamps sorted ascending within each switch's source
    block.  Open-loop traffic is eligible once ``gen <= cycle``; replays
    (``phase_done`` given) once their phase ordinal is below the count
    of phases completed by that cycle — exactly the engines' injection
    gates, evaluated at end-of-cycle.
    """
    cycles = np.asarray(cycles, dtype=np.int64)
    if phase_done is not None:
        pd = np.asarray(phase_done, dtype=np.int64)
        limit = ((pd[None, :] >= 0)
                 & (pd[None, :] <= cycles[:, None])).sum(axis=1)
    else:
        limit = cycles
    n = blk_start.size
    eligible = np.empty((cycles.size, n), dtype=np.int64)
    for sw in range(n):
        g = gen[blk_start[sw]:blk_end[sw]]
        eligible[:, sw] = np.searchsorted(g, limit, side="right")
    return eligible - np.asarray(injected, dtype=np.int64)


@dataclass
class Trace:
    """One run's sampled time series (see the module docstring for the
    channel semantics).  ``meta`` carries identifying context (topology
    name, switch/port counts, backend); ``events`` the numpy engine's
    per-packet span records as ``(pid, cycle, from_switch, to_switch)``
    tuples, ``to_switch == -1`` marking the ejection."""
    stride: int
    cycles: np.ndarray                  # (S,) sampled cycle indices
    link_load: np.ndarray               # (S, L) cumulative traversals
    queue_occ: np.ndarray               # (S, N) instantaneous occupancy
    injected: np.ndarray                # (S, N) cumulative injections
    delivered: np.ndarray               # (S,) cumulative deliveries
    backlog: np.ndarray                 # (S, N) eligible - injected
    meta: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    def __post_init__(self):
        self.cycles = np.asarray(self.cycles, dtype=np.int64)
        for name in ("link_load", "queue_occ", "injected", "backlog"):
            setattr(self, name,
                    np.asarray(getattr(self, name), dtype=np.int64))
        self.delivered = np.asarray(self.delivered, dtype=np.int64)

    # -- derived series ------------------------------------------------------

    @property
    def num_samples(self) -> int:
        return int(self.cycles.size)

    @property
    def in_flight(self) -> np.ndarray:
        """(S,) packets resident in fabric queues at each sample."""
        return self.queue_occ.sum(axis=1)

    def link_util(self, links=None) -> np.ndarray:
        """(S,) mean per-cycle utilization of ``links`` (an index array
        or boolean mask over the L link slots; default: every slot that
        ever carried traffic) across each inter-sample interval.  Row 0
        covers ``[0, cycles[0]]``; utilization of an idle interval is 0.
        """
        load = self.link_load
        if links is not None:
            load = load[:, np.asarray(links)]
        if load.shape[1] == 0 or self.num_samples == 0:
            return np.zeros(self.num_samples)
        if links is None:
            carried = self.link_load[-1] > 0
            if carried.any():
                load = load[:, carried]
        prev = np.concatenate(
            [np.zeros((1, load.shape[1]), np.int64), load[:-1]])
        prev_c = np.concatenate([[-1], self.cycles[:-1]])
        dt = np.maximum(self.cycles - prev_c, 1)
        return (load - prev).mean(axis=1) / dt

    def downsample(self, k: int) -> "Trace":
        """Every k-th sample — for a stride-1 trace this is exactly the
        trace a ``stride=k`` run of the same workload records (the
        invariance ``tests/test_obs.py`` pins)."""
        if k < 1:
            raise ValueError(f"downsample factor must be >= 1, got {k}")
        keep = np.flatnonzero(self.cycles % (self.stride * k) == 0)
        return Trace(
            stride=self.stride * k, cycles=self.cycles[keep],
            link_load=self.link_load[keep], queue_occ=self.queue_occ[keep],
            injected=self.injected[keep], delivered=self.delivered[keep],
            backlog=self.backlog[keep], meta=dict(self.meta),
            events=list(self.events))

    # -- comparison / serialization -----------------------------------------

    _CHANNELS = ("cycles", "link_load", "queue_occ", "injected",
                 "delivered", "backlog")

    def equals(self, other: "Trace") -> bool:
        """Exact channel-wise equality (the cross-engine agreement test
        for deterministic workloads); ``meta``/``events`` are excluded
        — they identify the recording, not the dynamics."""
        return (self.stride == other.stride
                and all(np.array_equal(getattr(self, ch), getattr(other, ch))
                        for ch in self._CHANNELS))

    def diff_summary(self, other: "Trace") -> str:
        """Where two traces first disagree — for test failure messages."""
        if self.stride != other.stride:
            return f"stride {self.stride} != {other.stride}"
        for ch in self._CHANNELS:
            a, b = getattr(self, ch), getattr(other, ch)
            if a.shape != b.shape:
                return f"{ch}: shape {a.shape} != {b.shape}"
            if not np.array_equal(a, b):
                bad = np.argwhere(a != b)
                return (f"{ch}: first mismatch at {tuple(bad[0])} "
                        f"({a[tuple(bad[0])]} != {b[tuple(bad[0])]}, "
                        f"{len(bad)} differing entries)")
        return "traces are equal"

    def to_dict(self) -> dict:
        d = {ch: getattr(self, ch).tolist() for ch in self._CHANNELS}
        d["stride"] = self.stride
        d["meta"] = dict(self.meta)
        d["events"] = [list(e) for e in self.events]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls(stride=int(d["stride"]),
                   cycles=np.asarray(d["cycles"], np.int64),
                   link_load=np.asarray(d["link_load"], np.int64),
                   queue_occ=np.asarray(d["queue_occ"], np.int64),
                   injected=np.asarray(d["injected"], np.int64),
                   delivered=np.asarray(d["delivered"], np.int64),
                   backlog=np.asarray(d["backlog"], np.int64),
                   meta=dict(d.get("meta", {})),
                   events=[tuple(e) for e in d.get("events", [])])
