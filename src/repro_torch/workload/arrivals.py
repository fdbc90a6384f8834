"""Declarative open-loop arrival processes: the :class:`ArrivalSpec`.

An ``ArrivalSpec`` names *when* serving requests arrive and *where* —
a seeded stochastic process (Poisson, bursty MMPP) or a recorded trace
— decoupled from what each request costs the fabric (packet fan-out,
destinations: :func:`repro_torch.workload.serving.serving_traffic`).  It
is a :class:`repro_torch.studies.spec._SpecBase` like
:class:`~repro_torch.faults.FailureSpec`, so it JSON-round-trips exactly
and nests inside an :class:`~repro_torch.studies.spec.ExperimentSpec`'s
traffic params, keeping arrival sweeps as declarative as every other
study axis.  A copy of the reference's ``repro.workload.arrivals``: the
same JSON, labels and sampled arrays, bit for bit.

Processes
---------
* ``"poisson"`` — independent Poisson(``rate``) arrivals per switch per
  cycle; the memoryless baseline of the serving literature.
* ``"mmpp"`` — a two-state Markov-modulated Poisson process per switch:
  a *low* state arriving at ``rate`` and a *high* (burst) state arriving
  at ``rate * burst``, with per-cycle transition probabilities ``p_on``
  (low -> high) and ``p_off`` (high -> low).  The stationary high-state
  fraction is ``p_on / (p_on + p_off)``, making the long-run mean rate
  :attr:`mean_rate` — so a Poisson and an MMPP spec with equal
  ``mean_rate`` offer the same load and differ only in burstiness.
* ``"trace"`` — explicit ``(times, sources)`` arrays, e.g. recorded by
  :meth:`repro_torch.serving.ServingEngine.arrival_trace`.  Deterministic:
  replaying a trace ignores the seed, and rate scaling is refused (a
  trace is evidence, not a distribution — resample the fitted process
  to scale).

Determinism: given the same ``(spec, n, horizon, seed)``, ``arrivals``
returns bit-identical arrays on every backend and host — the same
contract :class:`~repro_torch.faults.FailureSpec` gives failure sampling.
The spec's own ``seed`` field, when set, *pins* the stream (a study
sweep's per-point seed is ignored), mirroring ``TrafficSpec`` fixed
seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from repro_torch.studies.spec import _SpecBase

__all__ = ["ArrivalSpec", "KINDS"]

#: Arrival-process kinds, in documentation order.
KINDS = ("poisson", "mmpp", "trace")


@dataclass(frozen=True, eq=True)
class ArrivalSpec(_SpecBase):
    """When and where serving requests arrive.

    All fields are JSON-serializable; ``ArrivalSpec.from_json(
    spec.to_json()) == spec`` exactly (the ``_SpecBase`` contract).

    ``rate`` is requests per switch per cycle (the *low*-state rate for
    ``"mmpp"``); ``times``/``sources`` are the trace arrays for
    ``kind="trace"`` (ignored otherwise); ``seed=None`` defers to the
    caller's seed, an integer pins the stream.
    """
    kind: str = "poisson"
    rate: float = 0.01
    burst: float = 4.0
    p_on: float = 0.05
    p_off: float = 0.2
    times: tuple = ()
    sources: tuple = ()
    seed: int | None = None

    def __post_init__(self):
        super().__post_init__()
        if self.kind not in KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        rate = float(self.rate)
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        burst = float(self.burst)
        if burst < 1.0:
            raise ValueError(f"burst is the high-state rate multiplier and "
                             f"must be >= 1, got {burst}")
        p_on, p_off = float(self.p_on), float(self.p_off)
        if self.kind == "mmpp" and not (0.0 < p_on <= 1.0
                                        and 0.0 < p_off <= 1.0):
            raise ValueError(f"mmpp transition probabilities must lie in "
                             f"(0, 1]; got p_on={p_on}, p_off={p_off}")
        times = tuple(int(t) for t in self.times)
        sources = tuple(int(s) for s in self.sources)
        if self.kind == "trace":
            if not times:
                raise ValueError("a trace spec needs at least one arrival "
                                 "in times")
            if any(t < 0 for t in times):
                raise ValueError("trace times must be >= 0")
            if sources and len(sources) != len(times):
                raise ValueError(
                    f"trace sources must be empty (uniform-random) or match "
                    f"times: {len(sources)} != {len(times)}")
            if any(s < 0 for s in sources):
                raise ValueError("trace sources must be >= 0")
            # Canonical order: arrivals sorted by (time, source) so two
            # specs recording the same arrivals compare equal.
            if sources:
                order = sorted(range(len(times)),
                               key=lambda i: (times[i], sources[i]))
                times = tuple(times[i] for i in order)
                sources = tuple(sources[i] for i in order)
            else:
                times = tuple(sorted(times))
        object.__setattr__(self, "rate", rate)
        object.__setattr__(self, "burst", burst)
        object.__setattr__(self, "p_on", p_on)
        object.__setattr__(self, "p_off", p_off)
        object.__setattr__(self, "times", times)
        object.__setattr__(self, "sources", sources)
        object.__setattr__(
            self, "seed", int(self.seed) if self.seed is not None else None)

    @property
    def mean_rate(self) -> float:
        """Long-run arrivals per switch per cycle for the stochastic
        kinds (``"trace"`` has no intrinsic rate — it depends on the
        window and switch count it is replayed over)."""
        if self.kind == "poisson":
            return self.rate
        if self.kind == "mmpp":
            pi_hi = self.p_on / (self.p_on + self.p_off)
            return self.rate * (1.0 - pi_hi) + self.rate * self.burst * pi_hi
        raise ValueError("a trace spec has no intrinsic mean rate; divide "
                         "len(times) by the replay window x switch count")

    @property
    def label(self) -> str:
        """Compact human tag (experiment names, stores)."""
        if self.kind == "trace":
            return f"trace{len(self.times)}"
        tag = f"{self.kind}-r{self.rate:g}"
        if self.kind == "mmpp":
            tag += f"-b{self.burst:g}"
        if self.seed is not None:
            tag += f"-s{self.seed}"
        return tag

    # -- sampling -----------------------------------------------------------

    def arrivals(self, *, n: int, horizon: int, seed: int = 0,
                 scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
        """Sample the request stream: ``(src, gen)`` int64 arrays, sorted
        by ``(src, gen)``, all ``gen`` in ``[0, horizon)``.

        ``n`` is the switch count, ``horizon`` the arrival window in
        cycles, ``scale`` a rate multiplier (the study load axis; the
        ``slo_capacity`` search drives it).  ``seed`` is the stream key
        unless the spec pins its own.  Trace kinds refuse ``scale != 1``
        and replay their recorded arrivals verbatim (sources drawn
        uniformly, seeded, when the trace carries none).
        """
        if n < 1 or horizon < 0:
            raise ValueError(f"need n >= 1 and horizon >= 0; "
                             f"got n={n}, horizon={horizon}")
        if scale < 0:
            raise ValueError(f"scale must be >= 0, got {scale}")
        use_seed = self.seed if self.seed is not None else int(seed)
        rng = np.random.default_rng(use_seed)
        if self.kind == "trace":
            if scale != 1.0:
                raise ValueError(
                    f"a trace replays recorded arrivals and cannot be "
                    f"rate-scaled (scale={scale}); fit a poisson/mmpp spec "
                    f"to the trace to sweep its rate")
            gen = np.asarray(self.times, dtype=np.int64)
            keep = gen < horizon
            gen = gen[keep]
            if self.sources:
                src = np.asarray(self.sources, dtype=np.int64)[keep]
                if src.size and src.max(initial=0) >= n:
                    raise ValueError(
                        f"trace source {int(src.max())} outside [0, {n})")
            else:
                src = rng.integers(0, n, size=gen.size)
            order = np.lexsort((gen, src))
            return src[order].astype(np.int64), gen[order]
        if horizon == 0:
            empty = np.zeros(0, dtype=np.int64)
            return empty, empty.copy()
        if self.kind == "poisson":
            counts = rng.poisson(self.rate * scale, size=(n, horizon))
        else:                                   # mmpp
            # Per-switch two-state chain, started from the stationary
            # distribution so the window mean matches mean_rate without
            # a warm-up transient.
            pi_hi = self.p_on / (self.p_on + self.p_off)
            state = rng.random(n) < pi_hi       # True = high (burst) state
            rates = np.empty((n, horizon))
            flips = rng.random((n, horizon))
            for c in range(horizon):
                rates[:, c] = np.where(state, self.rate * self.burst,
                                       self.rate)
                state = np.where(state, flips[:, c] >= self.p_off,
                                 flips[:, c] < self.p_on)
            counts = rng.poisson(rates * scale)
        src = np.repeat(np.arange(n), counts.sum(axis=1))
        gen = np.repeat(np.tile(np.arange(horizon), n), counts.reshape(-1))
        return src.astype(np.int64), gen.astype(np.int64)

    @classmethod
    def coerce(cls, obj) -> "ArrivalSpec | None":
        """``None`` | ArrivalSpec | its dict form -> ArrivalSpec | None."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, Mapping):
            return cls.from_dict(obj)
        raise TypeError(f"arrival must be an ArrivalSpec (or its dict "
                        f"form), got {type(obj).__name__}")
