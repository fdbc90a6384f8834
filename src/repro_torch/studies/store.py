"""Unified result records + the append-only JSONL store.

Every grid point a :class:`~repro_torch.studies.runner.Study` executes becomes
one :class:`Result` — the serializable summary of a simulator
:class:`~repro_torch.sim.metrics.RunStats` plus its grid identity (experiment
name, offered load, sweep seed, backend).  A :class:`JsonlStore` streams
Results one JSON line at a time, so an interrupted study leaves a valid
prefix behind and a re-run resumes by skipping the keys already present
(:meth:`JsonlStore.load` tolerates a torn trailing line).

Records are the reference's (``repro.studies.store``): a store written by
either package loads in the other with every field kept, fields one
version does not know included (:attr:`Result.extra`).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Iterable, Mapping

from repro_torch.obs.telemetry import provenance
from repro_torch.sim.metrics import RunStats

__all__ = ["Result", "JsonlStore"]


@dataclass
class Result:
    """One executed grid point: identity + the RunStats summary."""
    key: str
    experiment: str
    load: float
    seed: int
    backend: str
    # -- RunStats summary (same fields as repro_torch.sim.report.to_record) --
    topology: str
    policy: str
    traffic: str
    offered: float
    accepted: float
    cycles: int
    warmup: int
    num_switches: int
    terminals: int
    packets_generated: int
    packets_delivered: int
    latency_mean: float
    latency_p50: float
    latency_p99: float
    latency_max: int
    link_util_max: float
    link_util_mean: float
    link_util_cv: float
    saturated: bool
    #: Packets still in fabric queues when the run stopped (0 on a
    #: drained run); defaulted so records from older stores load.
    in_flight_at_end: int = 0
    #: Hash of the experiment spec that produced this record (see
    #: :meth:`repro_torch.studies.spec.ExperimentSpec.digest`); ``""`` for
    #: inline specs and records from older stores.
    spec_digest: str = ""
    #: Simulation fidelity tier: ``"cycle"`` for the packet-level
    #: engines (torch/numpy, and the reference's jax), ``"flow"`` for the
    #: analytical fair-share model (:mod:`repro_torch.flow`, a copy of
    #: ``repro.flow``).  Stores may mix tiers; analyses that
    #: compare knees must filter on this marker (see
    #: :meth:`repro_torch.studies.runner.StudyResult.saturation_points`).
    #: Defaulted so records from older stores load as cycle-fidelity.
    fidelity: str = "cycle"
    # -- collective-replay summary (None for open-loop experiments) ---------
    #: Cycle the workload's last packet delivered.
    completion_cycles: int | None = None
    #: Contention-free lower bound (num_steps x message_size).
    ideal_cycles: int | None = None
    #: Per-phase durations in cycles.
    phase_cycles: list | None = None
    # -- serving summary (None for non-serving experiments) ------------------
    #: Distinct request ids in the serving stream.
    request_count: int | None = None
    #: Per-request latency percentiles, cycles (last packet delivered
    #: minus arrival, +1); computed over completed requests.
    request_latency_p50: float | None = None
    request_latency_p95: float | None = None
    request_latency_p99: float | None = None
    #: The per-request latency SLO carried by the traffic, and the
    #: fraction of requests that completed within it (requests that
    #: never completed count as misses).
    slo_target: float | None = None
    slo_attainment: float | None = None
    #: Environment + timing block
    #: (:func:`repro_torch.obs.telemetry.provenance`):
    #: host, library versions, and the point's compile-vs-execute split.
    #: ``None`` for records from older stores.
    provenance: dict | None = None
    #: Fields a *newer* version of this class wrote that this one does
    #: not know.  Carried verbatim so loading and re-appending a store
    #: never silently drops data, and ``show`` can still print them.
    extra: dict = field(default_factory=dict)
    #: The full in-memory stats of a freshly executed point (histograms,
    #: raw link loads).  ``None`` for points restored from a store.
    stats: RunStats | None = field(default=None, compare=False, repr=False)

    @classmethod
    def from_stats(cls, stats: RunStats, *, key: str, experiment: str,
                   load: float, seed: int, backend: str,
                   spec_digest: str = "", fidelity: str = "cycle"
                   ) -> "Result":
        return cls(
            key=key, experiment=experiment, load=float(load), seed=int(seed),
            backend=backend,
            topology=stats.topology, policy=stats.policy,
            traffic=stats.traffic, offered=float(stats.offered),
            accepted=round(float(stats.accepted), 6),
            cycles=int(stats.cycles), warmup=int(stats.warmup),
            num_switches=int(stats.num_switches),
            terminals=int(stats.terminals),
            packets_generated=int(stats.packets_generated),
            packets_delivered=int(stats.packets_delivered),
            latency_mean=round(float(stats.latency_mean), 3),
            latency_p50=float(stats.latency_p50),
            latency_p99=float(stats.latency_p99),
            latency_max=int(stats.latency_max),
            link_util_max=round(float(stats.link_util_max), 4),
            link_util_mean=round(float(stats.link_util_mean), 4),
            link_util_cv=round(float(stats.link_util_cv), 4),
            saturated=bool(stats.saturated),
            in_flight_at_end=int(stats.in_flight_at_end),
            spec_digest=spec_digest, fidelity=fidelity,
            completion_cycles=stats.completion_cycles,
            ideal_cycles=stats.ideal_cycles,
            phase_cycles=(list(stats.phase_cycles)
                          if stats.phase_cycles is not None else None),
            request_count=stats.request_count,
            request_latency_p50=stats.request_latency_p50,
            request_latency_p95=stats.request_latency_p95,
            request_latency_p99=stats.request_latency_p99,
            slo_target=stats.slo_target,
            slo_attainment=stats.slo_attainment,
            provenance=provenance(stats.timing, backend=backend,
                                  spec_digest=spec_digest),
            stats=stats)

    def record(self) -> dict:
        """The JSON-object form (everything except the in-memory stats).

        Unknown fields restored into ``extra`` are merged back at the
        top level, so load -> append round-trips a newer store's records
        byte-compatibly."""
        out = {f.name: getattr(self, f.name) for f in fields(self)
               if f.name not in ("stats", "extra")}
        out.update(self.extra)
        return out

    def to_line(self) -> str:
        return json.dumps(self.record(), sort_keys=True)

    @classmethod
    def from_record(cls, d: Mapping) -> "Result":
        want = {f.name for f in fields(cls)} - {"stats", "extra"}
        extra = {k: v for k, v in d.items() if k not in want}
        return cls(**{k: v for k, v in d.items() if k in want}, extra=extra)


class JsonlStore:
    """Append-only JSONL persistence for :class:`Result` records.

    ``flush_interval`` amortizes durability for large sweeps: records
    are always *written* (and flushed to the OS) per :meth:`append`
    call, but the store only ``fsync``\\ s once every ``flush_interval``
    appended records.  The default of 1 keeps the historical
    every-record durability; a crash between fsyncs can cost at most
    the last ``flush_interval - 1`` records plus a torn tail — which
    :meth:`load` skips and :meth:`append` repairs in place, so a
    resumed study re-runs exactly the lost points.
    """

    def __init__(self, path: str | os.PathLike, *, flush_interval: int = 1):
        self.path = os.fspath(path)
        if int(flush_interval) < 1:
            raise ValueError(
                f"flush_interval must be >= 1, got {flush_interval!r}")
        self.flush_interval = int(flush_interval)
        self._unsynced = 0

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def clear(self) -> None:
        """Drop every stored record (a ``resume=False`` run starts clean —
        appending duplicates would shadow older records on load)."""
        if self.exists():
            os.remove(self.path)

    def load(self) -> dict[str, Result]:
        """Stored results keyed by grid-point key.

        A torn trailing line (the study was killed mid-write) is skipped;
        a corrupt line anywhere else raises, since silently dropping it
        would silently re-run (and duplicate) its grid point.
        """
        out: dict[str, Result] = {}
        if not self.exists():
            return out
        with open(self.path) as f:
            text = f.read()
        lines = text.split("\n")
        # A torn tail can only be the final fragment of a file that was
        # killed mid-write, i.e. one missing its trailing newline; a
        # newline-terminated corrupt record is a real error.
        torn = len(lines) - 1 if text and not text.endswith("\n") else None
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = Result.from_record(json.loads(line))
            except (json.JSONDecodeError, TypeError) as e:
                if i == torn:
                    break
                raise ValueError(
                    f"{self.path}:{i + 1}: corrupt result line ({e}); "
                    f"remove or repair the store to resume") from e
            out[rec.key] = rec
        return out

    def append(self, results: Iterable[Result] | Result) -> None:
        """Append records and flush; fsync per ``flush_interval`` records
        (every append with the default of 1 — each line durable on its
        own)."""
        if isinstance(results, Result):
            results = [results]
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        # An unterminated tail (killed mid-write) must not swallow the
        # next record.  Mirror load()'s tolerance exactly: a tail that
        # parses as a complete record was *restored*, so terminate it in
        # place; an unparseable fragment was ignored, so truncate it.
        if self.exists() and os.path.getsize(self.path) > 0:
            with open(self.path, "rb+") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.seek(0)
                    data = f.read()
                    keep = data.rfind(b"\n") + 1
                    try:
                        Result.from_record(json.loads(data[keep:]))
                    except (json.JSONDecodeError, TypeError,
                            UnicodeDecodeError):
                        f.truncate(keep)
                    else:
                        f.write(b"\n")
        with open(self.path, "a") as f:
            for r in results:
                f.write(r.to_line() + "\n")
                self._unsynced += 1
            f.flush()
            if self._unsynced >= self.flush_interval:
                os.fsync(f.fileno())
                self._unsynced = 0

    def sync(self) -> None:
        """Force an fsync of everything appended so far (a no-op when
        nothing is pending) — call at study end when running with a
        ``flush_interval`` above 1."""
        if self._unsynced and self.exists():
            with open(self.path, "rb") as f:
                os.fsync(f.fileno())
        self._unsynced = 0
