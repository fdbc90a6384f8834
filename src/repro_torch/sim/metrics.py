"""Metrics collection: latency distributions, link loads, throughput.

A :class:`RunStats` summarizes one simulator run.  Latency is measured
from *generation* (not injection), so source-queue backlog — the signature
of saturation — shows up in the tail; accepted throughput is the delivery
rate inside the measurement window, normalized per terminal per cycle so
it is directly comparable to the offered load.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

HIST_MAX_LATENCY = 4096     # histogram clip; percentiles use exact values


@dataclass
class RunStats:
    topology: str
    policy: str
    traffic: str
    offered: float
    cycles: int
    warmup: int
    num_switches: int
    terminals: int
    packets_generated: int
    packets_delivered: int
    delivered_in_window: int
    accepted: float             # packets / terminal / cycle in the window
    latency_mean: float
    latency_p50: float
    latency_p99: float
    latency_max: int
    latency_histogram: np.ndarray = field(repr=False)
    link_loads: np.ndarray = field(repr=False)          # lifetime totals (N*P)
    link_util_max: float = 0.0
    link_util_mean: float = 0.0
    link_util_cv: float = 0.0
    in_flight_at_end: int = 0
    # -- collective-replay fields (repro_torch.sim.workloads); None elsewhere -----
    #: Per-phase durations in cycles (barrier-to-barrier).
    phase_cycles: tuple | None = None
    #: Cycle at which the workload's last packet delivered.
    completion_cycles: int | None = None
    #: The schedule algebra's contention-free lower bound
    #: (:attr:`repro_torch.sim.workloads.Workload.ideal_cycles`).
    ideal_cycles: int | None = None
    # -- serving fields (repro_torch.workload); None for non-serving traffic ------
    #: Requests whose packets were all generated inside the run.
    request_count: int | None = None
    #: Per-request latency percentiles in cycles (a request's latency is
    #: the delivery cycle of its *last* packet minus its arrival cycle,
    #: +1), over completed requests.
    request_latency_p50: float | None = None
    request_latency_p95: float | None = None
    request_latency_p99: float | None = None
    #: The SLO target (cycles) the traffic carried, if any.
    slo_target: float | None = None
    #: Fraction of requests that completed within ``slo_target`` cycles;
    #: a request that never completed counts as a miss.
    slo_attainment: float | None = None
    # -- observability (repro_torch.obs); excluded from equality: two runs with
    # identical dynamics are the same run regardless of wall clock -----------
    #: Wall-clock/compile-vs-execute record
    #: (:func:`repro_torch.obs.telemetry.timing_dict`); a batched sweep shares
    #: one dict across its grid points.
    timing: dict | None = field(default=None, compare=False)
    #: Sampled time series (:class:`repro_torch.obs.trace.Trace`) when the run
    #: was traced; ``None`` otherwise.
    trace: object | None = field(default=None, repr=False, compare=False)

    @property
    def delivery_fraction(self) -> float:
        return self.packets_delivered / max(self.packets_generated, 1)

    @property
    def saturated(self) -> bool:
        """Accepted rate visibly below offered: the sweep's knee test."""
        return self.offered > 0 and self.accepted < 0.95 * self.offered


def latency_summary(lat: np.ndarray) -> dict:
    if lat.size == 0:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0,
                "histogram": np.zeros(1, dtype=np.int64)}
    hist = np.bincount(np.minimum(lat, HIST_MAX_LATENCY))
    p50, p99 = np.percentile(lat, [50, 99])
    return {
        "mean": float(lat.mean()),
        "p50": float(p50),
        "p99": float(p99),
        "max": int(lat.max()),
        "histogram": hist,
    }


def replay_timeline(phase_done, gen) -> tuple[int, np.ndarray]:
    """The replay measurement frame for :func:`build_stats`:
    ``(completion horizon, per-packet release cycles)``.

    A replay's packets are "generated" the cycle their phase barrier
    opens (phase ``k`` releases when phase ``k-1`` completes), so
    latency = deliver − release measures in-phase queueing + flight, and
    the run's measurement horizon is the completion cycle — not the
    phase count ``gen`` (a phase *ordinal*) would suggest.
    """
    done = np.asarray(phase_done, dtype=np.int64)
    completion = int(done[-1]) if done.size else 0
    release = (np.concatenate([[0], done[:-1]]) if done.size
               else np.zeros(1, dtype=np.int64))
    gen = np.asarray(gen, dtype=np.int64)
    return max(completion, 1), (release[gen] if gen.size else gen)


def attach_replay(stats: RunStats, workload, phase_done) -> RunStats:
    """Fill the collective-replay fields from the engine's per-phase
    completion record (``phase_done[k]`` = the cycle phase ``k``'s last
    packet delivered)."""
    done = np.asarray(phase_done, dtype=np.int64)
    starts = np.concatenate([[0], done[:-1]]) if done.size else done
    stats.phase_cycles = tuple(int(d - s) for s, d in zip(starts, done))
    stats.completion_cycles = int(done[-1]) if done.size else 0
    stats.ideal_cycles = int(workload.ideal_cycles)
    return stats


def request_latency_summary(request, gen, deliver) -> dict:
    """Per-request latency facts for serving traffic.

    ``request`` groups packets into requests; a request's arrival is the
    min ``gen`` over its packets and it completes the cycle its *last*
    packet delivers.  Returns request count, completed count, and the
    (count,) arrays of per-request arrival cycles and latencies (−1 for
    a request with an undelivered packet).
    """
    request = np.asarray(request, dtype=np.int64)
    if request.size == 0:
        return {"count": 0, "completed": 0,
                "arrival": np.zeros(0, np.int64),
                "latency": np.zeros(0, np.int64)}
    # Compact ids so min/max reductions index densely.
    uniq, dense = np.unique(request, return_inverse=True)
    count = uniq.size
    arrival = np.full(count, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(arrival, dense, np.asarray(gen, dtype=np.int64))
    deliver = np.asarray(deliver, dtype=np.int64)
    last = np.full(count, -1, dtype=np.int64)
    np.maximum.at(last, dense, deliver)
    complete = np.ones(count, dtype=bool)
    # Any undelivered packet (deliver == -1) leaves its request open.
    np.logical_and.at(complete, dense, deliver >= 0)
    latency = np.where(complete, last - arrival + 1, -1)
    return {"count": count, "completed": int(complete.sum()),
            "arrival": arrival, "latency": latency}


def attach_serving(stats: RunStats, request, gen, deliver, *,
                   slo: float | None = None) -> RunStats:
    """Fill the serving fields from per-packet request ids + deliveries.

    Percentiles are over *completed* requests; SLO attainment counts an
    incomplete request (a packet still queued when the run stopped) as a
    miss, so a non-drained saturated run reports honestly low
    attainment rather than a survivor-biased tail.
    """
    rs = request_latency_summary(request, gen, deliver)
    stats.request_count = rs["count"]
    lat = rs["latency"][rs["latency"] >= 0]
    if lat.size:
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        stats.request_latency_p50 = round(float(p50), 3)
        stats.request_latency_p95 = round(float(p95), 3)
        stats.request_latency_p99 = round(float(p99), 3)
    stats.slo_target = float(slo) if slo is not None else None
    if slo is not None and rs["count"]:
        met = int((lat <= float(slo)).sum())
        stats.slo_attainment = round(met / rs["count"], 4)
    return stats


def build_stats(*, topology, policy, traffic, cycles, warmup, terminals,
                gen, deliver, link_counter, delivered_in_window,
                in_flight) -> RunStats:
    n = topology.num_switches
    meas_cycles = max(cycles - warmup, 1)
    delivered = deliver >= 0
    measured = delivered & (gen >= warmup)
    if not measured.any():
        # Deep saturation: nothing generated after warmup ever delivered;
        # fall back to every delivered packet so latency stays meaningful.
        measured = delivered
    lat = (deliver[measured] - gen[measured] + 1).astype(np.int64)
    ls = latency_summary(lat)
    util = link_counter.utilization(meas_cycles)
    accepted = delivered_in_window / (n * terminals * meas_cycles)
    return RunStats(
        topology=topology.name, policy=policy.name, traffic=traffic.name,
        offered=traffic.offered, cycles=cycles, warmup=warmup,
        num_switches=n, terminals=terminals,
        packets_generated=int(gen.size),
        packets_delivered=int(delivered.sum()),
        delivered_in_window=int(delivered_in_window),
        accepted=float(accepted),
        latency_mean=ls["mean"], latency_p50=ls["p50"], latency_p99=ls["p99"],
        latency_max=ls["max"], latency_histogram=ls["histogram"],
        link_loads=link_counter.total.copy(),
        link_util_max=util["max"], link_util_mean=util["mean"],
        link_util_cv=util["cv"],
        in_flight_at_end=int(in_flight),
    )
