"""Offered-load sweeps, saturation detection, and result serialization.

The central experiment shape of the interconnect literature: sweep offered
load, record accepted throughput + latency per point, find the knee.

:func:`saturation_sweep` and :func:`compare_policies` are **deprecated
shims** over :mod:`repro_torch.studies` — the declarative experiment API that
replaced the repo's divergent sweep entry points.  They keep their exact
legacy behaviour (the specs they build resolve to the same engine calls)
but warn with :class:`repro_torch.fabric.LacinDeprecationWarning` for one
release; see README's migration table.  They run the torch cycle engine
on the card unless asked otherwise (``backend="numpy"``, or
``device="cpu"``), and raise where CUDA is absent.
"""
from __future__ import annotations

import json
import warnings
from typing import Callable, Sequence


from repro_torch._compat import LacinDeprecationWarning

from .metrics import RunStats
from .policies import RoutingPolicy
from .topology import SimTopology
from .traffic import Traffic


def _sweep_spec(topo: SimTopology, policy, traffic_factory, loads, seeds, *,
                terminals, cycles, warmup, sim_kw):
    """The :class:`repro_torch.studies.ExperimentSpec` a legacy sweep call
    describes (inline traffic/policy carriers, so any callable works)."""
    from repro_torch.studies import (ExperimentSpec, FabricSpec, RoutingSpec,
                               SweepSpec, TrafficSpec)
    return ExperimentSpec(
        fabric=FabricSpec.from_topology(topo),
        traffic=TrafficSpec.custom(traffic_factory),
        routing=RoutingSpec.custom(policy),
        sweep=SweepSpec(loads=tuple(loads), seeds=tuple(seeds),
                        cycles=cycles, warmup=warmup),
        terminals=terminals, engine=dict(sim_kw))


def saturation_sweep(topo: SimTopology,
                     policy_factory: Callable[[], RoutingPolicy],
                     traffic_factory: Callable[[float], Traffic],
                     loads: Sequence[float], *, terminals: int | None = None,
                     cycles: int | None = None, warmup: int | None = None,
                     seed: int = 0, backend: str = "torch",
                     device="cuda", **sim_kw) -> list[RunStats]:
    """Deprecated shim: one run per offered load, through a Study.

    Build a :class:`repro_torch.studies.ExperimentSpec` and run it with
    :class:`repro_torch.studies.Study` instead — that adds multi-seed grids,
    JSONL persistence, resume, and spec files.
    """
    warnings.warn(
        "repro_torch.sim.report.saturation_sweep is deprecated; describe the "
        "sweep as a repro_torch.studies.ExperimentSpec and run it with "
        "repro_torch.studies.Study (see README 'Running studies')",
        LacinDeprecationWarning, stacklevel=2)
    from repro_torch.studies import Study
    spec = _sweep_spec(topo, policy_factory, traffic_factory, loads, (seed,),
                       terminals=terminals, cycles=cycles, warmup=warmup,
                       sim_kw=sim_kw)
    out = Study(spec, backend=backend, device=device).run()
    return [row[0].stats for row in out.grid()]


def saturation_point(stats: Sequence[RunStats], *, threshold: float = 0.95
                     ) -> float | None:
    """Smallest offered load whose accepted throughput falls below
    ``threshold * offered`` — ``None`` if the sweep never saturates.

    ``threshold`` is the accepted/offered fraction below which a point
    counts as saturated: 0.95 (the interconnect literature's knee
    convention) tolerates up to 5% shortfall as sampling noise on
    uncongested points while flagging the load where queueing starts
    rejecting offered traffic.  Raise it toward 1.0 for long-horizon
    runs with tight confidence intervals; lower it to ignore mild
    congestion.  Points are scanned in increasing offered-load order
    regardless of input order.
    """
    for s in sorted(stats, key=lambda s: s.offered):
        if s.offered > 0 and s.accepted < threshold * s.offered:
            return s.offered
    return None


def to_record(stats: RunStats) -> dict:
    """JSON-serializable summary (histograms/raw loads dropped).

    Collective-replay runs additionally carry ``completion_cycles`` /
    ``ideal_cycles`` / ``phase_cycles`` — the numbers a replay exists to
    measure — and every record keeps ``in_flight_at_end`` (0 on a
    drained run; anything else means undelivered residue).  When the
    run was timed (``stats.timing``) the record includes it verbatim.
    """
    rec = {
        "topology": stats.topology,
        "policy": stats.policy,
        "traffic": stats.traffic,
        "offered": stats.offered,
        "accepted": round(stats.accepted, 6),
        "cycles": stats.cycles,
        "warmup": stats.warmup,
        "num_switches": stats.num_switches,
        "terminals": stats.terminals,
        "packets_generated": stats.packets_generated,
        "packets_delivered": stats.packets_delivered,
        "latency_mean": round(stats.latency_mean, 3),
        "latency_p50": stats.latency_p50,
        "latency_p99": stats.latency_p99,
        "latency_max": stats.latency_max,
        "link_util_max": round(stats.link_util_max, 4),
        "link_util_mean": round(stats.link_util_mean, 4),
        "link_util_cv": round(stats.link_util_cv, 4),
        "in_flight_at_end": stats.in_flight_at_end,
        "saturated": stats.saturated,
    }
    if stats.completion_cycles is not None:
        rec["completion_cycles"] = stats.completion_cycles
    if stats.ideal_cycles is not None:
        rec["ideal_cycles"] = stats.ideal_cycles
    if stats.phase_cycles is not None:
        rec["phase_cycles"] = [int(x) for x in stats.phase_cycles]
    if stats.request_count is not None:
        rec["request_count"] = stats.request_count
        for f in ("request_latency_p50", "request_latency_p95",
                  "request_latency_p99", "slo_target", "slo_attainment"):
            v = getattr(stats, f)
            if v is not None:
                rec[f] = v
    if stats.timing is not None:
        rec["timing"] = dict(stats.timing)
    return rec


def save_json(stats: Sequence[RunStats], path: str, *, extra: dict | None = None
              ) -> None:
    payload = {"records": [to_record(s) for s in stats]}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def format_table(stats: Sequence[RunStats]) -> str:
    """Fixed-width text table of a sweep (for examples / benchmarks)."""
    hdr = (f"{'policy':<10} {'traffic':<14} {'offered':>8} {'accepted':>9} "
           f"{'lat_mean':>9} {'lat_p99':>8} {'max_util':>9} {'sat':>4}")
    lines = [hdr, "-" * len(hdr)]
    for s in stats:
        lines.append(
            f"{s.policy:<10} {s.traffic:<14} {s.offered:>8.3f} "
            f"{s.accepted:>9.3f} {s.latency_mean:>9.1f} {s.latency_p99:>8.0f} "
            f"{s.link_util_max:>9.3f} {'Y' if s.saturated else '-':>4}")
    return "\n".join(lines)


def compare_policies(topo: SimTopology, policies: Sequence[str],
                     traffic_factory: Callable[[float], Traffic],
                     loads: Sequence[float], *, terminals: int | None = None,
                     cycles: int | None = None, warmup: int | None = None,
                     seed: int = 0, backend: str = "torch",
                     device="cuda", **sim_kw) -> dict[str, list[RunStats]]:
    """Deprecated shim: several named policies as one multi-experiment
    :class:`repro_torch.studies.Study` over the same traffic factory."""
    warnings.warn(
        "repro_torch.sim.report.compare_policies is deprecated; build one "
        "repro_torch.studies.ExperimentSpec per policy and run them as a single "
        "repro_torch.studies.Study (see README 'Running studies')",
        LacinDeprecationWarning, stacklevel=2)
    from repro_torch.studies import Study
    specs = [_sweep_spec(topo, name, traffic_factory, loads, (seed,),
                         terminals=terminals, cycles=cycles, warmup=warmup,
                         sim_kw=sim_kw)
             for name in policies]
    out = Study(specs, backend=backend, device=device).run()
    return {name: [row[0].stats for row in out.grid(spec.name)]
            for name, spec in zip(policies, specs)}
