"""``repro_torch.flow`` — the flow-level fair-share backend.

The third simulation fidelity tier: where the numpy oracle is exact and
the cycle engine is fast, the flow model is *scalable* — an analytical
max-min fair-share model that turns traffic patterns and collective
workloads into flow demand matrices over traced routes, solves for
per-flow rates by progressive filling, and reads saturation throughput,
bottleneck link sets, and replay completion estimates off the
allocation.  A copy of the reference's ``repro.flow``: route tracing,
demands and capacities stay host numpy, and the solver's progressive
filling runs as a float64 torch loop on ``device`` (the card unless the
caller asks for the CPU; :func:`maxmin_rates_numpy` is its oracle).

Reachable via ``simulate(backend="flow")``, ``Study(backend="flow")``
(and ``"auto"`` on fabrics of 1024 switches or more),
``Fabric.replay(backend="flow")``, and ``python -m repro_torch.studies
run --backend flow``.
"""
from .adapters import (FlowSolution, ROUTINGS, pattern_demands,
                       replay_estimate, replay_stats, saturation_load,
                       serving_stats, simulate_flow, solve_flows,
                       study_point_stats)
from .model import (ETA_INJECTION, FlowParams, FlowProblem,
                    adversarial_demands, demands_from_traffic,
                    hotspot_demands, link_capacities, permutation_demands,
                    trace_routes, trace_routes_via, uniform_demands)
from .solver import maxmin_rates, maxmin_rates_numpy, maxmin_rates_torch

__all__ = [
    "ETA_INJECTION", "ROUTINGS", "FlowParams", "FlowProblem",
    "FlowSolution",
    "trace_routes", "trace_routes_via",
    "uniform_demands", "permutation_demands", "hotspot_demands",
    "adversarial_demands", "demands_from_traffic", "link_capacities",
    "maxmin_rates", "maxmin_rates_numpy", "maxmin_rates_torch",
    "solve_flows", "pattern_demands", "simulate_flow",
    "study_point_stats", "replay_estimate", "replay_stats",
    "serving_stats",
    "saturation_load",
]
