"""Serving traffic: request streams -> timed injection schedules.

:func:`serving_traffic` turns an :class:`~repro_torch.workload.ArrivalSpec`
into engine-ready :class:`~repro_torch.sim.traffic.Traffic`: each arriving
request becomes ``packets_per_request`` packets from its serving switch
to one uniformly drawn peer (the KV/activation fan a disaggregated
serving tier pushes per request), stamped with a shared request id so
the engines report per-request latency percentiles and SLO attainment
(:func:`repro_torch.sim.metrics.attach_serving`) on top of the per-packet
statistics.

A request's latency is the delivery cycle of its *last* packet minus
its arrival cycle (+1).  Because the per-terminal source FIFOs inject
at most one packet per terminal per cycle, a request's packets serialize
through its switch's injectors exactly as a real NIC would — the service
time is simulated, not modeled.

The same request stream feeds the flow model as a demand matrix
(:func:`serving_demands`), giving the 10k-switch capacity-planning tier
the identical offered pattern at flow fidelity.

A copy of the reference's ``repro.workload.serving``: the same traffic
and demands, bit for bit, for the same arguments.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.traffic import Traffic, _random_dst_excluding_src

from .arrivals import ArrivalSpec

__all__ = ["serving_traffic", "serving_demands"]


def serving_traffic(arrival, n: int, *, cycles: int, load: float = 1.0,
                    terminals: int = 1, packets_per_request: int = 4,
                    slo: float | None = None, seed: int = 0) -> Traffic:
    """Engine-ready serving traffic for ``n`` switches over ``cycles``.

    ``load`` scales the spec's arrival rate (the study sweep axis;
    refused by trace kinds), ``packets_per_request`` is the per-request
    packet fan, ``slo`` the per-request latency target in cycles
    (carried on the traffic for the engines' attainment metric).
    ``offered`` is the *realized* packet rate of the sampled stream —
    per terminal per cycle, like every open-loop generator — so
    saturation accounting stays exact under burstiness.
    """
    spec = ArrivalSpec.coerce(arrival)
    if spec is None:
        raise ValueError("serving_traffic needs an ArrivalSpec")
    if packets_per_request < 1:
        raise ValueError(f"packets_per_request must be >= 1, "
                         f"got {packets_per_request}")
    src_req, gen_req = spec.arrivals(n=n, horizon=cycles, seed=seed,
                                     scale=load)
    rng = np.random.default_rng(
        (spec.seed if spec.seed is not None else int(seed)) + 0x5EED)
    if n > 1:
        dst_req = _random_dst_excluding_src(rng, src_req, n)
    else:
        dst_req = src_req.copy()
    p = int(packets_per_request)
    requests = src_req.size
    src = np.repeat(src_req, p)
    dst = np.repeat(dst_req, p)
    gen = np.repeat(gen_req, p)
    request = np.repeat(np.arange(requests, dtype=np.int64), p)
    offered = (src.size / (n * max(terminals, 1) * cycles)
               if cycles else 0.0)
    return Traffic(f"serving-{spec.label}", src, dst, gen,
                   offered=float(offered), horizon=max(cycles, 1),
                   terminals=terminals, request=request,
                   slo=float(slo) if slo is not None else None)


def serving_demands(traffic: Traffic, n: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The flow-model demand view of a serving stream: unique
    ``(src, dst)`` pairs with per-pair packet rates (packets per cycle
    over the traffic's horizon)."""
    if traffic.num_packets == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0)
    pair = traffic.src.astype(np.int64) * n + traffic.dst.astype(np.int64)
    uniq, counts = np.unique(pair, return_counts=True)
    rate = counts / max(traffic.horizon, 1)
    return (uniq // n).astype(np.int64), (uniq % n).astype(np.int64), rate
