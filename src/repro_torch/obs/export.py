"""One-call trace export: a traced run -> Perfetto-loadable events.

:func:`replay_trace_events` composes the :mod:`.spans` builders into the
full picture a replay opens with in ``ui.perfetto.dev``:

* one span per phase on the "replay" lane (barrier-to-barrier);
* one thread lane per switch carrying the sampled packets' hop spans
  (numpy-engine traces only — the torch cycle engine records no spans);
* counter tracks for the derived time series: mean link utilization
  (split by link class when the topology distinguishes local vs global
  wiring — the Dragonfly serialization plateau is the global-class
  track pinned at 1.0 while the replay runs ~4.4x past its bound),
  in-flight packets, and total injection backlog.

:func:`link_classes` is the split: it classifies each directed link slot
of a topology by *what it connects* — intra-group vs inter-group for
hierarchical fabrics — using only the construction metadata topologies
already carry (``topo.meta``), so no simulator state is needed.
"""
from __future__ import annotations

import numpy as np

from .spans import (counter_events, packet_events, phase_events,
                    validate_trace_events)

__all__ = ["link_classes", "replay_trace_events"]


def link_classes(topo) -> dict[str, np.ndarray]:
    """Boolean masks over the ``N * num_ports`` directed link slots,
    keyed by class name.

    Every wired slot is ``"local"`` unless the topology's construction
    metadata records a Dragonfly config, in which case links whose
    endpoints sit in different groups are ``"global"`` — the scarce
    wires whose serialization the replay measures.  Unwired slots (port
    not connected) are in neither class.

    On a degraded topology (built by :func:`repro_torch.faults.degrade`) a
    third ``"rerouted"`` class carries the surviving links the fallback
    table press-ganged onto paths their pristine routes never used —
    the detour wires whose extra load explains a degraded replay's
    stretch.  The classes stay disjoint: a rerouted slot is subtracted
    from ``local``/``global``.
    """
    n, p = topo.num_switches, topo.num_ports
    from repro_torch.sim.link import LinkTable
    nbr = np.asarray(LinkTable.for_topology(topo, 1).neighbor_flat,
                     dtype=np.int64)
    wired = nbr >= 0
    switch_of = np.arange(n * p) // p
    meta = getattr(topo, "meta", {}) or {}
    faults = meta.get("faults")
    rerouted = (wired & np.asarray(faults["rerouted"], dtype=bool)
                if faults is not None else None)
    cfg = meta.get("config")
    group_size = getattr(cfg, "group_size", None)
    if group_size:
        crosses = wired & (switch_of // group_size
                           != np.maximum(nbr, 0) // group_size)
        out = {"local": wired & ~crosses, "global": crosses}
    else:
        out = {"local": wired}
    if rerouted is not None:
        out = {cls: mask & ~rerouted for cls, mask in out.items()}
        out["rerouted"] = rerouted
    return out


def replay_trace_events(stats, *, topo=None, validate: bool = True
                        ) -> list[dict]:
    """The Chrome trace-event list of one traced run (see module
    docstring).  ``stats`` is the run's
    :class:`~repro_torch.sim.metrics.RunStats`; its ``.trace`` must be set
    (run with ``trace=``).  ``topo`` enables the per-class link
    utilization split; without it one aggregate track is emitted.
    """
    trace = getattr(stats, "trace", None)
    if trace is None:
        raise ValueError(
            "stats carries no trace — run the simulation with trace= "
            "(e.g. trace=repro_torch.obs.TraceConfig()) before exporting")
    events = phase_events(stats)
    events += packet_events(trace)
    if topo is not None:
        for cls, mask in link_classes(topo).items():
            if mask.any():
                events += counter_events(
                    f"link_util/{cls}", trace.cycles,
                    trace.link_util(mask))
    else:
        events += counter_events("link_util/mean", trace.cycles,
                                 trace.link_util())
    events += counter_events("in_flight", trace.cycles, trace.in_flight)
    events += counter_events("inj_backlog", trace.cycles,
                             trace.backlog.sum(axis=1))
    return validate_trace_events(events) if validate else events
