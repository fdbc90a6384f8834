"""repro_torch.faults — degraded-fabric simulation.

Failure injection (:class:`FailureSpec`), table-based fallback routing
over the surviving graph (:func:`degrade`), and the traffic/demand
masking that keeps all three backends — the numpy
:class:`~repro_torch.sim.engine.Engine`, the torch cycle engine
(:mod:`repro_torch.sim.xengine`), and the :mod:`repro_torch.flow` model —
consistent on the same degraded fabric.  A copy of the reference's
``repro.faults`` (numpy); see ``docs/failure_model.md`` for the model.

Quick start::

    from repro_torch.fabric import make_fabric
    from repro_torch.faults import FailureSpec

    fab = make_fabric("xor", 16)
    spec = FailureSpec(link_fraction=0.05, seed=7)
    stats = fab.replay("all_to_all", failures=spec)   # degraded replay

    topo = fab.sim_topology().degrade(spec)           # or by hand
    topo.minimal_port_table()                         # fallback routes

Study sweeps use :func:`failure_grid` to expand one experiment into a
failure-rate x seed grid, or set ``failures`` directly in spec JSON
(see the bundled ``failure_sweep`` spec).
"""
from __future__ import annotations

from dataclasses import replace

from .degrade import (FabricDisconnectedError, bfs_distances,
                      build_fallback_table, degrade, filter_pairs,
                      mask_traffic, mask_workload, packet_keep,
                      residual_report)
from .spec import POLICIES, FailureSpec

__all__ = [
    "FailureSpec", "POLICIES", "FabricDisconnectedError",
    "degrade", "residual_report", "bfs_distances", "build_fallback_table",
    "packet_keep", "mask_traffic", "mask_workload", "filter_pairs",
    "failure_grid",
]


def failure_grid(exp, link_fractions, seeds=(0,), *, policy="strict",
                 switch_fractions=(0.0,)):
    """Expand one base :class:`~repro_torch.studies.spec.ExperimentSpec` into a
    failure-rate x seed grid: one experiment per (link fraction, switch
    fraction, seed), named ``<base>/<label>``.

    The zero-failure point is emitted exactly once (per-seed copies
    would be identical) with ``failures=None``, so its digest, store
    keys, and results are bit-identical to the pristine experiment's.
    """
    out = []
    for fl in link_fractions:
        for fs in switch_fractions:
            fl, fs = float(fl), float(fs)
            if fl == 0.0 and fs == 0.0:
                out.append(replace(exp, name=f"{exp.name}/f0",
                                   failures=None))
                continue
            for seed in seeds:
                spec = FailureSpec(link_fraction=fl, switch_fraction=fs,
                                   seed=int(seed), policy=policy)
                tag = spec.label if len(seeds) > 1 else \
                    spec.label.replace(f"-s{int(seed)}", "")
                out.append(replace(exp, name=f"{exp.name}/{tag}",
                                   failures=spec))
    return out
