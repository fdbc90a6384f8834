"""``repro_torch.studies`` — the declarative experiment surface.

One API describes and runs every simulation experiment: a serializable
:class:`ExperimentSpec` (fabric x traffic x routing x sweep grid)
executed by a :class:`Study`, which runs each grid as one batched sweep
of the torch cycle engine (:mod:`repro_torch.sim.xengine`) on the card,
streams unified :class:`Result` records to a JSONL store, and resumes
interrupted grids by skipping the keys already persisted.  Specs, keys,
digests and records are the reference's (``repro.studies``), so a store
written by either package resumes in the other.

Quickstart::

    from repro_torch import studies

    spec = studies.ExperimentSpec(
        fabric=studies.FabricSpec("cin", {"instance": "xor", "n": 16}),
        traffic=studies.TrafficSpec("uniform"),
        routing=studies.RoutingSpec("minimal"),
        sweep=studies.SweepSpec(loads=(0.3, 0.6, 0.9), seeds=(0, 1),
                                cycles=1000),
        terminals=8)
    out = studies.Study(spec, store="sweep.jsonl").run()   # device="cuda"
    print(out.table())
    print(out.saturation_points())

The same experiment as a file::

    python -m repro_torch.studies run sweep_spec.json

Bundled specs under ``repro_torch/studies/specs/`` (copies of the
reference's) reproduce the paper's CIN-16 / HyperX-256 / Dragonfly-72
sweeps, the ``collective_replay`` schedule-vs-bound comparison, the
``failure_sweep`` survivability study, the ``flow_scale_smoke`` flow-tier
grid and the ``serving_slo`` request-latency study
(:meth:`Study.slo_capacity` bisects its load axis); ``python -m
repro_torch.studies specs`` lists all nine, and every one runs.  The
legacy entry points
(``repro_torch.sim.report.saturation_sweep`` / ``compare_policies`` /
``Fabric.sim_sweep``) are thin deprecated shims over this package.
"""
from __future__ import annotations

import os

from .spec import (ExperimentSpec, FabricSpec, RoutingSpec, SweepSpec,
                   TrafficSpec, dump_specs, load_specs)
from .store import JsonlStore, Result
from .runner import BACKENDS, FLOW_AUTO_SWITCHES, Study, StudyResult

__all__ = [
    "ExperimentSpec", "FabricSpec", "TrafficSpec", "RoutingSpec",
    "SweepSpec", "load_specs", "dump_specs",
    "Result", "JsonlStore", "Study", "StudyResult",
    "BACKENDS", "FLOW_AUTO_SWITCHES",
    "bundled_specs", "bundled_spec_path", "resolve_spec_source",
]

_SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")


def bundled_specs() -> dict[str, str]:
    """Name -> path of the spec files shipped inside the package."""
    out = {}
    if os.path.isdir(_SPEC_DIR):
        for fn in sorted(os.listdir(_SPEC_DIR)):
            if fn.endswith(".json"):
                out[fn[:-len(".json")]] = os.path.join(_SPEC_DIR, fn)
    return out


def bundled_spec_path(name: str) -> str:
    """Path of a bundled spec by name (``'cin16_saturation'``, ...)."""
    specs = bundled_specs()
    try:
        return specs[name]
    except KeyError:
        raise ValueError(f"no bundled study spec named {name!r}; "
                         f"available: {sorted(specs)}") from None


def resolve_spec_source(spec: str) -> str:
    """A spec argument as every CLI/example accepts it: an existing file
    path wins, otherwise a bundled spec name.  Raises ``ValueError``
    naming the bundled specs when neither matches."""
    if os.path.exists(spec):
        return spec
    try:
        return bundled_spec_path(spec)
    except ValueError:
        raise ValueError(
            f"spec {spec!r} is neither a file nor a bundled spec name "
            f"(bundled: {', '.join(sorted(bundled_specs()))})") from None
