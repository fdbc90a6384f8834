"""Declarative, serializable experiment specs.

The paper's claims are all *experiment grids* — topology family x
routing policy x traffic pattern x offered load x seed.  This module is
the grid as data: four small spec dataclasses compose into an
:class:`ExperimentSpec` whose JSON form round-trips exactly
(``ExperimentSpec.from_json(spec.to_json()) == spec``), so a study can
be named, persisted, diffed, resumed, and shipped to CI as a file.

======================  =====================================================
:class:`FabricSpec`     which topology (resolved via ``repro_torch.fabric``)
:class:`TrafficSpec`    which synthetic pattern (``repro_torch.sim.traffic``)
:class:`RoutingSpec`    which policy (``repro_torch.sim.policies``)
:class:`SweepSpec`      the grid: offered loads x seeds x cycles
======================  =====================================================

The JSON form, :meth:`ExperimentSpec.key` and :meth:`ExperimentSpec.digest`
are the reference's (``repro.studies.spec``) byte for byte, so a result
store written by either package resumes in the other.

Specs are *declarative*: they hold names and parameters, never objects.
The escape hatch for the legacy shims (``report.saturation_sweep``,
``Fabric.sim_sweep``) is the ``.custom(...)`` constructors, which carry a
caller-supplied object/callable; such inline specs run fine but refuse
to serialize.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Sequence

import numpy as np

__all__ = ["FabricSpec", "TrafficSpec", "RoutingSpec", "SweepSpec",
           "ExperimentSpec", "load_specs", "dump_specs"]

_INLINE = "custom"      # kind/pattern/policy marker for non-serializable specs


def _canon(v):
    """Canonical in-memory form: JSON arrays (and tuples) become tuples,
    object keys become strings — so equality between a constructed spec
    and its JSON round-trip is exact."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, Mapping):
        return {str(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return tuple(_canon(x) for x in v.tolist())
    return v


def _jsonable(v):
    """The JSON form of a canonical value (tuples back to lists)."""
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


class _SpecBase:
    """Shared (de)serialization: dataclass fields <-> a JSON object.

    Fields whose name starts with ``_`` are excluded from serialization:
    they carry inline objects (``.custom(...)`` constructors) or lazily
    cached resolutions.  Whether a spec *is* inline is decided by its
    declarative marker (``kind``/``pattern``/``policy`` == "custom"),
    never by the caches — resolving a declarative spec must not stop it
    serializing.
    """

    def __post_init__(self):
        for name, val in list(self.__dict__.items()):
            if not name.startswith("_"):
                object.__setattr__(self, name, _canon(val))

    @property
    def is_inline(self) -> bool:
        return False

    def to_dict(self) -> dict:
        if self.is_inline:
            raise ValueError(
                f"{type(self).__name__} carries an inline (non-declarative) "
                f"object and cannot be serialized; build it from "
                f"names/parameters instead")
        out = {}
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            v = _jsonable(v)
            if isinstance(v, _SpecBase):
                v = v.to_dict()
            out[k] = v
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "_SpecBase":
        return cls(**{str(k): v for k, v in d.items()})

    def to_json(self, **kw) -> str:
        kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "_SpecBase":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Fabric.
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=True)
class FabricSpec(_SpecBase):
    """A topology by name: ``kind`` picks the family, ``params`` the size.

    * ``kind="cin"``       — ``params={"instance": ..., "n": ...}``;
    * ``kind="hyperx"``    — :class:`repro_torch.core.hyperx.HyperXConfig` kwargs;
    * ``kind="dragonfly"`` — :class:`repro_torch.core.dragonfly.DragonflyConfig`
      kwargs.

    ``resolve()`` builds the :class:`repro_torch.fabric.Fabric` through
    ``make_fabric``, so any instance registered with
    :func:`repro_torch.fabric.register_instance` works in every position.
    """
    kind: str
    params: dict = field(default_factory=dict)
    _fabric: Any = field(default=None, compare=False, repr=False)
    _topology: Any = field(default=None, compare=False, repr=False)

    @property
    def is_inline(self) -> bool:
        return self.kind == _INLINE

    def resolve(self):
        """The :class:`repro_torch.fabric.Fabric` this spec names."""
        if self._fabric is not None:
            return self._fabric
        from repro_torch.core.dragonfly import DragonflyConfig
        from repro_torch.core.hyperx import HyperXConfig
        from repro_torch.fabric import make_fabric
        p = dict(self.params)
        if self.kind == "cin":
            fab = make_fabric(p["instance"], int(p["n"]))
        elif self.kind == "hyperx":
            fab = make_fabric(HyperXConfig(**p))
        elif self.kind == "dragonfly":
            fab = make_fabric(DragonflyConfig(**p))
        elif self.kind == _INLINE:
            raise ValueError("inline FabricSpec lost its carried object")
        else:
            raise ValueError(
                f"unknown fabric kind {self.kind!r}; expected "
                f"'cin' | 'hyperx' | 'dragonfly'")
        object.__setattr__(self, "_fabric", fab)
        return fab

    def resolve_topology(self):
        """The simulator :class:`~repro_torch.sim.topology.SimTopology`."""
        if self._topology is not None:
            return self._topology
        topo = self.resolve().sim_topology()
        object.__setattr__(self, "_topology", topo)
        return topo

    @property
    def num_switches(self) -> int | None:
        """Fabric size without resolving the topology — the cheap input
        to backend auto-selection (``None`` for unresolved inline
        specs, whose size is unknowable declaratively)."""
        if self._topology is not None:
            return int(self._topology.num_switches)
        if self.kind == "cin":
            return int(self.params["n"])
        if self.kind == "hyperx":
            out = 1
            for d in self.params.get("dims", ()):
                out *= int(d)
            return out
        if self.kind == "dragonfly":
            return (int(self.params["group_size"])
                    * int(self.params["num_groups"]))
        return None

    @property
    def label(self) -> str:
        if self._topology is not None:
            return self._topology.name
        if self.kind == "cin":
            return f"cin-{self.params.get('instance')}-{self.params.get('n')}"
        if self.kind == "hyperx":
            dims = "x".join(map(str, self.params.get("dims", ())))
            return f"hyperx-{dims}-{self.params.get('instance', 'xor')}"
        if self.kind == "dragonfly":
            p = self.params
            return (f"dragonfly-a{p.get('group_size')}"
                    f"h{p.get('global_ports_per_switch')}"
                    f"g{p.get('num_groups')}")
        return self.kind

    # -- constructors from live objects (shims / convenience) ---------------
    @classmethod
    def from_fabric(cls, fab) -> "FabricSpec":
        """A spec naming an existing :class:`repro_torch.fabric.Fabric` — fully
        declarative for the three in-repo families, and reusing the live
        object (and its cached SimTopology) on resolve."""
        from dataclasses import asdict as dc_asdict
        from repro_torch.fabric import (CINFabric, DragonflyFabric, HyperXFabric)
        if isinstance(fab, CINFabric):
            spec = cls("cin", {"instance": fab.instance, "n": fab.n})
        elif isinstance(fab, HyperXFabric):
            spec = cls("hyperx", dc_asdict(fab.config))
        elif isinstance(fab, DragonflyFabric):
            spec = cls("dragonfly", dc_asdict(fab.config))
        else:
            spec = cls(_INLINE, {"name": getattr(fab, "name", "fabric")},
                       _fabric=fab)
            return spec
        object.__setattr__(spec, "_fabric", fab)
        return spec

    @classmethod
    def from_topology(cls, topo) -> "FabricSpec":
        """A spec naming an existing SimTopology.  The in-repo adapters
        record their construction in ``topo.meta``, so the result is
        declarative for them; unknown topologies become inline specs."""
        from repro_torch.core.dragonfly import DragonflyConfig
        from repro_torch.core.hyperx import HyperXConfig
        from dataclasses import asdict as dc_asdict
        meta = getattr(topo, "meta", {}) or {}
        cfg = meta.get("config")
        if "instance" in meta and "n" in meta:
            spec = cls("cin", {"instance": meta["instance"],
                               "n": int(meta["n"])})
        elif isinstance(cfg, HyperXConfig):
            spec = cls("hyperx", dc_asdict(cfg))
        elif isinstance(cfg, DragonflyConfig):
            spec = cls("dragonfly", dc_asdict(cfg))
        else:
            spec = cls(_INLINE, {"name": topo.name}, _topology=topo)
            return spec
        object.__setattr__(spec, "_topology", topo)
        return spec


# ---------------------------------------------------------------------------
# Traffic.
# ---------------------------------------------------------------------------

#: Declarative pattern names: the open-loop generators of
#: :mod:`repro_torch.sim.traffic`, the closed collective-replay kind, and the
#: request-level serving kind (:mod:`repro_torch.workload`).
_PATTERNS = ("uniform", "permutation", "hotspot", "adversarial", "workload",
             "serving")


@dataclass(frozen=True, eq=True)
class TrafficSpec(_SpecBase):
    """A traffic pattern by name.

    **Open-loop patterns** (``uniform`` / ``permutation`` / ``hotspot`` /
    ``adversarial``): ``params`` forwards generator kwargs
    (``hot_fraction``, ``hot_dst``, ``partner_shift``, ``perm``) plus an
    optional fixed ``seed`` — without one, each grid point's packet set
    draws from its own sweep seed, so multi-seed grids measure traffic
    variance; with one, every point replays the identical packet set and
    the seeds axis varies only arbitration.  These patterns need
    ``sweep.cycles`` to size their generation window, and the sweep's
    ``loads`` are their offered load in packets/terminal/cycle.

    **Collective replay** (``workload``): a closed, phase-barriered
    workload from :mod:`repro_torch.sim.workloads` — the sweep's ``loads`` and
    ``seeds`` are ignored by generation (keys only) and ``cycles`` may
    be ``None`` (the run completes when the workload drains).  ``params``
    is either

    * ``{"collective": "all_to_all" | "all_reduce", "message_size": m}``
      — the workload is derived from the experiment's *own fabric*
      (its LACIN schedules), so the spec stays fully declarative; or
    * ``{"workload": {...}}`` — an explicit
      :meth:`repro_torch.sim.workloads.Workload.to_dict` payload, replayed
      verbatim (still serializable).

    **Serving streams** (``serving``): open-loop *request* arrivals from
    an :class:`repro_torch.workload.ArrivalSpec` — ``params`` is
    ``{"arrival": {...spec dict...}, "packets_per_request": p,
    "slo": cycles}`` and the sweep's ``loads`` scale the arrival rate
    (:func:`repro_torch.workload.serving_traffic`), so the engines report
    per-request latency percentiles and SLO attainment per grid point.
    """
    pattern: str
    params: dict = field(default_factory=dict)
    _factory: Callable | None = field(default=None, compare=False, repr=False)

    @property
    def is_inline(self) -> bool:
        return self.pattern == _INLINE

    @classmethod
    def custom(cls, factory: Callable) -> "TrafficSpec":
        """Inline spec around a legacy ``factory(load[, seed]) -> Traffic``
        callable (not serializable)."""
        return cls(_INLINE, {}, _factory=factory)

    def factory(self, topo, *, cycles: int | None,
                terminals: int) -> Callable:
        """A ``(load, seed) -> Traffic`` generator bound to ``topo``."""
        from repro_torch import sim
        from repro_torch.core.dragonfly import DragonflyConfig
        from repro_torch.sim.xengine import _accepts_seed
        if self._factory is not None:
            inner = self._factory
            if _accepts_seed(inner):
                return inner
            return lambda load, seed: inner(load)
        if self.pattern == "workload":
            tr = self._resolve_workload(topo).traffic()
            return lambda load, seed: tr
        if self.pattern == "serving":
            from repro_torch.workload import ArrivalSpec, serving_traffic
            if cycles is None:
                raise ValueError("serving traffic needs sweep.cycles to "
                                 "size its arrival window")
            kw = dict(self.params)
            spec = ArrivalSpec.coerce(kw.pop("arrival", None))
            if spec is None:
                raise ValueError("serving traffic needs params['arrival'] "
                                 "(an ArrivalSpec dict)")
            ppr = int(kw.pop("packets_per_request", 4))
            slo = kw.pop("slo", None)
            if kw:
                raise ValueError(f"unknown serving traffic params: "
                                 f"{sorted(kw)}")
            n = topo.num_switches
            return lambda load, seed: serving_traffic(
                spec, n, cycles=cycles, load=load, terminals=terminals,
                packets_per_request=ppr, slo=slo, seed=seed)
        if self.pattern not in _PATTERNS:
            raise ValueError(
                f"unknown traffic pattern {self.pattern!r}; expected one "
                f"of {_PATTERNS}")
        if cycles is None:
            raise ValueError(
                f"traffic pattern {self.pattern!r} needs sweep.cycles to "
                f"size its generation window")
        kw = dict(self.params)
        fixed_seed = kw.pop("seed", None)
        if self.pattern == "adversarial":
            cfg = (topo.meta or {}).get("config")
            if not isinstance(cfg, DragonflyConfig):
                raise ValueError(
                    "adversarial traffic is the Dragonfly same-group "
                    f"pattern; topology {topo.name!r} is not a Dragonfly")
            gen, first = sim.adversarial_same_group, cfg
        else:
            gen = {"uniform": sim.uniform, "permutation": sim.permutation,
                   "hotspot": sim.hotspot}[self.pattern]
            first = topo.num_switches
        if self.pattern == "permutation" and "perm" in kw:
            kw["perm"] = np.asarray(kw["perm"], dtype=np.int64)

        def make(load, seed):
            return gen(first, offered=load, cycles=cycles,
                       terminals=terminals,
                       seed=fixed_seed if fixed_seed is not None else seed,
                       **kw)
        return make

    def _resolve_workload(self, topo):
        """The :class:`repro_torch.sim.workloads.Workload` this spec replays on
        ``topo`` — explicit phases if given, else the named collective's
        step sequence on the fabric the topology was built from."""
        from repro_torch.sim.workloads import Workload, collective_workload
        kw = dict(self.params)
        if "workload" in kw:
            w = Workload.from_dict(kw["workload"])
            if w.num_switches != topo.num_switches:
                # Packets sourced past the topology's switch count would
                # never inject; fail here instead of spinning the drain
                # cutoff into a misleading "deadlock" error.
                raise ValueError(
                    f"explicit workload {w.name!r} spans {w.num_switches} "
                    f"switches but the experiment's fabric "
                    f"{topo.name!r} has {topo.num_switches}")
            return w
        meta = getattr(topo, "meta", {}) or {}
        if "instance" in meta and "n" in meta:
            from repro_torch.fabric import make_fabric
            fab = make_fabric(meta["instance"], int(meta["n"]))
        elif meta.get("config") is not None:
            from repro_torch.fabric import make_fabric
            fab = make_fabric(meta["config"])
        else:
            raise ValueError(
                f"workload traffic needs a fabric to derive the "
                f"{kw.get('collective', 'all_to_all')!r} schedule from, "
                f"but topology {topo.name!r} records no construction "
                f"metadata; pass explicit phases via params['workload']")
        return collective_workload(
            fab, str(kw.get("collective", "all_to_all")),
            message_size=int(kw.get("message_size", 1)))

    @property
    def label(self) -> str:
        if self.pattern == "workload":
            wl = self.params.get("workload")
            if isinstance(wl, Mapping):
                return f"replay-{wl.get('name', 'workload')}"
            return f"replay-{self.params.get('collective', 'all_to_all')}"
        if self.pattern == "serving":
            arrival = self.params.get("arrival")
            if isinstance(arrival, Mapping):
                from repro_torch.workload import ArrivalSpec
                try:
                    return f"serving-{ArrivalSpec.from_dict(arrival).label}"
                except (TypeError, ValueError):
                    pass
            return "serving"
        return self.pattern


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=True)
class RoutingSpec(_SpecBase):
    """A routing policy by name (+ kwargs, e.g. adaptive's threshold)."""
    policy: str
    params: dict = field(default_factory=dict)
    _make: Any = field(default=None, compare=False, repr=False)

    @property
    def is_inline(self) -> bool:
        return self.policy == _INLINE

    @classmethod
    def custom(cls, policy) -> "RoutingSpec":
        """Inline spec around a policy object / factory / name."""
        if isinstance(policy, str):
            return cls(policy)
        name = getattr(policy, "name", None) or getattr(
            policy, "__name__", _INLINE)
        return cls(_INLINE, {"name": str(name)}, _make=policy)

    def make(self):
        """A fresh policy object (one per run, like the legacy sweeps)."""
        from repro_torch.sim.policies import make_policy
        from repro_torch.sim.xengine import _resolve_policy
        if self._make is not None:
            return _resolve_policy(self._make)
        return make_policy(self.policy, **dict(self.params))

    @property
    def label(self) -> str:
        if self._make is not None:
            return str(self.params.get("name", _INLINE))
        return self.policy


# ---------------------------------------------------------------------------
# Sweep grid.
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=True)
class SweepSpec(_SpecBase):
    """The grid: offered loads x seeds, over a shared cycle horizon.

    ``cycles=None`` lets the engines derive the horizon from the traffic
    objects (only meaningful with inline traffic specs — declarative
    patterns need ``cycles`` to size their generation window); ``warmup``
    defaults to a quarter of the horizon.
    """
    loads: tuple = (1.0,)
    seeds: tuple = (0,)
    cycles: int | None = None
    warmup: int | None = None

    def __post_init__(self):
        super().__post_init__()
        if not self.loads or not self.seeds:
            raise ValueError("a sweep grid needs at least one load and "
                             "one seed")

    def points(self) -> list[tuple[float, int]]:
        """Grid points in canonical (load-major) order."""
        return [(load, seed) for load in self.loads for seed in self.seeds]


# ---------------------------------------------------------------------------
# The composed experiment.
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=True)
class ExperimentSpec(_SpecBase):
    """One experiment: fabric x traffic x routing, swept over a grid.

    ``name`` keys result records (and resume); it defaults to
    ``<fabric>/<traffic>/<routing>``.  ``terminals`` is the injector
    count per switch; ``None`` means 1 for declarative traffic and
    "whatever the traffic objects record" for inline factories (traffic
    generation and engine agree by construction either way — see
    :func:`repro_torch.sim.traffic.resolve_terminals`).  ``engine`` forwards
    extra engine kwargs (``queue_capacity``, ``num_vcs``, ``eject_bw``,
    ``max_cycles``, ``drain``).

    ``failures`` is an optional :class:`repro_torch.faults.FailureSpec`
    (or its dict form): the experiment then runs on the *degraded* fabric
    — the topology passes through :func:`repro_torch.faults.degrade` once
    per study and traffic to/from dead or disconnected switches is masked
    before injection.  ``failures=None`` (or a null spec) is
    byte-identical to the pre-faults behaviour: the key is omitted from
    ``to_dict``, so spec JSON and digests are the reference's.
    """
    fabric: FabricSpec = None
    traffic: TrafficSpec = None
    routing: RoutingSpec = None
    sweep: SweepSpec = field(default_factory=SweepSpec)
    name: str = ""
    terminals: int | None = None
    engine: dict = field(default_factory=dict)
    failures: Any = None

    def __post_init__(self):
        for fld, typ in (("fabric", FabricSpec), ("traffic", TrafficSpec),
                         ("routing", RoutingSpec), ("sweep", SweepSpec)):
            v = getattr(self, fld)
            if isinstance(v, Mapping):
                object.__setattr__(self, fld, typ.from_dict(v))
            elif not isinstance(v, typ):
                raise TypeError(f"ExperimentSpec.{fld} must be a {typ.__name__}"
                                f" (or its dict form), got {type(v).__name__}")
        if self.failures is not None:
            from repro_torch.faults import FailureSpec
            spec = FailureSpec.coerce(self.failures)
            object.__setattr__(self, "failures",
                               None if spec is not None and spec.is_null
                               else spec)
        super().__post_init__()
        if not self.name:
            object.__setattr__(self, "name", "/".join(
                (self.fabric.label, self.traffic.label, self.routing.label)))

    def to_dict(self) -> dict:
        out = super().to_dict()
        if out.get("failures") is None:
            # Absent and None are the same spec; omitting the key keeps
            # old JSON loading exactly and leaves pre-faults digests (and
            # thus resumable stores) untouched.
            out.pop("failures", None)
        return out

    @property
    def is_inline(self) -> bool:
        return (self.fabric.is_inline or self.traffic.is_inline
                or self.routing.is_inline)

    def key(self, load: float, seed: int) -> str:
        """The stable identity of one grid point in a result store."""
        return f"{self.name}|load={load!r}|seed={seed}"

    def digest(self) -> str:
        """A short hash of the declarative spec *minus the grid axes*,
        carried by every stored :class:`~repro_torch.studies.store.Result` so a
        resume can detect that the spec behind a key changed (cycles,
        warmup, traffic or engine params — none of which the key itself
        encodes).  ``loads``/``seeds`` are excluded: the key already
        names the grid point, and growing a grid must resume cleanly,
        executing only the new points.  Inline specs are unhashable and
        return ``""`` (resume skips the check)."""
        if self.is_inline:
            return ""
        import hashlib
        d = self.to_dict()
        d["sweep"] = {k: v for k, v in d["sweep"].items()
                      if k not in ("loads", "seeds")}
        return hashlib.sha1(json.dumps(d, sort_keys=True).encode()
                            ).hexdigest()[:12]

    def points(self):
        return self.sweep.points()

    def describe(self) -> str:
        s = self.sweep
        out = (f"{self.name}: {len(s.loads)} loads x {len(s.seeds)} seeds"
               f" x {s.cycles} cycles (terminals={self.terminals})")
        if self.failures is not None:
            out += f" failures={self.failures.label}"
        return out

    def with_sweep(self, **kw) -> "ExperimentSpec":
        """A copy with sweep fields replaced (loads, seeds, cycles, warmup)
        — the knob benchmarks use to shrink bundled specs in quick mode."""
        return replace(self, sweep=replace(self.sweep, **kw))


# ---------------------------------------------------------------------------
# Spec files: one experiment, or {"experiments": [...]}.
# ---------------------------------------------------------------------------

def load_specs(source) -> list[ExperimentSpec]:
    """Experiments from a spec file path, JSON string, or parsed object.

    Accepts a single experiment object or ``{"experiments": [...]}``
    (extra top-level keys like ``"study"``/``"description"`` are
    ignored, so spec files can self-document).
    """
    if isinstance(source, (list, tuple)):
        return [e if isinstance(e, ExperimentSpec)
                else ExperimentSpec.from_dict(e) for e in source]
    if isinstance(source, ExperimentSpec):
        return [source]
    if isinstance(source, Mapping):
        obj = source
    else:
        text = str(source)
        if text.lstrip().startswith(("{", "[")):
            obj = json.loads(text)
        else:
            with open(text) as f:
                obj = json.load(f)
    if isinstance(obj, list):
        return [ExperimentSpec.from_dict(e) for e in obj]
    if "experiments" in obj:
        return [ExperimentSpec.from_dict(e) for e in obj["experiments"]]
    return [ExperimentSpec.from_dict(obj)]


def dump_specs(specs: Sequence[ExperimentSpec], path: str | None = None, *,
               study: str | None = None, description: str | None = None
               ) -> str:
    """Serialize experiments to a spec-file JSON string (and ``path``)."""
    specs = [specs] if isinstance(specs, ExperimentSpec) else list(specs)
    payload: dict = {}
    if study:
        payload["study"] = study
    if description:
        payload["description"] = description
    payload["experiments"] = [e.to_dict() for e in specs]
    text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
