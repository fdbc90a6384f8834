"""The ``Fabric`` protocol: one surface for every LACIN topology.

The paper's point is that one cabling discipline serves every scale — a
single CIN, a HyperX product of CINs (§5), or a Dragonfly hierarchy of
CINs (§5/Fig. 3).  :class:`CINFabric`, :class:`HyperXFabric` and
:class:`DragonflyFabric` expose that uniformly:

======================  ====================================================
``neighbor_matrix()``   (N, P) switch graph, ``-1`` = unwired port
``peer_port_matrix()``  far-end port per (switch, port) — the cabling rule
``schedule()``          the LACIN step schedule(s) the fabric runs
``sim_topology()``      packet-simulator adapter (:mod:`repro_torch.sim`)
``link_loads()``        closed-form uniform-traffic link loads
``deployment()``        physical arithmetic (racks / hoses / colours)
``verify()``            structural report with an ``"ok"`` verdict
``collectives(mesh)``   mesh-aware LACIN collectives, shape-checked
``replay(collective)``  packet-simulate the fabric's own schedule steps
======================  ====================================================

``make_fabric`` dispatches: a registered instance name + size -> CIN, a
:class:`~repro_torch.core.hyperx.HyperXConfig` -> HyperX, a
:class:`~repro_torch.core.dragonfly.DragonflyConfig` -> Dragonfly.  Anything
registered via :func:`repro_torch.fabric.register_instance` works in all three
positions (single fabric, HyperX dimension, Dragonfly local/global).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np

from repro_torch.core.dragonfly import DragonflyConfig
from repro_torch.core.hyperx import HyperXConfig, HyperXDeployment
from repro_torch.core.port_matrix import verify_instance
from repro_torch.core.schedule import LacinSchedule, make_schedule
from repro_torch.core.simulate import (cin_link_loads,
                                       dragonfly_link_loads,
                                       hyperx_link_loads, valiant_link_loads)

from .collectives import LacinCollectives
from .registry import get_instance

__all__ = ["Fabric", "CINFabric", "HyperXFabric", "DragonflyFabric",
           "make_fabric"]


class Fabric(abc.ABC):
    """Abstract fabric: a switch graph wired from CIN instances."""

    name: str

    @property
    @abc.abstractmethod
    def num_switches(self) -> int: ...

    @property
    @abc.abstractmethod
    def diameter(self) -> int: ...

    def sim_topology(self):
        """A :class:`repro_torch.sim.topology.SimTopology` for the packet engine,
        built once and cached on the fabric (construction is O(N*ports)
        Python loops; every accessor below shares one build)."""
        topo = self.__dict__.get("_sim_topology")
        if topo is None:
            topo = self._build_sim_topology()
            # frozen dataclass: bypass __setattr__ for the cache slot
            self.__dict__["_sim_topology"] = topo
        return topo

    @abc.abstractmethod
    def _build_sim_topology(self):
        """Construct the SimTopology (uncached)."""

    def sim_sweep(self, policy, traffic_factory, loads, *,
                  seeds=(0,), backend: str = "torch",
                  terminals: int | None = None,
                  cycles: int | None = None, warmup: int | None = None,
                  device="cuda", **sim_kw):
        """Deprecated shim: packet-level saturation sweep of this fabric.

        Describe the sweep as a :class:`repro_torch.studies.ExperimentSpec`
        (``FabricSpec.from_fabric(fab)`` names this fabric declaratively)
        and run it with :class:`repro_torch.studies.Study` instead — same
        batched cycle engine, plus persistence/resume/spec files.  Runs
        the torch engine on ``device`` (default ``"cuda"``, which raises
        where CUDA is absent).  Returns a ``[load][seed]`` grid of
        RunStats.
        """
        import warnings

        from repro_torch._compat import LacinDeprecationWarning
        from repro_torch.studies import (ExperimentSpec, FabricSpec,
                                         RoutingSpec, Study, SweepSpec,
                                         TrafficSpec)
        warnings.warn(
            "Fabric.sim_sweep is deprecated; describe the sweep as a "
            "repro_torch.studies.ExperimentSpec and run it with "
            "repro_torch.studies.Study (see README 'Running studies')",
            LacinDeprecationWarning, stacklevel=2)
        spec = ExperimentSpec(
            fabric=FabricSpec.from_fabric(self),
            traffic=TrafficSpec.custom(traffic_factory),
            routing=RoutingSpec.custom(policy),
            sweep=SweepSpec(loads=tuple(loads), seeds=tuple(seeds),
                            cycles=cycles, warmup=warmup),
            terminals=terminals, engine=dict(sim_kw))
        out = Study(spec, backend=backend, device=device).run()
        return [[r.stats for r in row] for row in out.grid()]

    def replay(self, collective: str = "all_to_all", *,
               message_size: int = 1, policy="minimal",
               backend: str = "torch", seed: int = 0, failures=None,
               device="cuda", **engine_kw):
        """Replay one of this fabric's own collective schedules through
        the packet simulator (:mod:`repro_torch.sim.workloads`).

        ``collective`` is ``"all_to_all"``, ``"all_reduce"``,
        ``"reduce_scatter"`` or ``"all_gather"``: the step sequence of
        :meth:`schedule` that the reference's collectives execute on this
        fabric.
        Returns :class:`~repro_torch.sim.metrics.RunStats` with the replay
        fields set (``phase_cycles`` / ``completion_cycles`` /
        ``ideal_cycles``), so ``stats.completion_cycles ==
        stats.ideal_cycles`` *is* the paper's contention-freedom claim,
        measured under queueing.

        ``backend`` is a :func:`repro_torch.sim.engine.simulate` backend:
        ``"torch"`` (the default: the cycle engine on ``device``, default
        ``"cuda"``, which raises where CUDA is absent) or ``"numpy"`` (the
        oracle) measure the replay cycle-accurately; ``"flow"`` solves it
        at flow fidelity.  ``failures=`` replays on a degraded fabric, as
        the reference's does.  Both go to
        :func:`repro_torch.sim.workloads.replay` as they are.
        """
        from repro_torch.sim.workloads import collective_workload
        from repro_torch.sim.workloads import replay as replay_workload
        w = collective_workload(self, collective, message_size=message_size)
        return replay_workload(self.sim_topology(), policy, w,
                               backend=backend, seed=seed,
                               failures=failures, device=device, **engine_kw)

    @abc.abstractmethod
    def link_loads(self, traffic="uniform") -> dict:
        """Closed-form link loads under ``traffic`` (default uniform a2a)."""

    @abc.abstractmethod
    def deployment(self) -> dict:
        """Physical deployment arithmetic report."""

    @abc.abstractmethod
    def verify(self) -> dict:
        """Structural verification report; ``report['ok']`` is the verdict."""

    @abc.abstractmethod
    def collectives(self, mesh=None, **axes) -> LacinCollectives:
        """Mesh-aware collectives; checks the mesh matches the fabric."""

    def neighbor_matrix(self) -> np.ndarray:
        """(N, P) neighbour matrix (``-1`` = unwired port)."""
        return self.sim_topology().neighbor

    def peer_port_matrix(self) -> np.ndarray:
        """Far-end port index per (switch, port) (``-1`` = unwired)."""
        return self.sim_topology().rev_port

    @property
    def num_links(self) -> int:
        return self.sim_topology().num_links


def _check_axis(mesh, axis_name: str, want: int, what: str) -> None:
    """``mesh`` (a ``DeviceMesh``) has an axis ``axis_name`` of size
    ``want``; ``mesh=None`` checks nothing."""
    if mesh is None:
        return
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(
            f"mesh has no axis {axis_name!r} (axes: {names}); the {what} "
            f"needs one of size {want}")
    have = int(mesh.size(names.index(axis_name)))
    if have != want:
        raise ValueError(
            f"mesh axis {axis_name!r} has size {have} but the {what} "
            f"needs {want}; bind the fabric to a matching mesh axis")


# ---------------------------------------------------------------------------
# Single CIN.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CINFabric(Fabric):
    """A single N-switch CIN of a registered instance (paper §2-§4)."""
    instance: str
    n: int

    def __post_init__(self):
        get_instance(self.instance).check(self.n)

    @property
    def name(self) -> str:
        return f"cin-{self.instance}-{self.n}"

    @property
    def num_switches(self) -> int:
        return self.n

    @property
    def diameter(self) -> int:
        return 1

    @property
    def spec(self):
        return get_instance(self.instance)

    def port_matrix(self) -> np.ndarray:
        return self.spec.matrix(self.n)

    def neighbor(self, s, i):
        """Neighbour of switch ``s`` through port ``i``."""
        return self.spec.neighbor(s, i, self.n)

    def route(self, a, b):
        """Port used at ``a`` to reach ``b`` (table-free, §3)."""
        return self.spec.route(a, b, self.n)

    def schedule(self, instance: str | None = None) -> LacinSchedule:
        """The 1-factor step schedule.  Anisoport instances (swap) have no
        matching columns; they get the ``cyclic`` anisoport baseline."""
        if instance is None:
            instance = self.instance if self.spec.isoport else "cyclic"
        return make_schedule(instance, self.n)

    def _build_sim_topology(self):
        from repro_torch.sim.topology import cin_topology
        return cin_topology(self.instance, self.n)

    def link_loads(self, traffic="uniform") -> dict:
        if traffic == "uniform":
            per_link = cin_link_loads(self.instance, self.n)
            return {"per_link": per_link,
                    "summary": {"max": max(per_link.values()),
                                "min": min(per_link.values()),
                                "links_used": len(per_link)}}
        if isinstance(traffic, str):
            raise NotImplementedError(
                f"CIN closed forms cover 'uniform' traffic or an explicit "
                f"list of (src, dst, demand) flows, not {traffic!r}; use "
                f"repro_torch.sim for other patterns")
        # traffic as explicit (src, dst, demand) hot flows: Valiant spread.
        return valiant_link_loads(self.instance, self.n, list(traffic))

    def deployment(self) -> dict:
        """Linear-layout arithmetic (paper §4)."""
        from repro_torch.core.layout import (lacin_total_wire_length,
                                       swap_total_wire_length)
        iso = self.spec.isoport
        return {
            "name": self.name,
            "switches": self.n,
            "ports_per_switch": int(self.spec.num_ports(self.n)),
            "links": (self.n * (self.n - 1)) // 2,
            "isoport": iso,
            "port_columns": int(self.spec.num_ports(self.n)) if iso else 0,
            "total_wire_length": (lacin_total_wire_length(self.n) if iso
                                  else swap_total_wire_length(self.n)),
        }

    def verify(self) -> dict:
        report = verify_instance(self.instance, self.n)
        if self.spec.isoport:
            s = self.schedule()
            report["schedule_matchings"] = s.is_matching_per_step()
            report["schedule_contention_free"] = s.is_contention_free()
            report["schedule_covers_pairs"] = s.covers_all_pairs()
            report["ok"] = bool(report["ok"] and report["schedule_matchings"]
                                and report["schedule_contention_free"]
                                and report["schedule_covers_pairs"])
        return report

    def collectives(self, mesh=None, axis_name: str | None = None,
                    **kw) -> LacinCollectives:
        if axis_name is not None:
            _check_axis(mesh, axis_name, self.n, f"{self.name} fabric")
        inst = self.instance if self.spec.isoport else "auto"
        axes = ((axis_name, inst),) if axis_name else ()
        return LacinCollectives(mesh=mesh, instance=inst,
                                axis_instances=axes, **kw)


# ---------------------------------------------------------------------------
# HyperX: Cartesian product of CINs.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HyperXFabric(Fabric):
    """A HyperX of per-dimension CINs (paper §5, Figure 4)."""
    config: HyperXConfig

    @property
    def name(self) -> str:
        dims = "x".join(map(str, self.config.dims))
        return f"hyperx-{dims}-{self.config.instance}"

    @property
    def num_switches(self) -> int:
        return self.config.num_switches

    @property
    def diameter(self) -> int:
        return self.config.diameter

    def schedule(self) -> tuple[LacinSchedule, ...]:
        """One LACIN schedule per dimension (composed dimension-order)."""
        return tuple(make_schedule(self.config.instance, k)
                     for k in self.config.dims)

    def _build_sim_topology(self):
        from repro_torch.sim.topology import hyperx_topology
        return hyperx_topology(self.config)

    def link_loads(self, traffic="uniform", sample_pairs=None) -> dict:
        if traffic != "uniform":
            raise NotImplementedError("HyperX closed forms cover uniform "
                                      "traffic; use repro_torch.sim for others")
        return hyperx_link_loads(self.config, sample_pairs=sample_pairs)

    def deployment(self) -> dict:
        c = self.config
        if c.num_dims == 3:
            # Full §5/Fig. 4 rack arithmetic (Z in-rack, X/Y super-ports).
            return HyperXDeployment(c).report()
        return {
            "dims": c.dims,
            "instance": c.instance,
            "switches": c.num_switches,
            "endpoints": c.num_endpoints,
            "radix": c.radix,
            "network_ports_per_switch": c.network_ports_per_switch,
            "total_links": c.num_links,
        }

    def verify(self) -> dict:
        c = self.config
        report = {"name": self.name, "dims": c.dims}
        ok = True
        for d, k in enumerate(c.dims):
            rep = verify_instance(c.instance, k)
            report[f"dim{d}_ok"] = rep["ok"]
            ok = ok and rep["ok"]
        try:
            self.sim_topology().validate()
            report["links_pair_up"] = True
        except ValueError:
            report["links_pair_up"] = ok = False
        # DOR delivery: hop count == number of differing digits <= diameter.
        rng = np.random.default_rng(0)
        n = c.num_switches
        for _ in range(min(64, n * n)):
            a, b = map(int, rng.integers(0, n, 2))
            hops = c.dor_route(c.switch_coord(a), c.switch_coord(b))
            want = sum(x != y for x, y in
                       zip(c.switch_coord(a), c.switch_coord(b)))
            ok = ok and len(hops) == want <= c.diameter
        report["dor_delivers"] = ok
        report["ok"] = ok
        return report

    def collectives(self, mesh=None, axis_names=None, **kw) -> LacinCollectives:
        axes = ()
        if axis_names is not None:
            names = tuple(axis_names)
            if len(names) != len(self.config.dims):
                raise ValueError(
                    f"{self.name} has {len(self.config.dims)} dimensions "
                    f"but got axes {names}")
            for a, k in zip(names, self.config.dims):
                _check_axis(mesh, a, k, f"{self.name} dimension {a!r}")
            axes = tuple((a, self.config.instance) for a in names)
        return LacinCollectives(mesh=mesh, instance=self.config.instance,
                                axis_instances=axes, **kw)


# ---------------------------------------------------------------------------
# Dragonfly: local CINs under a global CIN.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DragonflyFabric(Fabric):
    """A Dragonfly of LACIN groups under a LACIN global network (§5/Fig. 3)."""
    config: DragonflyConfig

    @property
    def name(self) -> str:
        c = self.config
        return f"dragonfly-a{c.group_size}h{c.global_ports_per_switch}g{c.num_groups}"

    @property
    def num_switches(self) -> int:
        return self.config.switches

    @property
    def diameter(self) -> int:
        return 3  # l-g-l

    def schedule(self) -> dict[str, LacinSchedule]:
        """The local and global LACIN schedules of the two-level hierarchy."""
        c = self.config
        return {"local": make_schedule(c.local_instance, c.group_size),
                "global": make_schedule(c.global_instance, c.num_groups)}

    def _build_sim_topology(self):
        from repro_torch.sim.topology import dragonfly_topology
        return dragonfly_topology(self.config)

    def link_loads(self, traffic="uniform") -> dict:
        if traffic != "uniform":
            raise NotImplementedError("Dragonfly closed forms cover uniform "
                                      "traffic; use repro_torch.sim for others")
        return dragonfly_link_loads(self.config)

    def deployment(self) -> dict:
        c = self.config
        return {
            "name": self.name,
            "groups": c.num_groups,
            "group_size": c.group_size,
            "switches": c.switches,
            "endpoints": c.endpoints,
            "radix": c.radix,
            "local_links_per_group": c.local_links_per_group,
            "global_links": c.global_links,
            "total_links": c.total_links,
            "local_instance": c.local_instance,
            "global_instance": c.global_instance,
        }

    def verify(self) -> dict:
        c = self.config
        report = {
            "name": self.name,
            "local_ok": verify_instance(c.local_instance, c.group_size)["ok"],
            "global_ok": verify_instance(c.global_instance, c.num_groups)["ok"],
        }
        ok = report["local_ok"] and report["global_ok"]
        try:
            self.sim_topology().validate()
            report["links_pair_up"] = True
        except ValueError:
            report["links_pair_up"] = ok = False
        # minimal l-g-l delivery over sampled endpoint pairs
        rng = np.random.default_rng(0)
        for _ in range(64):
            ga, gb = map(int, rng.integers(0, c.num_groups, 2))
            sa, sb = map(int, rng.integers(0, c.group_size, 2))
            hops = c.route_packet((ga, sa, 0), (gb, sb, 0))
            kinds = [h[0] for h in hops]
            ok = ok and hops[-1] == ("eject", (gb, sb, 0))
            ok = ok and kinds.count("global") == (0 if ga == gb else 1)
            ok = ok and len(hops) <= 4
        report["lgl_delivers"] = ok
        report["ok"] = ok
        return report

    def collectives(self, mesh=None, local_axis: str | None = None,
                    global_axis: str | None = None, **kw) -> LacinCollectives:
        c = self.config
        axes = []
        if local_axis is not None:
            _check_axis(mesh, local_axis, c.group_size,
                        f"{self.name} local CIN")
            axes.append((local_axis, c.local_instance))
        if global_axis is not None:
            _check_axis(mesh, global_axis, c.num_groups,
                        f"{self.name} global CIN")
            axes.append((global_axis, c.global_instance))
        return LacinCollectives(mesh=mesh, instance="auto",
                                axis_instances=tuple(axes), **kw)


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------

def make_fabric(spec, n: int | None = None) -> Fabric:
    """One constructor for every topology.

    * ``make_fabric("xor", 16)`` (any registered instance name) -> CIN;
    * ``make_fabric(HyperXConfig(...))``                        -> HyperX;
    * ``make_fabric(DragonflyConfig(...))``                     -> Dragonfly;
    * an existing :class:`Fabric` passes through unchanged.
    """
    if isinstance(spec, Fabric):
        return spec
    if isinstance(spec, HyperXConfig):
        return HyperXFabric(spec)
    if isinstance(spec, DragonflyConfig):
        return DragonflyFabric(spec)
    if isinstance(spec, str):
        if n is None:
            raise ValueError("make_fabric(instance_name, n) needs the size n")
        return CINFabric(spec, n)
    raise TypeError(f"cannot build a fabric from {type(spec).__name__}")
