"""The ``Study`` runner: expand a spec grid, batch it, persist, resume.

One :class:`Study` executes the (load x seed) grid of one or more
:class:`~repro_torch.studies.spec.ExperimentSpec`\\ s:

* **Backend.**  ``"torch"`` runs each experiment's grid as one batched
  :func:`repro_torch.sim.xengine.sweep` on the study's ``device``
  (default ``"cuda"``, which raises where CUDA is absent).  ``"numpy"``
  loops the oracle (:func:`repro_torch.sim.engine.simulate`) per point.
  ``"flow"`` runs the fair-share model (:mod:`repro_torch.flow`, its
  solver on the same ``device``).  ``backend=None``/"auto" is the torch
  engine, escalating to the flow model on fabrics of
  :data:`FLOW_AUTO_SWITCHES` switches or more as the reference does; it
  never falls back to the numpy oracle on its own.
* **Streaming persistence.**  Each finished grid point becomes a
  :class:`~repro_torch.studies.store.Result` appended to a JSONL store as
  soon as it exists, so a killed study leaves a valid prefix.
* **Resume.**  A re-run loads the store first and executes only the
  grid points whose keys are missing; a partially-done experiment is
  batched over just its missing points (packed by index into one
  sweep).  On the numpy backend resumed points are bit-identical to an
  uninterrupted run (same per-point engine seeds); on the torch backend
  they are statistically equivalent (the smaller batch draws a different
  arbitration stream), and bit-identical to the reference's ``"jax"``
  resume of the same points, which draws the same stream.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Sequence

from .spec import ExperimentSpec, load_specs
from .store import JsonlStore, Result

__all__ = ["BACKENDS", "FLOW_AUTO_SWITCHES", "Study", "StudyResult"]

#: The valid ``backend=`` values, in the order the CLI offers them —
#: the single source of truth shared by :func:`_select_backend` and
#: ``python -m repro_torch.studies run --backend``.  ``"jax"`` is the
#: reference's name for the compiled engine; here it is ``"torch"``.
BACKENDS = ("auto", "torch", "numpy", "flow")

#: ``backend="auto"`` escalates to the flow model at or above this many
#: switches: the cycle engines' per-point cost grows with N x cycles,
#: while the flow model holds seconds past 4k switches.
FLOW_AUTO_SWITCHES = 1024


def _select_backend(backend: str | None, *,
                    num_switches: int | None = None,
                    experiment: "ExperimentSpec | None" = None) -> str:
    if backend in (None, "auto"):
        if num_switches is not None and num_switches >= FLOW_AUTO_SWITCHES:
            choice = "flow"
        else:
            choice = "torch"
    elif backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    else:
        choice = backend
    if (choice == "flow" and experiment is not None
            and experiment.failures is not None
            and experiment.traffic.pattern == "workload"
            and experiment.failures.policy == "strict"):
        # A collective replay on the flow backend traces every phase's
        # routes through the degraded table; a disconnected residual
        # fabric would only surface deep inside trace_routes as an
        # unwired-port walk.  Check connectivity here, while the error
        # can still name the experiment and the fix.
        from repro_torch.faults import residual_report
        report = residual_report(experiment.fabric.resolve_topology(),
                                 experiment.failures)
        if not report["connected"]:
            raise ValueError(
                f"experiment {experiment.name!r} replays a collective on "
                f"the flow backend, but failures "
                f"{experiment.failures.label!r} leave the fabric in "
                f"{report['num_components']} components and "
                f"policy='strict' forbids dropping the stranded traffic; "
                f"use policy='drop' to mask unreachable pairs, or pick a "
                f"FailureSpec that keeps the fabric connected")
    return choice


@dataclass
class StudyResult:
    """Everything a finished :meth:`Study.run` produced.

    ``results`` follows grid order (experiments in spec order, loads
    major, seeds minor) and mixes freshly executed points with points
    restored from the store (whose ``.stats`` is ``None``).
    """
    experiments: list[ExperimentSpec]
    results: list[Result]
    executed: int
    restored: int
    backend: str
    store_path: str | None = None

    def stats(self):
        """In-memory RunStats per grid point (None for restored points)."""
        return [r.stats for r in self.results]

    def by_experiment(self) -> dict[str, list[Result]]:
        out: dict[str, list[Result]] = {e.name: [] for e in self.experiments}
        for r in self.results:
            out.setdefault(r.experiment, []).append(r)
        return out

    def grid(self, name: str | None = None) -> list[list[Result]]:
        """One experiment's results as the legacy ``[load][seed]`` grid."""
        exps = {e.name: e for e in self.experiments}
        if name is None:
            if len(exps) != 1:
                raise ValueError(f"study has {len(exps)} experiments; "
                                 f"pass the name of one of {sorted(exps)}")
            name = next(iter(exps))
        exp = exps[name]
        by_key = {r.key: r for r in self.results if r.experiment == name}
        return [[by_key[exp.key(load, seed)] for seed in exp.sweep.seeds]
                for load in exp.sweep.loads]

    def fidelities(self) -> dict[str, str]:
        """Per experiment: the fidelity tier of its records — ``"cycle"``
        (packet-level engines), ``"flow"`` (the analytical model), or
        ``"mixed"`` when a resumed store holds both."""
        out: dict[str, str] = {}
        for exp in self.experiments:
            tiers = {getattr(r, "fidelity", "cycle") or "cycle"
                     for r in self.results if r.experiment == exp.name}
            if tiers:
                out[exp.name] = tiers.pop() if len(tiers) == 1 else "mixed"
        return out

    def saturation_points(self, threshold: float = 0.95, *,
                          fidelity: str | None = None
                          ) -> dict[str, float | None]:
        """Per experiment: the smallest offered load whose accepted
        throughput (seed-averaged) falls below ``threshold * offered``.

        ``threshold`` is the tolerated shortfall fraction before a load
        point counts as saturated — 0.95 (the literature's convention)
        flags the knee where the fabric stops accepting ~all offered
        traffic, while tolerating sub-5% sampling noise on uncongested
        points.  Returns ``None`` for experiments that never cross it
        (including collective replays, whose offered load is 0 — see
        :meth:`replay_points` for their headline numbers).

        A knee averaged across fidelity tiers would belong to neither
        model, so mixed-fidelity experiments refuse to produce one:
        pass ``fidelity="cycle"``/``"flow"`` to pick the tier (records
        of other tiers are ignored; experiments with no record of the
        requested tier are omitted), or leave it ``None`` for
        single-tier stores."""
        out = {}
        for exp in self.experiments:
            rows = [r for r in self.results if r.experiment == exp.name]
            if fidelity is not None:
                rows = [r for r in rows
                        if (getattr(r, "fidelity", "cycle") or "cycle")
                        == fidelity]
                if not rows:
                    continue
            else:
                tiers = {getattr(r, "fidelity", "cycle") or "cycle"
                         for r in rows}
                if len(tiers) > 1:
                    raise ValueError(
                        f"experiment {exp.name!r} holds records of mixed "
                        f"fidelities {sorted(tiers)}; their knees are not "
                        f"comparable — pass fidelity='cycle' or "
                        f"fidelity='flow' to saturation_points()")
            by_key = {r.key: r for r in rows}
            knee = None
            for load in exp.sweep.loads:
                row = [by_key[exp.key(load, seed)]
                       for seed in exp.sweep.seeds
                       if exp.key(load, seed) in by_key]
                if not row:
                    continue
                acc = sum(r.accepted for r in row) / len(row)
                if load > 0 and acc < threshold * load:
                    knee = load
                    break
            out[exp.name] = knee
        return out

    def replay_points(self) -> dict[str, dict]:
        """Per collective-replay experiment: measured completion cycles
        vs the schedule algebra's contention-free bound.

        ``measured`` is the worst completion over the experiment's grid
        points; ``ratio`` is ``measured / ideal`` — 1.0 certifies the
        schedule ran contention-free under queueing, anything above it
        quantifies the serialization the replay uncovered.  Experiments
        without replay records are omitted.
        """
        out: dict[str, dict] = {}
        for exp in self.experiments:
            rows = [r for r in self.results
                    if r.experiment == exp.name
                    and r.completion_cycles is not None]
            if not rows:
                continue
            measured = max(r.completion_cycles for r in rows)
            ideal = rows[0].ideal_cycles
            out[exp.name] = {
                "measured": measured,
                "ideal": ideal,
                "ratio": round(measured / ideal, 3) if ideal else None,
            }
        return out

    def serving_points(self) -> dict[str, dict]:
        """Per serving experiment: the grid's worst request-latency
        percentiles and lowest SLO attainment (the headline numbers a
        serving study exists to measure).  Experiments without request
        records are omitted."""
        out: dict[str, dict] = {}
        for exp in self.experiments:
            rows = [r for r in self.results
                    if r.experiment == exp.name
                    and getattr(r, "request_count", None)]
            if not rows:
                continue

            def worst(field_name, rows=rows):
                vals = [getattr(r, field_name) for r in rows
                        if getattr(r, field_name, None) is not None]
                return max(vals) if vals else None

            atts = [r.slo_attainment for r in rows
                    if getattr(r, "slo_attainment", None) is not None]
            out[exp.name] = {
                "requests": sum(r.request_count for r in rows),
                "p50": worst("request_latency_p50"),
                "p95": worst("request_latency_p95"),
                "p99": worst("request_latency_p99"),
                "slo": rows[0].slo_target,
                "attainment": min(atts) if atts else None,
            }
        return out

    def telemetry(self) -> dict[str, dict]:
        """Compile-vs-execute telemetry per experiment, deduplicated.

        A batched experiment shares one timing dict across its
        grid points, so the sum here counts each program once, not once
        per point.  ``compile_s``/``execute_s`` are program totals;
        ``points`` is the grid points they covered (restored points
        contribute their stored provenance timings, if any).
        """
        out: dict[str, dict] = {}
        for exp in self.experiments:
            seen: list[dict] = []
            points = 0
            for r in self.results:
                if r.experiment != exp.name:
                    continue
                timing = (r.provenance or {}).get("timings")
                if timing is None and r.stats is not None:
                    timing = r.stats.timing
                if timing is None:
                    continue
                points += 1
                # A batched program's dict is one shared object across
                # its fresh points; restored points get value-equal
                # copies from JSON (wall-clock values to 6 decimals make
                # distinct programs with equal dicts improbable).
                if not any(t is timing or t == timing for t in seen):
                    seen.append(timing)
            if seen:
                out[exp.name] = {
                    "backend": seen[0].get("backend"),
                    "programs": len(seen),
                    "points": points,
                    "compile_s": round(sum(t.get("compile_s", 0.0)
                                           for t in seen), 6),
                    "execute_s": round(sum(t.get("execute_s", 0.0)
                                           for t in seen), 6),
                }
        return out

    def table(self) -> str:
        from repro_torch.sim.report import format_table
        return format_table(self.results)


class Study:
    """Run the grid of one spec file / one or more experiment specs.

    ``store`` (a path or :class:`JsonlStore`) turns on persistence and
    resume; ``backend`` picks the engine and ``device`` where the torch
    engine and the flow model's solver run (default ``"cuda"``; they
    raise where CUDA is absent, and ``"cpu"`` runs the same steps
    eagerly):

    * ``"auto"`` / ``None`` (default) — resolved per experiment: fabrics
      with at least :data:`FLOW_AUTO_SWITCHES` switches escalate to the
      flow model (the cycle engine's cost grows with N x cycles), smaller
      ones run the torch cycle engine.  "auto" never picks the oracle on
      its own.
    * ``"torch"`` — the cycle engine (:mod:`repro_torch.sim.xengine`),
      which batches each experiment's entire (load x seed) grid into one
      sweep: one CUDA graph of the step, replayed.
    * ``"numpy"`` — the oracle, looped per point; per-point results are
      bit-stable across resumes (the torch path re-draws arbitration
      streams when a resumed batch has different geometry, so its resumed
      points are statistically — not bitwise — equivalent).
    * ``"flow"`` — the analytical fair-share model
      (:mod:`repro_torch.flow`): a different *fidelity tier* whose records
      carry ``fidelity="flow"`` so stores stay mixable with cycle
      results without their knees being conflated.
    """

    def __init__(self, experiments, *, store=None, backend: str | None = None,
                 device="cuda"):
        self.experiments: list[ExperimentSpec] = load_specs(experiments)
        if not self.experiments:
            raise ValueError("a Study needs at least one experiment")
        names = [e.name for e in self.experiments]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"experiment names must be unique within a study (they key "
                f"the result store); duplicated: {dup}")
        self.store = (store if isinstance(store, JsonlStore)
                      else JsonlStore(store) if store is not None else None)
        self.backend = backend
        self.device = device
        # Experiments naming the same fabric share one resolved topology
        # (one SimTopology build, one memoized LinkTable family).
        self._topo_cache: dict[str, object] = {}

    @staticmethod
    def _fabric_key(fs) -> str | None:
        if fs.is_inline:
            return None
        return json.dumps({"kind": fs.kind, "params": fs.params},
                          sort_keys=True, default=str)

    @property
    def grid_size(self) -> int:
        return sum(len(e.points()) for e in self.experiments)

    # -- execution -----------------------------------------------------------

    def run(self, *, resume: bool = True) -> StudyResult:
        # Backend resolution is per experiment: "auto" escalates to the
        # flow model above FLOW_AUTO_SWITCHES switches, so one study can
        # mix a cycle-accurate CIN-16 grid with a 4k-switch flow grid.
        resolved = {exp.name: _select_backend(
            self.backend, num_switches=exp.fabric.num_switches,
            experiment=exp)
            for exp in self.experiments}
        if {"torch", "flow"} & set(resolved.values()):
            # Fail before any point runs when the device is not there.
            from repro_torch.sim.xengine import _resolve_device
            _resolve_device(self.device)
        label = (next(iter(set(resolved.values())))
                 if len(set(resolved.values())) == 1 else "mixed")
        if self.store is not None and not resume:
            self.store.clear()
        existing = (self.store.load()
                    if self.store is not None and resume else {})
        results: list[Result] = []
        executed = restored = 0
        for exp in self.experiments:
            backend = resolved[exp.name]
            digest = exp.digest()
            exp_results: dict[str, Result] = {}
            missing: list[tuple[float, int]] = []
            for load, seed in exp.points():
                key = exp.key(load, seed)
                if key in existing:
                    stored = existing[key]
                    # The key names the grid point but not the spec's
                    # cycles/warmup/traffic/engine parameters — restoring
                    # a record written by a *different* version of the
                    # spec would silently mislabel its results.
                    if digest and stored.spec_digest and \
                            stored.spec_digest != digest:
                        raise ValueError(
                            f"store {self.store.path!r} holds results for "
                            f"{key!r} produced by a different version of "
                            f"the experiment spec (digest "
                            f"{stored.spec_digest} != {digest}); re-run "
                            f"with resume=False (CLI: --no-resume) or "
                            f"point the study at a fresh store")
                    exp_results[key] = stored
                    restored += 1
                else:
                    missing.append((load, seed))
            if missing:
                if backend == "torch":
                    fresh = self._run_torch(exp, missing)
                    if self.store is not None:
                        self.store.append(fresh)
                elif backend == "flow":
                    fresh = self._run_flow(exp, missing)
                    if self.store is not None:
                        self.store.append(fresh)
                else:           # numpy streams per point inside the loop
                    fresh = self._run_numpy(exp, missing)
                executed += len(fresh)
                exp_results.update((r.key, r) for r in fresh)
            results.extend(exp_results[exp.key(load, seed)]
                           for load, seed in exp.points())
        if self.store is not None:
            # Settle any fsyncs a flush_interval > 1 store deferred.
            self.store.sync()
        return StudyResult(
            experiments=self.experiments, results=results,
            executed=executed, restored=restored, backend=label,
            store_path=self.store.path if self.store is not None else None)

    def _resolve(self, exp: ExperimentSpec):
        fs = exp.fabric
        key = self._fabric_key(fs)
        topo = self._topo_cache.get(key) if key is not None else None
        if topo is None:
            topo = fs.resolve_topology()
            if key is not None:
                self._topo_cache[key] = topo
        if exp.failures is not None:
            # Degrade once per (fabric, FailureSpec) and cache alongside
            # the pristine topology: a failure-rate x seed sweep shares
            # each degraded table across its experiments' grid points.
            from repro_torch.faults import FabricDisconnectedError, degrade
            fkey = (f"{key}|faults={exp.failures.to_json()}"
                    if key is not None else None)
            degraded = (self._topo_cache.get(fkey)
                        if fkey is not None else None)
            if degraded is None:
                try:
                    degraded = degrade(topo, exp.failures)
                except FabricDisconnectedError as e:
                    raise FabricDisconnectedError(
                        f"experiment {exp.name!r}: {e}") from e
                if fkey is not None:
                    self._topo_cache[fkey] = degraded
            topo = degraded
        tf = exp.traffic.factory(topo, cycles=exp.sweep.cycles,
                                 terminals=exp.terminals
                                 if exp.terminals is not None else 1)
        if exp.failures is not None:
            from repro_torch.faults import mask_traffic as _mask
            inner, masked_topo = tf, topo

            def tf(load, seed):
                return _mask(inner(load, seed), masked_topo)
        return topo, tf

    # -- serving capacity ----------------------------------------------------

    def slo_capacity(self, experiment: str | None = None, *,
                     percentile: float = 99.0, lo: float = 0.05,
                     hi: float = 2.0, tol: float = 0.01,
                     seed: int = 0) -> dict:
        """Largest load scale at which a serving experiment still meets
        its SLO, by bisection on the load axis (the reference's
        ``Study.slo_capacity``: the same arguments, probes, rounding and
        ``capacity`` rules).

        A load is *feasible* when the probed point's SLO attainment is
        at least ``percentile / 100`` — i.e. the latency ``percentile``
        sits at or under the traffic's ``slo`` target, with requests
        that never completed counting as misses.  Probes run outside
        the study's store (warmup 0, the experiment's own seed policy)
        on the study's resolved backend: the torch engine on the study's
        ``device`` for ``"auto"``/``"torch"``, the numpy oracle for
        ``"numpy"``, the flow model for ``"flow"`` (and for "auto" on
        flow-sized fabrics).  The reference probes on the numpy oracle
        unless the experiment resolves to the flow tier; the port never
        runs the oracle unless asked (ROADMAP C7), so its default probes
        equal the reference's ``simulate_jax`` at each load and seed.
        Returns ``{"experiment", "capacity", "percentile", "slo",
        "probes": [(load, attainment), ...]}``; ``capacity`` is 0.0 when
        even ``lo`` misses and ``hi`` when the search never found the knee
        (raise ``hi`` to chase it).
        """
        exps = {e.name: e for e in self.experiments}
        if experiment is None:
            if len(exps) != 1:
                raise ValueError(
                    f"study has {len(exps)} experiments; pass one of "
                    f"{sorted(exps)}")
            experiment = next(iter(exps))
        exp = exps[experiment]
        if exp.traffic.pattern != "serving":
            raise ValueError(
                f"slo_capacity needs a 'serving' traffic pattern; "
                f"experiment {exp.name!r} uses {exp.traffic.pattern!r}")
        slo = exp.traffic.params.get("slo")
        if slo is None:
            raise ValueError(
                f"experiment {exp.name!r} sets no params['slo'] target to "
                f"search against")
        if not (0.0 < lo <= hi) or tol <= 0:
            raise ValueError(f"need 0 < lo <= hi and tol > 0; "
                             f"got lo={lo}, hi={hi}, tol={tol}")
        backend = _select_backend(self.backend,
                                  num_switches=exp.fabric.num_switches,
                                  experiment=exp)
        topo, tf = self._resolve(exp)
        target = float(percentile) / 100.0
        probes: list[tuple[float, float]] = []

        def attainment(load: float) -> float:
            if backend == "flow":
                from repro_torch.flow import study_point_stats
                stats = study_point_stats(exp, topo, tf, load, seed,
                                          device=self.device)
            else:
                from repro_torch.sim.engine import simulate
                cycles = exp.sweep.cycles or 1
                stats = simulate(topo, exp.routing.make(), tf(load, seed),
                                 terminals=exp.terminals, cycles=cycles,
                                 warmup=0, seed=seed, backend=backend,
                                 device=self.device, **dict(exp.engine))
            att = stats.slo_attainment
            att = 0.0 if att is None else float(att)
            probes.append((round(float(load), 6), att))
            return att

        out = {"experiment": exp.name, "percentile": float(percentile),
               "slo": float(slo), "probes": probes}
        if attainment(lo) < target:
            out["capacity"] = 0.0
            return out
        if attainment(hi) >= target:
            out["capacity"] = float(hi)
            return out
        good, bad = float(lo), float(hi)
        while bad - good > tol:
            mid = (good + bad) / 2.0
            if attainment(mid) >= target:
                good = mid
            else:
                bad = mid
        out["capacity"] = round(good, 6)
        return out

    def _run_torch(self, exp: ExperimentSpec,
                   missing: Sequence[tuple[float, int]]) -> list[Result]:
        from repro_torch.sim import xengine
        topo, tf = self._resolve(exp)
        sweep = exp.sweep
        kw = dict(terminals=exp.terminals, cycles=sweep.cycles,
                  warmup=sweep.warmup, device=self.device,
                  **dict(exp.engine))
        if list(missing) == exp.points():
            # Full grid: one sweep over loads x seeds, with the per-point
            # arbitration streams keyed off the real seed tuple
            # (bit-identical to the plain xengine.sweep entry point).
            grid = xengine.sweep(topo, exp.routing.make(), tf,
                                 list(sweep.loads), seeds=tuple(sweep.seeds),
                                 **kw)
            flat = [(load, seed, grid[li][si])
                    for li, load in enumerate(sweep.loads)
                    for si, seed in enumerate(sweep.seeds)]
        else:
            # Resume: batch just the missing points into one sweep by
            # packing them along the load axis (the traffic objects carry
            # the real offered loads and seeds; the index is only a
            # routing key).  The batch geometry differs from the full
            # grid's, so the re-executed points draw a fresh arbitration
            # stream — statistically equivalent (numpy resume, by
            # contrast, is bit-identical).  The pseudo-seed keys that
            # stream off the actual missing points, so distinct resumes
            # decorrelate; hash() of a tuple of (float, int) pairs does
            # not depend on the process, so it is the reference's stream.
            pts = list(missing)
            pseudo_seed = hash(tuple(pts)) & 0x7FFFFFFF
            grid = xengine.sweep(
                topo, exp.routing.make(),
                lambda i, _seed: tf(*pts[int(i)]),
                list(range(len(pts))), seeds=(pseudo_seed,), **kw)
            flat = [(load, seed, grid[i][0])
                    for i, (load, seed) in enumerate(pts)]
        return [Result.from_stats(stats, key=exp.key(load, seed),
                                  experiment=exp.name, load=load, seed=seed,
                                  backend="torch",
                                  spec_digest=exp.digest())
                for load, seed, stats in flat]

    def _run_flow(self, exp: ExperimentSpec,
                  missing: Sequence[tuple[float, int]]) -> list[Result]:
        import time
        from repro_torch.flow import study_point_stats
        from repro_torch.obs.telemetry import timing_dict
        topo, tf = self._resolve(exp)
        t0 = time.perf_counter()
        batch = [(load, seed,
                  study_point_stats(exp, topo, tf, load, seed,
                                    device=self.device))
                 for load, seed in missing]
        # One timing dict shared across the batch, like the torch path:
        # the flow model has no capture step, only execute.
        timing = timing_dict("flow",
                             execute_s=time.perf_counter() - t0,
                             grid_points=len(batch))
        out = []
        for load, seed, stats in batch:
            stats.timing = timing
            out.append(Result.from_stats(
                stats, key=exp.key(load, seed), experiment=exp.name,
                load=load, seed=seed, backend="flow",
                spec_digest=exp.digest(), fidelity="flow"))
        return out

    def _run_numpy(self, exp: ExperimentSpec,
                   missing: Sequence[tuple[float, int]]) -> list[Result]:
        from repro_torch.sim.engine import simulate
        topo, tf = self._resolve(exp)
        sweep = exp.sweep
        out = []
        for load, seed in missing:
            traffic = tf(load, seed)
            cycles = (sweep.cycles if sweep.cycles is not None
                      else max(traffic.horizon, 1))
            # Collective replays measure completion from cycle 0 — a
            # warmup window would carve latency/throughput out of the
            # very phases being measured (the torch path does the same
            # inside xengine.sweep).
            warmup = (sweep.warmup if sweep.warmup is not None
                      else 0 if traffic.workload is not None
                      else cycles // 4)
            stats = simulate(topo, exp.routing.make(), traffic,
                             terminals=exp.terminals, cycles=cycles,
                             warmup=warmup, seed=seed, backend="numpy",
                             **dict(exp.engine))
            res = Result.from_stats(stats, key=exp.key(load, seed),
                                    experiment=exp.name, load=load,
                                    seed=seed, backend="numpy",
                                    spec_digest=exp.digest())
            # Stream per point: a killed numpy study resumes mid-experiment.
            if self.store is not None:
                self.store.append(res)
            out.append(res)
        return out
