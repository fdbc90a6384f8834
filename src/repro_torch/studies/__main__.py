"""Command-line entry point: ``python -m repro_torch.studies <command>``.

Commands:

* ``run SPEC``   — execute a study spec (a path, or a bundled spec name)
  and stream results to a JSONL store (default: ``<spec>.results.jsonl``
  in the current directory).  Re-running resumes: grid points whose keys
  are already in the store are skipped.  The torch cycle engine and the
  flow model's solver run on ``--device`` (default ``cuda``, which fails
  where CUDA is absent); ``--backend numpy`` runs the oracle.
* ``show SPEC``  — print the experiments, grid sizes, and store keys a
  spec expands to, without running anything.  ``--results`` additionally
  prints each stored record's fidelity tier, latency percentiles, and
  serving SLO fields (including fields written by a newer version —
  nothing is silently dropped).  ``--trace`` additionally reads the
  spec's result store and prints each record's provenance (host,
  backend, torch/CUDA versions and card, capture-vs-replay timings) plus
  the per-experiment totals.
* ``specs``      — list the bundled spec files.
* ``trace export SPEC`` — run one experiment of a spec with time-series
  tracing and write a Perfetto/Chrome-loadable trace JSON
  (``ui.perfetto.dev``).  The torch engine runs on ``--device``;
  ``--backend both`` runs the numpy oracle *and* the torch engine and
  fails unless their traces agree exactly.
* ``cache`` — the graph cache's counters in this process (the
  reference's compile-cache command; a CUDA graph cannot outlive its
  process, so there is no disk layer).  ``--clear`` empties it.

Examples::

    python -m repro_torch.studies specs
    python -m repro_torch.studies run studies_smoke --backend numpy --table
    python -m repro_torch.studies run collective_replay --store a2a.jsonl
    python -m repro_torch.studies run cin16_saturation --device cpu
    python -m repro_torch.studies show collective_replay --trace --store a2a.jsonl
    python -m repro_torch.studies run flow_scale_smoke
    python -m repro_torch.studies trace export collective_replay \\
        --experiment cin-xor-16/replay-all_to_all/minimal \\
        --backend both --packets 8 --out trace-cin16.json
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from . import (BACKENDS, JsonlStore, Study, bundled_specs, load_specs,
               resolve_spec_source)


def _resolve_spec_arg(spec: str) -> str:
    try:
        return resolve_spec_source(spec)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _default_store(spec_path: str) -> str:
    stem = os.path.splitext(os.path.basename(spec_path))[0]
    return f"{stem}.results.jsonl"


def cmd_run(args) -> int:
    spec_path = _resolve_spec_arg(args.spec)
    store = args.store if args.store is not None else _default_store(spec_path)
    study = Study(spec_path, store=JsonlStore(store),
                  backend=args.backend, device=args.device)
    print(f"study: {spec_path}")
    print(f"store: {store}")
    for exp in study.experiments:
        print(f"  - {exp.describe()}")
    t0 = time.time()
    out = study.run(resume=not args.no_resume)
    dt = time.time() - t0
    print(f"ran {out.executed} grid points "
          f"({out.restored} restored from the store) "
          f"on backend={out.backend} in {dt:.1f}s")
    if args.table:
        print()
        print(out.table())
    replays = out.replay_points()
    if replays:
        print("collective replay (measured vs contention-free bound):")
        for name, rp in replays.items():
            print(f"  {name}: measured={rp['measured']} "
                  f"ideal={rp['ideal']} ratio={rp['ratio']}")
    serving = out.serving_points()
    if serving:
        print("serving SLO (worst grid point):")
        for name, sp in serving.items():
            att = (f"{sp['attainment']:.4f}"
                   if sp['attainment'] is not None else "n/a")
            print(f"  {name}: requests={sp['requests']} p50={sp['p50']} "
                  f"p95={sp['p95']} p99={sp['p99']} "
                  f"slo={sp['slo']} attainment={att}")
    if len(replays) + len(serving) < len(out.experiments):
        print("saturation points:")
        try:
            knees = [("", out.saturation_points())]
        except ValueError:
            # A resumed store mixing fidelity tiers: one knee per tier.
            knees = [(f" [{tier}]", out.saturation_points(fidelity=tier))
                     for tier in ("cycle", "flow")]
        for suffix, tier_knees in knees:
            for name, knee in tier_knees.items():
                if name in replays or name in serving:
                    continue
                print(f"  {name}{suffix}: "
                      f"{knee if knee is not None else '> max load'}")
    return 0


def cmd_show(args) -> int:
    spec_path = _resolve_spec_arg(args.spec)
    specs = load_specs(spec_path)
    total = 0
    for exp in specs:
        pts = exp.points()
        total += len(pts)
        print(exp.describe())
        print(f"    loads={list(exp.sweep.loads)} seeds={list(exp.sweep.seeds)}"
              f" warmup={exp.sweep.warmup}")
        if exp.failures is not None:
            print(f"    failures: {exp.failures.label} "
                  f"(policy={exp.failures.policy})")
        print(f"    first key: {exp.key(*pts[0])}")
    print(f"{len(specs)} experiments, {total} grid points")
    if getattr(args, "results", False):
        _show_results(spec_path, args.store)
    if getattr(args, "trace", False):
        _show_trace(spec_path, specs, args.store)
    return 0


def _show_results(spec_path: str, store_arg: str | None) -> None:
    """The ``show --results`` tail: one line per stored record, with the
    fidelity tier, serving latency percentiles, and any fields written
    by a newer Result version (``extra``) — nothing silently dropped."""
    store_path = store_arg if store_arg is not None \
        else _default_store(spec_path)
    store = JsonlStore(store_path)
    if not store.exists():
        print(f"no result store at {store_path} — run the study first "
              f"(or pass --store)")
        return
    records = store.load()
    print(f"\nstore: {store_path} ({len(records)} records)")
    for key in sorted(records):
        r = records[key]
        line = (f"  {key}: fidelity={r.fidelity} "
                f"accepted={r.accepted} lat_p99={r.latency_p99}")
        if r.completion_cycles is not None:
            line += (f" completion={r.completion_cycles}"
                     f" ideal={r.ideal_cycles}")
        if r.request_count is not None:
            line += (f" requests={r.request_count}"
                     f" req_p50={r.request_latency_p50}"
                     f" req_p95={r.request_latency_p95}"
                     f" req_p99={r.request_latency_p99}")
            if r.slo_target is not None:
                line += (f" slo={r.slo_target}"
                         f" attainment={r.slo_attainment}")
        if r.extra:
            line += " " + " ".join(f"{k}={v}" for k, v in
                                   sorted(r.extra.items()))
        print(line)


def _show_trace(spec_path: str, specs, store_arg: str | None) -> None:
    """The ``show --trace`` tail: stored provenance + capture-vs-replay
    totals (``compile_s`` is the CUDA graph's capture on the torch
    engine, the compile on the reference's)."""
    store_path = store_arg if store_arg is not None \
        else _default_store(spec_path)
    store = JsonlStore(store_path)
    if not store.exists():
        print(f"no result store at {store_path} — run the study first "
              f"(or pass --store)")
        return
    records = store.load()
    print(f"\nstore: {store_path} ({len(records)} records)")
    timed = 0
    for key in sorted(records):
        prov = records[key].provenance or {}
        timings = prov.get("timings")
        if timings is None:
            continue
        timed += 1
        amortized = (timings.get("total_s", 0.0)
                     / max(timings.get("grid_points", 1), 1))
        kind = timings.get("compile_cached")
        cached = f" (cached: {kind})" if kind else ""
        print(f"  {key}")
        print(f"    backend={timings.get('backend')} host={prov.get('host')}"
              f" torch={prov.get('torch')} cuda={prov.get('cuda')}"
              f" device={prov.get('device')}")
        print(f"    compile={timings.get('compile_s')}s{cached}"
              f" execute={timings.get('execute_s')}s"
              f" amortized={amortized:.6f}s/point")
    if not timed:
        print("  no records carry timings (store predates telemetry); "
              "re-run with --no-resume to refresh")
        return
    # Per-experiment compile tax, each batched program counted once.
    from .runner import StudyResult
    by_name = {e.name: e for e in specs}
    summary = StudyResult(
        experiments=[by_name[r.experiment] for r in records.values()
                     if r.experiment in by_name],
        results=list(records.values()), executed=0, restored=len(records),
        backend="").telemetry()
    if summary:
        print("compile tax per experiment (batched programs counted once):")
        for name, t in summary.items():
            print(f"  {name}: {t['programs']} program(s), {t['points']} "
                  f"point(s), compile={t['compile_s']}s "
                  f"execute={t['execute_s']}s")


def cmd_trace(args) -> int:
    if args.action != "export":
        raise SystemExit(f"unknown trace action {args.action!r}")
    from repro_torch.obs import (TraceConfig, export_perfetto,
                                 replay_trace_events)
    spec_path = _resolve_spec_arg(args.spec)
    study = Study(spec_path, device=args.device)
    by_name = {e.name: e for e in study.experiments}
    if args.experiment is not None:
        if args.experiment not in by_name:
            raise SystemExit(
                f"no experiment named {args.experiment!r} in {spec_path}; "
                f"have: {', '.join(sorted(by_name))}")
        exp = by_name[args.experiment]
    elif len(by_name) == 1:
        exp = study.experiments[0]
    else:
        raise SystemExit(
            f"{spec_path} holds {len(by_name)} experiments; pick one with "
            f"--experiment: {', '.join(sorted(by_name))}")

    from repro_torch.sim.engine import simulate
    topo, tf = study._resolve(exp)
    load, seed = exp.points()[0]
    cfg = TraceConfig(stride=args.stride, max_samples=args.max_samples,
                      packets=args.packets)
    engine_kw = dict(exp.engine)
    engine_kw["trace"] = cfg

    def run(backend: str):
        traffic = tf(load, seed)
        cycles = (exp.sweep.cycles if exp.sweep.cycles is not None
                  else max(traffic.horizon, 1))
        warmup = (exp.sweep.warmup if exp.sweep.warmup is not None
                  else 0 if traffic.workload is not None else cycles // 4)
        t0 = time.time()
        stats = simulate(topo, exp.routing.make(), traffic,
                         terminals=exp.terminals, cycles=cycles,
                         warmup=warmup, seed=seed, backend=backend,
                         device=args.device, **engine_kw)
        print(f"{backend}: {stats.trace.num_samples} samples in "
              f"{time.time() - t0:.2f}s "
              f"(timing: {stats.timing})")
        return stats

    backends = (["numpy", "torch"] if args.backend == "both"
                else [args.backend])
    runs = {be: run(be) for be in backends}
    if args.backend == "both":
        a, b = runs["numpy"].trace, runs["torch"].trace
        if not a.equals(b):
            raise SystemExit(
                f"cross-engine trace mismatch on {exp.name!r}: "
                f"{a.diff_summary(b)}")
        print("cross-engine traces agree exactly")
    # The numpy run carries packet spans; prefer it for the export.
    stats = runs.get("numpy") or runs[backends[0]]
    out_path = args.out if args.out is not None else \
        f"trace-{exp.name.replace('/', '-')}.json"
    payload = export_perfetto(out_path,
                              replay_trace_events(stats, topo=topo))
    print(f"wrote {out_path} ({len(payload['traceEvents'])} events) — "
          f"load it in ui.perfetto.dev")
    if stats.completion_cycles is not None and stats.ideal_cycles:
        print(f"completion={stats.completion_cycles} "
              f"ideal={stats.ideal_cycles} "
              f"ratio={stats.completion_cycles / stats.ideal_cycles:.3f}")
    return 0


def cmd_cache(args) -> int:
    """The graph cache of this process: the reference's compile-cache
    command.  A CUDA graph cannot outlive its process, so there is no
    disk layer to list; the counters are this process's, and ``--clear``
    empties the memory layer."""
    from repro_torch.obs.telemetry import cache_stats, clear_caches
    if args.clear:
        clear_caches(memory=True)
        print("cleared the in-process graph cache (no disk layer)")
        return 0
    print("dir:     none (CUDA graphs are kept in memory, per process; "
          "no disk layer)")
    print("entries: 0")
    stats = cache_stats()
    print("this-process counters: " +
          " ".join(f"{k}={v}" for k, v in sorted(stats.items())))
    return 0


def cmd_specs(_args) -> int:
    for name, path in bundled_specs().items():
        n_exp = len(load_specs(path))
        print(f"{name:<24} {n_exp:>2} experiments   {path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.studies",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="execute a study spec")
    run.add_argument("spec", help="spec file path or bundled spec name")
    run.add_argument("--store", default=None,
                     help="JSONL result store (default: <spec>.results.jsonl"
                          " in the current directory)")
    run.add_argument("--backend", default="auto", choices=list(BACKENDS))
    run.add_argument("--device", default="cuda",
                     help="where the torch engine and the flow solver run "
                          "(default: cuda; 'cpu' runs the same steps "
                          "eagerly)")
    run.add_argument("--no-resume", action="store_true",
                     help="re-run every grid point even if already stored")
    run.add_argument("--table", action="store_true",
                     help="print the full result table")
    run.set_defaults(fn=cmd_run)

    show = sub.add_parser("show", help="expand a spec without running")
    show.add_argument("spec", help="spec file path or bundled spec name")
    show.add_argument("--results", action="store_true",
                      help="also print each stored record's fidelity, "
                           "latency percentiles, and serving SLO fields")
    show.add_argument("--trace", action="store_true",
                      help="also print stored provenance/timing records "
                           "and the per-experiment compile tax")
    show.add_argument("--store", default=None,
                      help="result store to read with --trace "
                           "(default: <spec>.results.jsonl)")
    show.set_defaults(fn=cmd_show)

    trace = sub.add_parser(
        "trace", help="run one experiment with tracing and export it")
    trace.add_argument("action", choices=["export"])
    trace.add_argument("spec", help="spec file path or bundled spec name")
    trace.add_argument("--experiment", default=None,
                       help="experiment name within the spec (required "
                            "unless the spec holds exactly one)")
    trace.add_argument("--backend", default="torch",
                       choices=["torch", "numpy", "both"],
                       help="'both' runs both engines and fails unless "
                            "their traces agree exactly")
    trace.add_argument("--device", default="cuda",
                       help="where the torch engine runs (default: cuda)")
    trace.add_argument("--stride", type=int, default=1,
                       help="sample every k-th cycle")
    trace.add_argument("--max-samples", type=int, default=4096)
    trace.add_argument("--packets", type=int, default=0,
                       help="follow K sampled packets hop-by-hop "
                            "(numpy engine only)")
    trace.add_argument("--out", default=None,
                       help="output path (default: trace-<experiment>.json)")
    trace.set_defaults(fn=cmd_trace)

    cache = sub.add_parser(
        "cache", help="inspect the in-process graph cache")
    cache.add_argument("--clear", action="store_true")
    cache.set_defaults(fn=cmd_cache)

    specs = sub.add_parser("specs", help="list bundled spec files")
    specs.set_defaults(fn=cmd_specs)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
