"""Command-line entry point: ``python -m repro_torch.workload <command>``.

Commands:

* ``replay`` — replay a workload JSON (:meth:`Workload.to_dict`, as
  ``extract`` writes it) on a fabric through the cycle
  engines.  ``--backend both`` runs the numpy oracle *and* the torch
  engine, asserts ``measured >= ideal`` (the contention-free bound) and
  exact cross-engine agreement.  The torch engine runs on ``--device``
  (default ``cuda``, which fails where CUDA is absent).
* ``slo`` — run :meth:`repro_torch.studies.Study.slo_capacity` on a
  serving study spec: the largest arrival-rate scale whose latency
  percentile still meets the SLO.  Probes run on ``--backend`` (default
  auto: the torch engine on ``--device``).  Prints the reference's lines,
  then the graph cache's captures and hits over the search (nearby
  probes share a bucketed graph).
* ``extract`` — run a training step (``--step moe | dp | pipeline``)
  once as rank 0 of a ``--devices``-rank recording group (torch's
  ``"fake"`` process group: every call posted, no data moved) on
  ``--device`` (default ``cuda``, which fails where CUDA is absent;
  ``cpu`` on request), lower the collectives it posts onto a CIN fabric
  of the same size, and write the resulting
  :class:`~repro_torch.sim.workloads.Workload` as JSON.

Examples::

    python -m repro_torch.workload extract --step moe --devices 8 \\
        --bytes-per-packet 256 -o moe8.workload.json
    python -m repro_torch.workload replay moe8.workload.json --backend both
    python -m repro_torch.workload slo serving_slo \\
        --experiment cin-xor-16/serving-poisson-r0.05/minimal
"""
from __future__ import annotations

import argparse
import json
import sys


def cmd_extract(args) -> int:
    from repro_torch.workload.extract import extract_ops, workload_from_ops
    step_kw = {"dp": args.dp} if args.step == "moe" and args.dp > 1 else {}
    ops = extract_ops(args.step, args.devices, group="fake",
                      device=args.device, **step_kw)
    w = workload_from_ops(ops, (args.fabric, args.n or args.devices),
                          bytes_per_packet=args.bytes_per_packet,
                          strict=not args.lenient, name=args.name)
    wd = w.to_dict()
    out = args.out or f"{args.step}{args.devices}.workload.json"
    with open(out, "w") as f:
        json.dump(wd, f, indent=2, sort_keys=True)
        f.write("\n")
    total = sum(len(p["src"]) * p["messages"] for p in wd["phases"])
    print(f"wrote {out}: workload {wd['name']!r}, "
          f"{wd['num_switches']} switches, {len(wd['phases'])} phases, "
          f"{total} packets")
    return 0


def cmd_replay(args) -> int:
    from repro_torch.fabric import make_fabric
    from repro_torch.sim.workloads import Workload, replay
    with open(args.workload) as f:
        w = Workload.from_dict(json.load(f))
    fab = make_fabric(args.fabric, args.n or w.num_switches)
    topo = fab.sim_topology()
    backends = ["numpy", "torch"] if args.backend == "both" else [args.backend]
    runs = {}
    for be in backends:
        stats = replay(topo, args.routing, w, backend=be, device=args.device)
        runs[be] = stats
        ratio = (stats.completion_cycles / stats.ideal_cycles
                 if stats.ideal_cycles else float("nan"))
        print(f"{be}: completion={stats.completion_cycles} "
              f"ideal={stats.ideal_cycles} ratio={ratio:.3f}")
        if stats.completion_cycles < stats.ideal_cycles:
            raise SystemExit(
                f"{be}: measured completion {stats.completion_cycles} "
                f"below the contention-free bound {stats.ideal_cycles} — "
                f"the replay undercounted wire time")
    if args.backend == "both":
        a, b = runs["numpy"], runs["torch"]
        if (a.completion_cycles != b.completion_cycles
                or a.phase_cycles != b.phase_cycles):
            raise SystemExit(
                f"cross-engine replay mismatch: numpy "
                f"completion={a.completion_cycles} "
                f"phases={list(a.phase_cycles or ())} vs torch "
                f"completion={b.completion_cycles} "
                f"phases={list(b.phase_cycles or ())}")
        print("cross-engine replay agrees exactly")
    return 0


def cmd_slo(args) -> int:
    from repro_torch.obs.telemetry import cache_stats
    from repro_torch.studies import Study, resolve_spec_source
    spec = resolve_spec_source(args.spec)
    study = Study(spec, backend=args.backend, device=args.device)
    cap = study.slo_capacity(args.experiment, percentile=args.percentile,
                             lo=args.lo, hi=args.hi, tol=args.tol)
    print(f"experiment: {cap['experiment']}")
    print(f"slo: p{cap['percentile']:g} <= {cap['slo']} cycles")
    for load, att in cap["probes"]:
        print(f"  probe load={load}: attainment={att}")
    print(f"capacity: {cap['capacity']}")
    stats = cache_stats()
    print(f"graph cache: captures={stats['misses']} "
          f"memory_hits={stats['memory_hits']} "
          f"evictions={stats['evictions']}")
    return 0


def main(argv=None) -> int:
    from repro_torch.studies import BACKENDS
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.workload",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("extract",
                        help="run a training step and lower its "
                             "collectives to a replayable workload JSON")
    ex.add_argument("--step", choices=["moe", "dp", "pipeline"],
                    required=True)
    ex.add_argument("--devices", type=int, required=True,
                    help="ranks of the recording group")
    ex.add_argument("--dp", type=int, default=1,
                    help="data-parallel axis size for --step moe")
    ex.add_argument("--fabric", default="xor",
                    help="CIN instance to lower onto (default: xor)")
    ex.add_argument("--n", type=int, default=None,
                    help="fabric switch count (default: --devices)")
    ex.add_argument("--bytes-per-packet", type=int, default=8192,
                    help="simulated link payload per cycle")
    ex.add_argument("--lenient", action="store_true",
                    help="skip (rather than fail on) collectives whose "
                         "group size mismatches the fabric")
    ex.add_argument("--name", default=None)
    ex.add_argument("-o", "--out", default=None,
                    help="output path (default: "
                         "<step><devices>.workload.json)")
    ex.add_argument("--device", default="cuda",
                    help="where the step runs (default: cuda; 'cpu' runs "
                         "it on the CPU)")
    ex.set_defaults(fn=cmd_extract)

    rp = sub.add_parser("replay",
                        help="replay a workload JSON on the cycle engines")
    rp.add_argument("workload", help="workload JSON (Workload.to_dict)")
    rp.add_argument("--fabric", default="xor")
    rp.add_argument("--n", type=int, default=None,
                    help="fabric switch count (default: the workload's)")
    rp.add_argument("--routing", default="minimal")
    rp.add_argument("--backend", default="both",
                    choices=["numpy", "torch", "both"])
    rp.add_argument("--device", default="cuda",
                    help="where the torch engine runs (default: cuda; "
                         "'cpu' runs the same step eagerly)")
    rp.set_defaults(fn=cmd_replay)

    sl = sub.add_parser("slo", help="SLO capacity search on a serving spec")
    sl.add_argument("spec", help="spec file path or bundled spec name")
    sl.add_argument("--experiment", default=None,
                    help="experiment name (required unless the spec holds "
                         "exactly one)")
    sl.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="where probes run (default auto: the torch "
                         "engine, the flow model on 1024+ switches)")
    sl.add_argument("--device", default="cuda",
                    help="where the torch engine and the flow solver run "
                         "(default: cuda)")
    sl.add_argument("--percentile", type=float, default=99.0)
    sl.add_argument("--lo", type=float, default=0.05)
    sl.add_argument("--hi", type=float, default=2.0)
    sl.add_argument("--tol", type=float, default=0.01)
    sl.set_defaults(fn=cmd_slo)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
