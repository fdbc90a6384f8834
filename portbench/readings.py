"""Readings that the output check's limits are set from (not run by the
benchmark's own runs).

    python portbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed, in one process on the card: the program's first steps
against the float32 reference (a sound run: the lower reading); for each
control seed the reference in fp8 against it (the control: the upper
reading); for each fault seed the program with half of each batch left
out (a planted fault).  One JSON line each: the seed, what ran and the
numbers of ``check.py``.  A step that returns its state unchanged
reads 1 on two numbers by their definition and needs no run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch
    from portbench import check, harness
    from portbench.traffic import train as TR

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    cell = harness.find_cell(args.workload)
    device = torch.device(args.device)
    sizes = harness.model_sizes(cell.config, cell.mix["seq"])
    out = open(args.out, "a") if args.out else None
    todo = sorted(set(seeds(args.seeds) + seeds(args.control_seeds)
                      + seeds(args.fault_seeds)))
    for seed in todo:
        first = [TR.make_batch(cell.mix, sizes["vocab_size"], seed, i)
                 for i in range(cell.mix["reference_steps"])]
        t0 = time.perf_counter()
        want = TR.reference_readings(cell, sizes, seed, device, first)
        runs = []
        if seed in seeds(args.seeds):
            runs.append(("sound", None))
        if seed in seeds(args.fault_seeds):
            runs.append(("half_batch", "half_batch"))
        for what, fault in runs:
            prog = TR.run_program(cell, sizes, seed, device, first, fault)
            got = prog.readings
            del prog
            TR.free(device)
            emit(out, args.workload, seed, what, check.gaps(got, want),
                 got["losses"], want["losses"])
        if seed in seeds(args.control_seeds):
            got = TR.reference_readings(cell, sizes, seed, device, first,
                                        precision="fp8")
            emit(out, args.workload, seed, "control_fp8",
                 check.gaps(got, want), got["losses"], want["losses"])
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    return 0


def emit(out, cell, seed, what, numbers, losses, ref_losses):
    line = json.dumps({"cell": cell, "seed": seed, "run": what, **numbers,
                       "losses": losses, "reference_losses": ref_losses})
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


if __name__ == "__main__":
    sys.exit(main())
