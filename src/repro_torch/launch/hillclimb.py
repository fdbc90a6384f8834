"""Perf hill climb: re-trace the three selected cells with one change at a
time and record their roofline terms before and after.

Port of ``repro.launch.hillclimb``: the same cells, tags, ``extra_cfg``
and mesh relabels, each run through :func:`repro_torch.launch.dryrun.
run_cell`::

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell qwen|xlstm|gemma]

Records land in ``results/hillclimb_torch/*.json``.

In the port ``attn_skip_diagonal`` and ``attn_banded`` reach only
:mod:`repro_torch.launch.analytic`: the model computes the same attention
with or without them (the reference's two knobs skip only masked blocks,
so its outputs do not change either), and the kernels skip masked tiles
on their own.  So the ``it1_diag`` and ``it2_banded`` climbs move the
analytic terms (``roofline.exec_gflops_per_dev`` and what follows from
it) and leave the traced step, its FLOPs, bytes and collectives, as the
base cell's.  ``remat`` and ``capacity_factor`` change the traced step
too.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.launch.dryrun import run_cell

OUT = Path("results/hillclimb_torch")


def climb_qwen():
    """qwen3-moe train_4k 16x16 — the paper-representative EP cell."""
    run_cell("qwen3-moe-30b-a3b", "train_4k", False, OUT, tag="base")
    # it1: skip above-diagonal KV blocks in causal attention
    run_cell("qwen3-moe-30b-a3b", "train_4k", False, OUT, tag="it1_diag",
             extra_cfg={"attn_skip_diagonal": True})
    # it2: + relax remat full -> dots (4x -> 3x fwd FLOPs, more live acts)
    run_cell("qwen3-moe-30b-a3b", "train_4k", False, OUT, tag="it2_remat",
             extra_cfg={"attn_skip_diagonal": True, "remat": "dots"})
    # it3: + capacity factor 1.25 -> 1.0 (EP dispatch waste)
    run_cell("qwen3-moe-30b-a3b", "train_4k", False, OUT, tag="it3_cf1",
             extra_cfg={"attn_skip_diagonal": True, "remat": "dots",
                        "capacity_factor": 1.0})


def climb_xlstm():
    """xlstm-350m train_4k on 512 chips — most collective-bound cell."""
    run_cell("xlstm-350m", "train_4k", True, OUT, tag="base")
    # it1: re-label the 512-chip fabric (2,64,4): TP = 4 mLSTM heads,
    # DP widens 32 -> 128
    run_cell("xlstm-350m", "train_4k", True, OUT, tag="it1_mesh2x64x4",
             mesh_shape=(2, 64, 4), mesh_axes=("pod", "data", "model"))
    # it2: relabel (2,128,2)
    run_cell("xlstm-350m", "train_4k", True, OUT, tag="it2_mesh2x128x2",
             mesh_shape=(2, 128, 2), mesh_axes=("pod", "data", "model"))


def climb_gemma():
    """gemma3-1b prefill_32k 16x16 — worst winnable roofline fraction."""
    run_cell("gemma3-1b", "prefill_32k", False, OUT, tag="base")
    # it1: diagonal skipping only (global layers halve)
    run_cell("gemma3-1b", "prefill_32k", False, OUT, tag="it1_diag",
             extra_cfg={"attn_skip_diagonal": True})
    # it2: + window banding (22 local layers: 32k -> ~1.5k effective keys)
    run_cell("gemma3-1b", "prefill_32k", False, OUT, tag="it2_banded",
             extra_cfg={"attn_skip_diagonal": True, "attn_banded": True})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=["qwen", "xlstm", "gemma", "all"],
                    default="all")
    args = ap.parse_args(argv)
    if args.cell in ("qwen", "all"):
        climb_qwen()
    if args.cell in ("xlstm", "all"):
        climb_xlstm()
    if args.cell in ("gemma", "all"):
        climb_gemma()


if __name__ == "__main__":
    main()
