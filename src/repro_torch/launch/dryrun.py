"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production meshes on fake tensors, and take its memory, collectives and
roofline terms.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step for 256 or 512 forced host devices and reads XLA's memory and
cost analyses and its HLO.  The port has no compiler to ask, so it runs
the step once, as rank 0 of a ``"fake"`` process group of the mesh's
world (``workload.extract.recording_group``), on fake tensors
(``torch._subclasses.fake_tensor``: shapes and dtypes, no data, nothing
allocated or launched), and records what the step dispatches::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 8

One JSON per cell under ``--out`` (default ``results/dryrun_torch/``, so
that the two packages' records never overwrite each other), with the
reference's cell ids, skip records and error records.

How each cell is built (:func:`lower_cell`): the state from
``models.transformer.param_shapes`` (``torch.empty``, no generator),
AdamW's zeros beside it for a train cell, placed by
``runtime.sharding.state_specs`` (``param_specs`` to serve) with
``shard_tree`` before anything is recorded, since the reference's state
arrives sharded; the inputs from ``launch.specs.input_specs``.  A train
cell runs ``make_train_step`` with ``suggest_grad_accum``'s microbatches
and ``grad_accum_specs``, on the global batch, which the sharded step
takes on every rank.  Prefill and decode run ``sharding.working_copy``
(the gathers the reference's program holds) and ``make_serve_steps`` on
this rank's dp rows of the batch (all of it where the batch does not
divide over dp, as the reference's shardings do), decode on the
head-local caches of ``init_caches(rules=)`` (ROADMAP C26, C27), full to
the last slot.

What :func:`analyse` reads, under one fake mode:

* ``collectives``: :func:`~repro_torch.launch.hlo_analysis.
  record_step_collectives` (every collective dispatched, DTensor's
  gathers included), through the reference's wire-byte table;
* ``roofline``: ``launch.analytic.cell_cost``'s executed FLOPs and HBM
  bytes, the wire bytes above, ``cost_flops`` (``FlopCounterMode``'s
  total, matmul-like ops on every call, plus the operations of the
  kernel calls the wrappers tallied: ROADMAP C28) and ``cost_bytes`` (the
  input and output bytes of every dispatched op);
* ``memory``: ``argument_bytes`` this rank's state shards (to serve:
  the parameters cast to the compute dtype, as serving holds them), batch
  and caches; ``alias_bytes`` what the step updates in place (the state, the
  attention caches: the counterpart of donation); ``output_bytes`` the
  step's outputs; ``temp_bytes`` the peak of the live storages less the
  arguments, from a dispatch mode that holds a weak reference to each
  storage an op returns, the arguments' from the start (torch's
  ``MemTracker`` counts fake storages too, but from nothing, and this
  mode also sums each op's bytes and holds the time limit);
  ``peak_estimate_bytes`` as the reference sums them.

Keys renamed where the port has no counterpart: ``fits_16gb_hbm`` is
``fits_hbm``, beside ``hbm_bytes`` (80e9: NVIDIA H100 80GB HBM3);
``lower_s`` and ``compile_s`` are ``trace_s`` (the wall seconds of
building and tracing the cell, on the host).  New keys: ``kernel_calls``,
the kernel wrappers' calls by path (``{path: {"calls", "operations",
"bytes"}}``), ``flop_counter_flops`` (``FlopCounterMode``'s total alone),
``traced_ops`` (the ops dispatched) and ``device``, the fake tensors'
device.  On ``"cuda"`` the
wrappers take their shape-only branch (``plan()`` at the H100's SMs);
on ``"cpu"`` the plain versions are traced in their place.  A torch built
without CUDA cannot give fake CUDA tensors views or autograd, so there
the default device is ``"cpu"``.

Nothing runs at import: the reference's import-time ``XLA_FLAGS`` has no
counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_scan as _ms
from repro_torch.launch import analytic
from repro_torch.launch.hlo_analysis import (collective_stats,
                                             record_step_collectives,
                                             roofline)
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.specs import input_specs
from repro_torch.models import get_config
from repro_torch.models.config import SHAPES, ShapeConfig, cell_is_applicable
from repro_torch.models.transformer import (cast_params, init_caches,
                                            param_shapes)
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime.sharding import (grad_accum_specs, param_specs,
                                          shard_tree, state_specs,
                                          working_copy)
from repro_torch.runtime.trainer import (make_rules, make_serve_steps,
                                         make_train_step, suggest_grad_accum)

ASSIGNED_ARCHS = ["xlstm-350m", "hymba-1.5b", "nemotron-4-15b",
                  "starcoder2-3b", "llama3.2-3b", "gemma3-1b",
                  "internvl2-26b", "qwen3-moe-30b-a3b",
                  "granite-moe-3b-a800m", "whisper-base"]
ASSIGNED_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

#: Device memory a card holds: NVIDIA H100 80GB HBM3, 700 W.
HBM_BYTES = 80e9
OUT = "results/dryrun_torch"
#: ``tensor.device`` under a dispatch mode: neither counted nor tracked.
_DEVICE = torch.ops.prim.device.default


def default_device() -> str:
    """``"cuda"`` where torch is built with CUDA (the fake tensors need
    its device guard for views and autograd, not a card), else ``"cpu"``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _bytes(tree) -> int:
    """Bytes of the local tensors of ``tree`` (a DTensor: its shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class Lowered:
    """One cell's step, built and ready to trace: ``run()`` runs it once
    under ``mode`` (the cell's fake mode) and returns its outputs;
    ``args`` are its arguments (this rank's), ``aliased`` the tensors it
    updates in place."""
    mode: object
    run: object
    args: object
    aliased: object


def _empty_like_meta(tree, device):
    return tree_map(lambda _, m: torch.empty(m.shape, dtype=m.dtype,
                                             device=device), tree)


def _dp_rows(batch: int, rules) -> int:
    """This rank's rows of a serving batch: its dp share where the batch
    divides over dp, else all of it (the reference's shardings)."""
    dp = rules.dp_size
    return batch // dp if dp > 1 and batch >= dp and batch % dp == 0 \
        else batch


def make_mesh(shape, names, device) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the current process group on
    ``device``'s type (the counterpart of the reference's
    ``make_auto_mesh``); a CUDA mesh needs no card over the fake group."""
    return DeviceMesh(torch.device(device).type,
                      torch.arange(math.prod(shape)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def lower_cell(arch: str, shape_name, mesh, *, extra_cfg: dict | None = None,
               device=None):
    """Build one cell's step on fake tensors on ``device`` (default
    :func:`default_device`); returns ``(cfg, shape, lowered, meta)`` as the
    reference's does, ``lowered`` a :class:`Lowered`.  ``shape_name``: a
    key of ``SHAPES`` or a ``ShapeConfig``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = device or default_device()
    cfg = get_config(arch)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    rules = make_rules(mesh)
    axes = {n: int(mesh.size(i)) for i, n in enumerate(mesh.mesh_dim_names)}
    meta = {"arch": arch, "shape": shape.name, "mesh": axes,
            "chips": math.prod(axes.values()), "device": str(device)}
    specs = input_specs(cfg, shape)
    mode = FakeTensorMode()
    with mode:
        params = _empty_like_meta(param_shapes(cfg), device)
        if shape.kind == "train":
            ga = suggest_grad_accum(cfg, shape.global_batch, shape.seq_len,
                                    rules.dp_size)
            meta["grad_accum"] = ga
            state = {"params": params, "opt": init_opt_state(params),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            state = shard_tree(state, state_specs(params, cfg, rules), mesh)
            del params
            step = make_train_step(
                cfg, rules, OptConfig(), grad_accum=ga,
                grad_specs=grad_accum_specs(state["params"], cfg, rules))
            batch = _empty_like_meta(specs, device)
            return cfg, shape, Lowered(
                mode, lambda: step(state, batch), (state, batch),
                (state["params"], state["opt"]["m"], state["opt"]["v"])), meta
        # serving holds the parameters cast once to the compute dtype
        # (models.cast_params), where the reference's program casts its
        # fp32 store at use
        params = cast_params(params, cfg)
        placed = shard_tree(params, param_specs(params, cfg, rules), mesh)
        del params
        rows = _dp_rows(shape.global_batch, rules)
        prefill_fn, decode_fn = make_serve_steps(cfg, rules, shape.seq_len)
        if shape.kind == "prefill":
            batch = {k: torch.empty((rows,) + tuple(m.shape[1:]),
                                    dtype=m.dtype, device=device)
                     for k, m in specs.items()}
            return cfg, shape, Lowered(
                mode, lambda: prefill_fn(working_copy(placed, cfg, rules),
                                         batch),
                (placed, batch), ()), meta
        tokens = torch.empty((rows, 1), dtype=torch.int32, device=device)
        caches = init_caches(cfg, rows, shape.seq_len, device=device,
                             rules=rules)
        pos = shape.seq_len - 1
        return cfg, shape, Lowered(
            mode, lambda: decode_fn(working_copy(placed, cfg, rules), tokens,
                                    caches, pos),
            (placed, tokens, caches),
            [c[k] for c in caches for k in ("k", "v") if k in c]), meta


class TraceTimeout(Exception):
    """A cell's trace ran past its time limit (``run_cell(timeout=)``)."""


class _Tracker(TorchDispatchMode):
    """Live bytes of the storages the step's ops return (each held by a
    weak reference, freed when its storage dies) above the arguments',
    with their peak, and the input and output bytes of every op; past
    ``deadline`` (``time.monotonic()``) every op raises
    :class:`TraceTimeout`."""

    def __init__(self, args, deadline: float | None = None):
        super().__init__()
        self.deadline = deadline
        self.live: dict = {}
        self.now = self.peak = self.io_bytes = self.calls = 0
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(_local(t))
        self.arguments = self.now

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.now += n
        self.peak = max(self.peak, self.now)
        self.live[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(
            k, n))

    def _free(self, key, n) -> None:
        if self.live.pop(key, None) is not None:
            self.now -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is _DEVICE:
            return out
        self.calls += 1
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise TraceTimeout("the trace ran past its time limit")
        outs = [_local(t) for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.io_bytes += _bytes((args, kwargs)) + _bytes(outs)
        for t in outs:
            self._hold(t)
        return out


def _kernel_tally(calls) -> dict:
    out: dict = {}
    for path, ops, nbytes in calls:
        row = out.setdefault(path, {"calls": 0, "operations": 0, "bytes": 0})
        row["calls"] += 1
        row["operations"] += ops
        row["bytes"] += nbytes
    return out


#: The tracker of the step being traced, for the ops a stopped trace got to.
_tracing: _Tracker | None = None


def analyse(cfg, shape, lowered: Lowered, meta, *, analytic_kw=None,
            deadline: float | None = None) -> dict:
    """Run the step once under the recorders; the reference's record (the
    module docstring says how each field is read).  ``deadline``
    (``time.monotonic()``): stop the trace there (:class:`TraceTimeout`)."""
    global _tracing
    from torch.utils.flop_counter import FlopCounterMode
    chips = meta["chips"]
    calls: list = []
    with lowered.mode:
        tracker = _tracing = _Tracker(lowered.args, deadline)
        flops = FlopCounterMode(display=False)
        _fa.traced_calls = _ms.traced_calls = calls
        try:
            with flops, tracker, record_step_collectives() as ops:
                out = lowered.run()
        finally:
            _fa.traced_calls = _ms.traced_calls = None
        output_bytes = _bytes(out)
        del out
    alias = _bytes(lowered.aliased)
    coll = collective_stats(ops)
    kernels = _kernel_tally(calls)
    cost = analytic.cell_cost(cfg, shape, chips, **(analytic_kw or {}))
    rt = roofline(
        exec_flops_per_dev=cost.exec_flops_total / chips,
        hbm_bytes_per_dev=cost.hbm_bytes_per_dev,
        wire_bytes_per_dev=coll.total_wire_bytes,
        chips=chips,
        model_flops_total=cost.model_flops_total,
        cost_flops=float(flops.get_total_flops()
                         + sum(k["operations"] for k in kernels.values())),
        cost_bytes=float(tracker.io_bytes))
    mem = {
        "argument_bytes": tracker.arguments,
        "output_bytes": output_bytes,
        "temp_bytes": tracker.peak - tracker.arguments,
        "alias_bytes": alias,
        "peak_estimate_bytes": (tracker.arguments + output_bytes
                                + tracker.peak - tracker.arguments - alias),
    }
    return {**meta,
            "ok": True,
            "memory": mem,
            "fits_hbm": mem["peak_estimate_bytes"] < HBM_BYTES,
            "hbm_bytes": HBM_BYTES,
            "collectives": {
                "counts": coll.counts,
                "raw_gbytes": {k: v / 1e9 for k, v in coll.raw_bytes.items()},
                "wire_gbytes": {k: v / 1e9
                                for k, v in coll.wire_bytes.items()},
                "total_wire_gbytes_per_dev": coll.total_wire_bytes / 1e9,
            },
            "analytic_notes": cost.notes,
            "roofline": rt.as_dict(),
            "kernel_calls": kernels,
            "flop_counter_flops": flops.get_total_flops(),
            "traced_ops": tracker.calls}


def run_cell(arch: str, shape_name, multi_pod: bool, out_dir: Path,
             *, extra_cfg=None, analytic_kw=None, tag: str = "",
             mesh_shape=None, mesh_axes=None, device=None,
             timeout: int = 0) -> dict:
    """One cell, recorded under ``out_dir`` as ``<cell id>.json`` (the
    reference's ids).  ``mesh_shape``/``mesh_axes``: the same chips under
    other axes (a sharding decision; the fabric is unchanged).  The
    cell's process group, the fake group at the mesh's world, is opened
    here and closed before it returns; this process must hold no other.
    ``timeout`` (seconds, 0 for none): a trace that runs longer is stopped
    at its next dispatched op, in whatever thread (the autograd engine's
    too), and recorded as an error with the ops it had traced
    (``traced_ops``)."""
    from repro_torch.workload.extract import recording_group
    shape_label = getattr(shape_name, "name", shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh_shape:
        mesh_name = "x".join(str(s) for s in mesh_shape)
    cell_id = (f"{arch}__{shape_label}__{mesh_name}"
               + (f"__{tag}" if tag else ""))
    ok, reason = cell_is_applicable(arch, shape_label)
    if not ok:
        rec = {"arch": arch, "shape": shape_label, "mesh": mesh_name,
               "ok": False, "skipped": True, "reason": reason}
        _write(out_dir, cell_id, rec)
        print(f"[skip] {cell_id}: {reason}", flush=True)
        return rec
    global _tracing
    device = device or default_device()
    _tracing = None
    t0 = time.time()
    deadline = time.monotonic() + timeout if timeout else None
    try:
        if mesh_shape:
            shape, names = tuple(mesh_shape), tuple(mesh_axes)
        else:
            prod = production_mesh_shape(multi_pod=multi_pod)
            shape, names = tuple(prod.shape.values()), prod.mesh_dim_names
        with recording_group(math.prod(shape)):
            mesh = make_mesh(shape, names, device)
            cfg, shape_cfg, lowered, meta = lower_cell(
                arch, shape_name, mesh, extra_cfg=extra_cfg, device=device)
            rec = analyse(cfg, shape_cfg, lowered, meta,
                          analytic_kw=analytic_kw, deadline=deadline)
            del lowered
        rec["trace_s"] = round(time.time() - t0, 1)
        _write(out_dir, cell_id, rec)
        r = rec["roofline"]
        print(f"[ok]   {cell_id}: trace={rec['trace_s']:.0f}s "
              f"dominant={r['dominant']} "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"collective={r['collective_s']*1e3:.2f}ms "
              f"peak={rec['memory']['peak_estimate_bytes']/1e9:.2f}GB",
              flush=True)
        return rec
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec = {"arch": arch, "shape": shape_label, "mesh": mesh_name,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:],
               "trace_s": round(time.time() - t0, 1)}
        if _tracing is not None:
            rec["traced_ops"] = _tracing.calls
        _write(out_dir, cell_id, rec)
        print(f"[FAIL] {cell_id}: {type(e).__name__}: {str(e)[:300]}",
              flush=True)
        return rec


def _write(out_dir: Path, cell_id: str, rec: dict):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=1,
                                                        default=str))


def _run_in_process(arch, shape, multi, out_dir, timeout) -> dict:
    """One cell as ``python -m repro_torch.launch.dryrun`` in a process of
    its own (each holds its own process group); its record read back."""
    mesh = "multi" if multi else "single"
    name = "pod2x16x16" if multi else "pod16x16"
    cell_id = f"{arch}__{shape}__{name}"
    path = Path(out_dir) / f"{cell_id}.json"
    path.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out_dir),
           "--cell-timeout", str(timeout)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout, end="", flush=True)
    if path.exists():
        return json.loads(path.read_text())
    rec = {"arch": arch, "shape": shape, "mesh": name, "ok": False,
           "error": f"the cell's process exited {proc.returncode}",
           "traceback": proc.stderr[-4000:]}
    _write(out_dir, cell_id, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (default 1: one after another, here)")
    ap.add_argument("--cell-timeout", type=int, default=0,
                    help="seconds a cell's trace may take before it is "
                         "stopped and recorded as an error (0: no limit)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in ASSIGNED_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    todo = [(arch, shape, multi) for multi in meshes for arch, shape in cells]
    if args.jobs > 1:
        with ThreadPoolExecutor(args.jobs) as pool:
            recs = list(pool.map(lambda c: _run_in_process(
                *c, out_dir, args.cell_timeout), todo))
    else:
        recs = [run_cell(arch, shape, multi, out_dir,
                         timeout=args.cell_timeout)
                for arch, shape, multi in todo]
    n_fail = sum(1 for rec in recs
                 if not rec.get("ok") and not rec.get("skipped"))
    print(f"done; failures: {n_fail}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
