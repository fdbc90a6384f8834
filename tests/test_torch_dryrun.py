"""The dry run and its analysis (``repro_torch.launch.{hlo_analysis,dryrun,
hillclimb}``) against ``repro.launch``'s, on the CPU.

* ``roofline`` equals the reference's once the reference module's three
  constants are the port's (the card's); ``collective_stats`` of the ops
  the reference reads from HLO (``collective_sequence``) equals the
  reference's ``collective_stats`` of the same HLO.
* ``record_step_collectives`` (a dispatch mode) equals
  ``record_collectives`` on ``workload.extract``'s dp and MoE steps at
  world 4; on a reduced sharded train step it also sees DTensor's gathers,
  which ``record_collectives`` misses; and that step's ops on fake tensors
  (rank 0 of the ``"fake"`` group) equal a real run's on 4 gloo ranks, as
  a multiset of (kind, bytes, group size).  The gloo ranks gather through
  ``DTensor.redistribute``, as the dry run traces it (``sharding.gathered``
  all-reduces only over gloo, where the card cannot all-gather: C9).
* Reduced cells (gemma3-1b reduced: a train cell of B8 T64 and prefill and
  decode cells of B4 T64, on a (2, 2) mesh) through ``run_cell`` in a
  process of its own (the process group is the process's): the record
  has the reference's keys less the renamed ones; the analytic and
  roofline terms are the reference's ``cell_cost`` and ``roofline``; the
  arguments are the shards ``state_specs`` gives and the global batch; a
  ``long_500k`` llama cell is the reference's skip record.  A second
  process lowers the same train cell through the reference's
  ``lower_cell``/``analyse`` on 4 forced host devices: its
  ``argument_bytes`` equal the port's less the batch rows of the other dp
  rank (the port's sharded step takes the global batch on every rank,
  ROADMAP C28).
* The kernels' shape-only branch on fake CUDA tensors: ``plan()``'s path,
  outputs of the right shapes, the work tallied, nothing launched.  (A
  torch built without CUDA cannot give fake CUDA tensors views or
  autograd, so the cells here trace on fake CPU tensors, the kernels'
  plain versions in their place; ``chip_smoke.py`` traces on the card's
  host.)
* The hill climbs make the reference's calls and cell ids, and
  ``it1_diag`` leaves the traced step's FLOPs as they were while the
  analytic FLOPs drop.

The reference's ``dryrun`` and ``hillclimb`` set ``XLA_FLAGS`` when they
are imported, so they are imported only in child processes with an
explicit environment.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch import analytic as RA
from repro.launch import hlo_analysis as RH
from repro.models import get_config as r_get_config
from repro.models.config import ShapeConfig as R_Shape

from repro_torch.core.collectives import CollectiveOp
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import ops
from repro_torch.launch import hillclimb as HC
from repro_torch.launch import hlo_analysis as TH
from repro_torch.workload import extract as TE

from test_workload import _SYNTH_HLO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 240

ARCH = "gemma3-1b"
SHAPES = {"train": ("train_tiny", 64, 8, "train"),
          "prefill": ("prefill_tiny", 64, 4, "prefill"),
          "decode": ("decode_tiny", 64, 4, "decode")}
MESH = ((2, 2), ("data", "model"))
#: The reference's keys the port renames, and the port's new ones.
RENAMED = {"fits_16gb_hbm", "lower_s", "compile_s"}
NEW = {"fits_hbm", "hbm_bytes", "trace_s", "kernel_calls",
       "flop_counter_flops", "traced_ops", "device"}


def _extra():
    """The reduced config as ``extra_cfg`` over the published one (the
    same fields on both packages' configs)."""
    full = r_get_config(ARCH)
    red = full.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _env(**more):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(more)
    return env


def _start(script, *argv, env=None):
    return subprocess.Popen([sys.executable, "-c", script, *map(str, argv)],
                            env=env or _env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _join(proc, timeout=TIMEOUT_S) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return out


# The port's cells, each traced by run_cell as rank 0 of the fake group;
# then the reduced train step's ops through both recorders.
_PORT = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import torch
    from repro_torch.core.collectives import record_collectives
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_analysis import record_step_collectives
    from repro_torch.models import get_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import param_shapes
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.trainer import make_rules
    from repro_torch.workload.extract import recording_group
    torch.set_num_threads(1)
    a = json.loads(sys.argv[1])
    out = Path(sys.argv[2])
    mesh_shape, mesh_axes = a["mesh"]
    recs = {}
    for name, (shape, extra) in a["cells"].items():
        recs[name] = D.run_cell(a["arch"], ShapeConfig(*shape), False, out,
                                extra_cfg=extra, mesh_shape=mesh_shape,
                                mesh_axes=mesh_axes, device="cpu")
    recs["long"] = D.run_cell("llama3.2-3b", "long_500k", False, out,
                              device="cpu")
    # a trace past its time limit: hymba's SSM loops over 512 positions
    recs["late"] = D.run_cell(
        "hymba-1.5b", ShapeConfig("prefill_late", 512, 4, "prefill"), False,
        out, extra_cfg=a["hymba"], mesh_shape=mesh_shape,
        mesh_axes=mesh_axes, device="cpu", timeout=1)
    cfg = get_config(a["arch"])
    import dataclasses
    cfg = dataclasses.replace(cfg, **a["cells"]["train"][1])
    shape = ShapeConfig(*a["cells"]["train"][0])
    with recording_group(4):
        mesh = D.make_mesh(mesh_shape, mesh_axes, "cpu")
        # the shards state_specs gives, by arithmetic on the specs
        params = param_shapes(cfg)
        state = {"params": params, "opt": {"m": params, "v": params,
                                           "step": torch.zeros((), dtype=torch.int32, device="meta")},
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        specs = SH.state_specs(params, cfg, make_rules(mesh))
        shards = []
        SH.spec_map(lambda _, leaf, spec: shards.append(
            torch.Size([r.stop - r.start for r in SH.local_region(
                tuple(leaf.shape), SH.placements(spec, mesh), mesh)]).numel()
            * leaf.element_size()), state, specs)
        recs["state_shard_bytes"] = sum(shards)
        _, _, lowered, _ = D.lower_cell(a["arch"], shape, mesh,
                                        extra_cfg=a["cells"]["train"][1],
                                        device="cpu")
        missed = None
        with lowered.mode:
            try:
                with record_collectives() as posted, \\
                        record_step_collectives() as dispatched:
                    lowered.run()
            except RuntimeError as e:    # a posted call it did not record
                missed = str(e)
    recs["ops"] = {"dispatched": [[o.kind, o.raw_bytes, o.group_size]
                                  for o in dispatched],
                   "posted": [[o.kind, o.raw_bytes, o.group_size]
                              for o in posted], "missed": missed}
    (out / "records.json").write_text(json.dumps(recs, default=str))
""")

# One gloo rank of the same reduced sharded train step on real tensors.
_GLOO = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch.hlo_analysis import record_step_collectives
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import get_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import trainer as TR
    from repro_torch.runtime.trainer import suggest_grad_accum
    from repro_torch.launch.dryrun import make_mesh
    torch.set_num_threads(1)
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    a = json.loads(sys.argv[5])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    # gather through DTensor.redistribute, as the dry run traces it
    SH.gathered = lambda leaf, target: leaf.redistribute(
        leaf.device_mesh, target).to_local()
    import dataclasses
    cfg = dataclasses.replace(get_config(a["arch"]), **a["cells"]["train"][1])
    shape = ShapeConfig(*a["cells"]["train"][0])
    mesh = make_mesh(*a["mesh"], "cpu")
    rules = TR.make_rules(mesh)
    full = TR.init_train_state(0, cfg, device="cpu")
    state = SH.shard_tree(full, SH.state_specs(full["params"], cfg, rules),
                          mesh)
    ga = suggest_grad_accum(cfg, shape.global_batch, shape.seq_len,
                            rules.dp_size)
    step = TR.make_train_step(cfg, rules, OptConfig(), grad_accum=ga,
                              grad_specs=SH.grad_accum_specs(
                                  state["params"], cfg, rules))
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, m.shape, generator=g,
                              dtype=m.dtype)
             for k, m in input_specs(cfg, shape).items()}
    with record_step_collectives() as ops:
        step(state, batch)
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{outdir}/ops_{rank}.json", "w") as f:
        json.dump([[o.kind, o.raw_bytes, o.group_size] for o in ops], f)
""")

# The reference's dry run of the same train cell on 4 forced host devices.
_REFERENCE = textwrap.dedent("""
    import json, sys
    from repro.models import SHAPES
    from repro.models.config import ShapeConfig
    from repro.launch import dryrun as RD
    from repro._compat.jaxapi import make_auto_mesh
    a = json.loads(sys.argv[1])
    shape, extra = a["cells"]["train"]
    SHAPES[shape[0]] = ShapeConfig(*shape)
    mesh = make_auto_mesh(*a["mesh"])
    cfg, sh, lowered, meta = RD.lower_cell(a["arch"], shape[0], mesh,
                                           extra_cfg=extra)
    rec = RD.analyse(cfg, sh, lowered.compile(), meta)
    rec["lower_s"] = rec["compile_s"] = 0.0
    print(json.dumps(rec, default=str))
""")

# The reference's hill climbs with run_cell recording its calls and every
# cell a skip record (nothing lowered).
_CLIMBS = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import repro.launch.dryrun as RD
    import repro.launch.hillclimb as HC
    RD.cell_is_applicable = lambda arch, shape: (False, "not lowered")
    calls = []
    run = HC.run_cell
    def record(*args, **kw):
        calls.append([list(args[:3]), {k: v for k, v in kw.items()}])
        return run(*args[:3], Path(sys.argv[1]), **kw)
    HC.run_cell = record
    HC.climb_qwen(); HC.climb_xlstm(); HC.climb_gemma()
    print(json.dumps(calls))
""")


def _args():
    extra = _extra()
    cells = {name: (list(shape), extra) for name, shape in SHAPES.items()}
    cells["prefill_diag"] = (list(SHAPES["prefill"]),
                             dict(extra, attn_skip_diagonal=True))
    full = r_get_config("hymba-1.5b")
    hymba = {f.name: getattr(full.reduced(), f.name)
             for f in dataclasses.fields(full)
             if getattr(full.reduced(), f.name) != getattr(full, f.name)}
    return {"arch": ARCH, "cells": cells, "hymba": hymba,
            "mesh": [list(MESH[0]), list(MESH[1])]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child process, started at once: the port's cells, 4 gloo
    ranks, the reference's cell and the reference's hill climbs."""
    tmp = tmp_path_factory.mktemp("dryrun")
    a = json.dumps(_args())
    port = _start(_PORT, a, tmp / "port")
    store = tmp / "store"
    gloo = [_start(_GLOO, r, 4, store, tmp, a) for r in range(4)]
    ref = _start(_REFERENCE, a, env=_env(
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    climbs = _start(_CLIMBS, tmp / "ref_climbs", env=_env(
        XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    _join(port)
    for p in gloo:
        _join(p)
    return {"port": json.loads((tmp / "port" / "records.json").read_text()),
            "gloo": [json.loads((tmp / f"ops_{r}.json").read_text())
                     for r in range(4)],
            "reference": json.loads(_join(ref).strip().splitlines()[-1]),
            "climbs": json.loads(_join(climbs).strip().splitlines()[-1]),
            "ref_climbs": tmp / "ref_climbs", "tmp": tmp}


# ---------------------------------------------------------------------------
# hlo_analysis: the roofline, the wire bytes, the dispatch recorder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(exec_flops_per_dev=3.2e12, hbm_bytes_per_dev=4.1e10,
         wire_bytes_per_dev=2.5e9, chips=256, model_flops_total=5e14),
    dict(exec_flops_per_dev=1e9, hbm_bytes_per_dev=8e10,
         wire_bytes_per_dev=1e6, chips=512, model_flops_total=4e11,
         cost_flops=7.0, cost_bytes=9.0),
    dict(exec_flops_per_dev=1e9, hbm_bytes_per_dev=1e6,
         wire_bytes_per_dev=9e12, chips=4, model_flops_total=0.0,
         links_per_chip=2),
])
def test_roofline_is_the_references_at_the_cards_constants(monkeypatch, kw):
    monkeypatch.setattr(RH, "PEAK_FLOPS", TH.PEAK_FLOPS)
    monkeypatch.setattr(RH, "HBM_BW", TH.HBM_BW)
    monkeypatch.setattr(RH, "ICI_BW", TH.LINK_BW)
    assert TH.roofline(**kw).as_dict() == RH.roofline(**kw).as_dict()
    assert (TH.PEAK_FLOPS, TH.HBM_BW, TH.LINK_BW) == (989e12, 3.35e12, 450e9)


_GROUPS_HLO = textwrap.dedent("""\
    HloModule groups

    ENTRY %main.1 (a: f32[1024], b: bf16[64,32]) -> f32[1024] {
      %ar = f32[1024] all-reduce(%a), replica_groups={{0,1,2,3}}, to_apply=%add
      %ag = bf16[256,32] all-gather(%b), replica_groups=[2,4]<=[8], dimensions={0}
      %rs = f32[256] reduce-scatter(%ar), replica_groups={{0,1},{2,3}}, dimensions={0}
      %aa = bf16[64,32] all-to-all(%b), replica_groups={{0,1,2,3}}, dimensions={0}
      %cp = f32[1024] collective-permute(%ar), source_target_pairs={{0,1},{1,0}}
      ROOT %out = f32[1024] add(%ar, %cp)
    }
""")


@pytest.mark.parametrize("hlo", [_SYNTH_HLO, _GROUPS_HLO],
                         ids=["synth", "groups"])
def test_collective_stats_of_the_ops_is_the_references(hlo):
    ops = [CollectiveOp(o.kind, o.raw_bytes, o.group_size, o.count, o.pairs)
           for o in RH.collective_sequence(hlo, 4)]
    got, want = TH.collective_stats(ops), RH.collective_stats(hlo, 4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_wire_bytes > 0


@pytest.mark.parametrize("step", ["dp", "moe"])
def test_dispatch_recorder_equals_record_collectives(step):
    """Both recorders on one run of extract's step at world 4 (rank 0 of
    the fake group): the same ops in the same order, pairs aside (a rank
    sees only its own peer)."""
    with TE.recording_group(4, 0):
        with TH.record_step_collectives() as dispatched:
            posted = TE.STEPS[step](4, device="cpu")
    assert [(o.kind, o.raw_bytes, o.group_size, o.count) for o in posted] == \
        [(o.kind, o.raw_bytes, o.group_size, o.count) for o in dispatched]
    assert len(posted) > 1


def test_dispatch_recorder_sees_what_record_collectives_misses(runs):
    """On the reduced sharded train step record_collectives records only
    the tensor-parallel layers' noted all-reduces, and raises at exit for
    the vocab-parallel max (``layers.py`` posts it straight to
    ``dist.all_reduce``); the dispatch recorder sees all of those, and
    DTensor's gathers, reductions and reduce-scatters."""
    got = runs["port"]["ops"]
    assert "'all_reduce'" in got["missed"]
    dispatched = collections.Counter(map(tuple, got["dispatched"]))
    posted = collections.Counter(map(tuple, got["posted"]))
    assert posted and not posted - dispatched
    missed = dispatched - posted
    assert {k for k, _, _ in missed} >= {"all-gather", "reduce-scatter"}


def test_fake_step_ops_equal_a_gloo_run(runs):
    """The reduced sharded train step on fake tensors as rank 0 of the
    fake group, and on 4 gloo ranks with data: the same ops (every gloo
    rank records the same)."""
    fake = collections.Counter(map(tuple, runs["port"]["ops"]["dispatched"]))
    for rank_ops in runs["gloo"]:
        assert collections.Counter(map(tuple, rank_ops)) == fake


def test_kernels_take_the_shape_only_branch_on_fake_cuda_tensors():
    """Fake CUDA tensors (no card): each wrapper runs its checks, returns
    outputs of the right shapes, tallies plan()'s path and work() at the
    H100's SMs, and loads and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    launches = (FA.launches, MS.launches)
    FA.traced_calls = MS.traced_calls = calls
    try:
        with FakeTensorMode():
            def t(*shape, dtype=torch.bfloat16):
                return torch.empty(shape, dtype=dtype, device="cuda")
            o, lse = ops.flash_attention(t(2, 64, 8, 64), t(2, 64, 2, 64),
                                         t(2, 64, 2, 64), return_lse=True)
            assert o.shape == (2, 64, 8, 64) and lse.shape == (2, 8, 64)
            ops.flash_attention(t(2, 1, 8, 128), t(2, 300, 2, 128),
                                t(2, 300, 2, 128),
                                q_pos=t(1, dtype=torch.int32),
                                kv_pos=t(300, dtype=torch.int32))
            ops.flash_attention(*(t(1, 32, 4, 256, dtype=torch.float32),) * 3)
            h, (c, n, m) = ops.mlstm_scan(*(t(1, 512, 2, 64),) * 3,
                                          t(1, 512, 2, dtype=torch.float32),
                                          t(1, 512, 2, dtype=torch.float32))
            assert h.shape == (1, 512, 2, 64) and c.shape == (1, 2, 64, 64)
            with pytest.raises(ValueError, match="head_dim"):
                ops.flash_attention(*(t(1, 32, 4, 48),) * 3)
    finally:
        FA.traced_calls = MS.traced_calls = None
    assert (FA.launches, MS.launches) == launches
    assert [c[0] for c in calls] == [
        FA.plan(2, 64, 64, 8, 2, 64, torch.bfloat16, lse=True).path,
        FA.plan(2, 1, 300, 8, 2, 128, torch.bfloat16).path,
        FA.plan(1, 32, 32, 4, 4, 256, torch.float32).path,
        MS.plan(1, 512, 2, 64, 256, torch.bfloat16).path]
    assert [c[0] for c in calls] == ["prefill", "decode", "fp32_tc", "tc"]
    # the decode call's queries taken as the last of its 300 positions:
    # every key visible, 4 operations a (pair, head, dim)
    assert calls[1][1] == 4 * 2 * 8 * 128 * 300
    assert calls[3][1] == MS.work(torch.empty(1, 512, 2, 64,
                                              dtype=torch.bfloat16), 256)[1]


# ---------------------------------------------------------------------------
# dryrun: the reduced cells against the reference.
# ---------------------------------------------------------------------------

def _r_cell(name):
    shape = SHAPES[name.removesuffix("_diag")]
    extra = _extra()
    if name.endswith("_diag"):
        extra["attn_skip_diagonal"] = True
    return (dataclasses.replace(r_get_config(ARCH), **extra),
            R_Shape(*shape))


@pytest.mark.parametrize("name", ["train", "prefill", "decode",
                                  "prefill_diag"])
def test_cell_records_the_references_terms(runs, name, monkeypatch):
    rec = runs["port"][name]
    assert rec["ok"], rec.get("traceback")
    ref_keys = set(runs["reference"])
    if name != "train":
        ref_keys -= {"grad_accum"}
    assert set(rec) - NEW == ref_keys - RENAMED
    assert set(rec["memory"]) == set(runs["reference"]["memory"])
    assert set(rec["collectives"]) == set(runs["reference"]["collectives"])
    assert rec["mesh"] == dict(zip(MESH[1], MESH[0])) and rec["chips"] == 4
    cfg, shape = _r_cell(name)
    cost = RA.cell_cost(cfg, shape, 4)
    assert rec["analytic_notes"] == cost.notes
    monkeypatch.setattr(RH, "PEAK_FLOPS", TH.PEAK_FLOPS)
    monkeypatch.setattr(RH, "HBM_BW", TH.HBM_BW)
    monkeypatch.setattr(RH, "ICI_BW", TH.LINK_BW)
    r = rec["roofline"]
    want = RH.roofline(
        exec_flops_per_dev=cost.exec_flops_total / 4,
        hbm_bytes_per_dev=cost.hbm_bytes_per_dev,
        wire_bytes_per_dev=rec["collectives"]["total_wire_gbytes_per_dev"]
        * 1e9, chips=4, model_flops_total=cost.model_flops_total,
        cost_flops=r["cost_analysis_flops"],
        cost_bytes=r["cost_analysis_bytes"]).as_dict()
    assert r.keys() == want.keys()
    for k, v in want.items():
        assert r[k] == pytest.approx(v, rel=1e-12, abs=0), k
    assert r["cost_analysis_flops"] == rec["flop_counter_flops"] > 0
    assert rec["fits_hbm"] and rec["kernel_calls"] == {}
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])


def test_train_cell_arguments_are_the_state_specs_shards(runs):
    """The state's shards by arithmetic on state_specs, and the global
    batch (tokens and labels, int32), which the sharded step takes."""
    rec = runs["port"]["train"]
    rows, seq = SHAPES["train"][2], SHAPES["train"][1]
    batch = 2 * rows * seq * 4
    assert rec["memory"]["argument_bytes"] == \
        runs["port"]["state_shard_bytes"] + batch
    # the parameters, m and v are updated in place: the alias
    assert 0 < rec["memory"]["alias_bytes"] < rec["memory"]["argument_bytes"]


def test_train_cell_arguments_against_the_references(runs):
    """The reference's argument bytes on 4 host devices are the port's
    less one dp rank's share of the batch: the reference's batch arrives
    sharded over "data", the port's sharded step takes the global batch
    on every rank (ROADMAP C28)."""
    rows, seq = SHAPES["train"][2], SHAPES["train"][1]
    dp = MESH[0][0]
    batch_global, batch_shard = 2 * rows * seq * 4, 2 * rows * seq * 4 // dp
    port = runs["port"]["train"]["memory"]["argument_bytes"]
    ref = runs["reference"]["memory"]["argument_bytes"]
    assert port - batch_global + batch_shard == ref
    assert runs["port"]["train"]["grad_accum"] == \
        runs["reference"]["grad_accum"]


def test_long_context_skip_is_the_references(runs):
    from repro.models.config import cell_is_applicable
    ok, reason = cell_is_applicable("llama3.2-3b", "long_500k")
    assert not ok
    assert runs["port"]["long"] == {
        "arch": "llama3.2-3b", "shape": "long_500k", "mesh": "pod16x16",
        "ok": False, "skipped": True, "reason": reason}


def test_a_trace_past_its_time_limit_is_an_error_record(runs):
    """``run_cell(timeout=)`` (``--cell-timeout``) stops a trace that runs
    longer and records an error with the ops it had traced."""
    rec = runs["port"]["late"]
    assert rec["ok"] is False and rec["error"].startswith("TraceTimeout")
    assert rec["traced_ops"] > 0 and rec["trace_s"] >= 1
    assert rec["mesh"] == "2x2" and rec["shape"] == "prefill_late"


# ---------------------------------------------------------------------------
# hillclimb.
# ---------------------------------------------------------------------------

def test_hill_climbs_make_the_references_calls_and_cells(runs, monkeypatch,
                                                         tmp_path):
    from repro_torch.launch import dryrun as D
    monkeypatch.setattr(D, "cell_is_applicable",
                        lambda arch, shape: (False, "not lowered"))
    calls = []

    def record(*args, **kw):
        calls.append([list(args[:3]), kw])
        return D.run_cell(*args[:3], tmp_path, **kw)
    monkeypatch.setattr(HC, "run_cell", record)
    HC.main(["--cell", "all"])

    def plain(c):
        return json.loads(json.dumps(c))
    assert plain(calls) == runs["climbs"]
    got = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    want = {p.name: json.loads(p.read_text())
            for p in runs["ref_climbs"].iterdir()}
    assert got == want and len(got) == 10
    assert str(HC.OUT) == "results/hillclimb_torch"


def test_diagonal_skip_moves_only_the_analytic_terms(runs):
    """``it1_diag``: the traced step is the same, its FLOPs, bytes and
    collectives; the analytic executed FLOPs drop."""
    base, diag = runs["port"]["prefill"], runs["port"]["prefill_diag"]
    assert diag["flop_counter_flops"] == base["flop_counter_flops"]
    assert diag["roofline"]["cost_analysis_bytes"] == \
        base["roofline"]["cost_analysis_bytes"]
    assert diag["collectives"] == base["collectives"]
    assert diag["roofline"]["exec_gflops_per_dev"] < \
        base["roofline"]["exec_gflops_per_dev"]


# ---------------------------------------------------------------------------
# work(): the bound arithmetic chip_smoke.py held before it moved.
# ---------------------------------------------------------------------------

def _attention_work_before(q, k, q_pos, kv_pos, causal, window):
    """chip_smoke.py's attention_work before it moved into
    kernels/flash_attention.py: the mask, its rows and pairs."""
    ok = (kv_pos[None, :] >= 0).expand(len(q_pos), -1)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    b, _, h, d = q.shape
    rows, pairs = int(ok.any(dim=0).sum()), int(ok.sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * rows * k.shape[2] * d * k.element_size()
              + 4 * (q_pos.numel() + kv_pos.numel()))
    return nbytes, 4 * b * h * d * pairs


def _mlstm_work_before(q, chunk, state):
    """chip_smoke.py's mlstm_bound arithmetic before it moved into
    kernels/mlstm_scan.py: (bytes, multiply-adds)."""
    b, t, h, d = q.shape
    nc = t // chunk
    pairs = chunk * (chunk + 1) // 2
    inter = (nc if state is not None else nc - 1) * chunk * (d * d + d)
    macs = b * h * (nc * (2 * pairs * d + chunk * (d * d + d)) + inter)
    nbytes = (4 * q.numel() * q.element_size() + 2 * b * t * h * 4
              + 4 * b * h * (d * d + d + 1)
              + (4 * b * h * (d * d + d + 1) if state is not None else 0))
    return nbytes, macs


@pytest.mark.parametrize("seed", range(4))
def test_work_is_the_bound_arithmetic_it_replaced(seed):
    """Every chip_smoke.py bound reads work(): equal to the arithmetic it
    held before, exactly, on random shapes, positions (aligned, the last T,
    one position, masked keys) and windows; positions without data (fake
    tensors) count as the queries at the last T of S positions."""
    import random
    from torch._subclasses.fake_tensor import FakeTensorMode
    rng = random.Random(seed)
    for _ in range(40):
        b, kvh = rng.choice([1, 2, 4]), rng.choice([1, 2, 8])
        g, d = rng.choice([1, 3, 5, 12]), rng.choice([16, 64, 256])
        dtype = rng.choice([torch.bfloat16, torch.float32])
        s = rng.choice([1, 17, 64, 300, 1500])
        t = min(s, rng.choice([1, 5, 16, s, rng.randint(1, s)]))
        causal, window = rng.random() < 0.7, rng.choice([0, 8, 256])
        q = torch.zeros(b, t, kvh * g, d, dtype=dtype)
        k = torch.zeros(b, s, kvh, d, dtype=dtype)
        kp = torch.arange(s, dtype=torch.int32)
        last = torch.arange(s - t, s, dtype=torch.int32)
        for qp in (last, torch.arange(t, dtype=torch.int32),
                   torch.full((t,), rng.randint(0, s - 1), dtype=torch.int32)):
            want = _attention_work_before(q, k, qp, kp, causal, window)
            assert FA.work(q, k, qp, kp, causal=causal,
                           window=window) == want
        masked = kp.clone()
        masked[:rng.randint(0, s)] = -1
        assert FA.work(q, k, last, masked, causal=causal, window=window) \
            == _attention_work_before(q, k, last, masked, causal, window)
        assert FA.work(q, k, causal=causal, window=window) == \
            _attention_work_before(q, k, torch.arange(t, dtype=torch.int32),
                                   kp, causal, window)
        with FakeTensorMode():
            fq, fk, fqp, fkp = (torch.empty(x.shape, dtype=x.dtype)
                                for x in (q, k, last, kp))
            got = FA.work(fq, fk, fqp, fkp, causal=causal, window=window)
        assert got == _attention_work_before(q, k, last, kp, causal, window)
    for _ in range(20):
        b, h, d = rng.choice([1, 2, 4]), rng.choice([1, 4]), rng.choice(
            [16, 64, 512])
        chunk, nc = rng.choice([16, 24, 256]), rng.randint(1, 4)
        q = torch.zeros(b, nc * chunk, h, d,
                        dtype=rng.choice([torch.bfloat16, torch.float32]))
        for state in (None, ()):
            nbytes, macs = _mlstm_work_before(q, chunk, state)
            assert MS.work(q, chunk, state) == (nbytes, 2 * macs)
