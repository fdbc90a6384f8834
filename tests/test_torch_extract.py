"""repro_torch.workload.extract and the collective recorder against
repro.workload.extract, on the CPU.

The lowering: the port's ``workload_from_ops`` on recorded ops against the
reference's ``workload_from_hlo`` on the same ops (its HLO walk replaced by
the list, so its own lowering code runs), on a CIN, a HyperX and a
Dragonfly fabric, error messages included; equal as workload dicts.

The steps: the port's MoE, DP and pipeline steps recorded on gloo ranks (8,
8 and 4, each rank a process of its own; every rank must record the same
ops) and through the recording group in this process, against one
reference child that compiles ``moe_step_hlo``, ``dp_step_hlo`` and
``pipeline_step_hlo`` on 8 forced host devices.  All at
``bytes_per_packet=256``: moe and pipeline phase for phase, dp (whose leaf
chains XLA schedules in its own order) as a multiset of (src, dst,
messages) phases; the same totals; completion equal to the contention-free
bound on the numpy oracle and on the port's torch engine on the CPU.

The pipeline's permutes: the reference's program shifts bf16 activations
(its StableHLO permute is ``bf16``), and XLA's CPU compiler widens the
permute to f32 (2048 B), so its CPU HLO counts twice the bytes the program
moves.  The port records what it posts, the program's 1024 B; the
reference side is held with its permutes at the program's bytes, and the
child checks that premise on the reference's own lowered and compiled
text.
"""
import collections
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.core import DragonflyConfig as R_Dragonfly
from repro.core import HyperXConfig as R_HyperX
from repro.launch import hlo_analysis as RH
from repro.launch.hlo_analysis import CollectiveOp as R_Op
from repro.workload import extract as RE

from repro_torch.core import DragonflyConfig as T_Dragonfly
from repro_torch.core import HyperXConfig as T_HyperX
from repro_torch.core import collectives as C
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.sim.workloads import Workload, replay
from repro_torch.workload import extract as TE

from test_workload import _SYNTH_HLO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
BPP = 256
STEPS = {"moe": (8, {}), "dp": (8, {}), "pipeline": (4, {}),
         "moe_dp2": (8, {"dp": 2})}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The lowering, op by op.
# ---------------------------------------------------------------------------

def _reference_lowering(monkeypatch, ops, fabric, **kw):
    """The reference's workload_from_hlo with its HLO walk replaced by
    ``ops`` (as its own CollectiveOps)."""
    r_ops = [R_Op(o.kind, o.raw_bytes, o.group_size, o.count, o.pairs)
             for o in ops]
    monkeypatch.setattr(RE, "collective_sequence",
                        lambda text, default_group: r_ops)
    return RE.workload_from_hlo("", fabric, **kw)


def _outcome(fn):
    try:
        return fn().to_dict()
    except ValueError as e:
        return f"ValueError: {e}"


def test_synth_hlo_as_ops_gives_the_reference_workload():
    """The reference's _SYNTH_HLO (a permute in a 5-trip while body) as
    recorded ops."""
    ops = [C.CollectiveOp(o.kind, o.raw_bytes, o.group_size, o.count,
                          o.pairs)
           for o in RH.collective_sequence(_SYNTH_HLO, 4)]
    want = RE.workload_from_hlo(_SYNTH_HLO, ("xor", 4), bytes_per_packet=128,
                                name="synth")
    got = TE.workload_from_ops(ops, ("xor", 4), bytes_per_packet=128,
                               name="synth")
    assert got.to_dict() == want.to_dict()
    assert sum(len(p.src) for p in got.phases) == 3 * 5
    assert all(p.messages == 2 for p in got.phases)


_FABRICS = {
    "cin": (("xor", 8), ("xor", 8), 8),
    "hyperx": (R_HyperX((2, 4), 2), T_HyperX((2, 4), 2), 8),
    "dragonfly": (R_Dragonfly(4, 2, 1, 5, local_instance="circle",
                              global_instance="mirror"),
                  T_Dragonfly(4, 2, 1, 5, local_instance="circle",
                              global_instance="mirror"), 20),
}


def _make(spec):
    return t_make_fabric(*spec) if isinstance(spec, tuple) else \
        t_make_fabric(spec)


def _r_make(spec):
    from repro.fabric import make_fabric
    return make_fabric(*spec) if isinstance(spec, tuple) else \
        make_fabric(spec)


@pytest.mark.parametrize("fabric", sorted(_FABRICS))
@pytest.mark.parametrize("kind", ["all-to-all", "all-reduce",
                                  "reduce-scatter", "all-gather",
                                  "collective-permute"])
def test_lowering_table_row_matches_reference(monkeypatch, fabric, kind):
    r_spec, t_spec, n = _FABRICS[fabric]
    pairs = (tuple((i, (i + 3) % n) for i in range(n))
             if kind == "collective-permute" else ())
    ops = [C.CollectiveOp(kind, 5000, n, 1, pairs),
           C.CollectiveOp(kind, 300, n, 2, pairs)]
    for bpp in (64, 1000):
        want = _reference_lowering(monkeypatch, ops, _r_make(r_spec),
                                   bytes_per_packet=bpp, name="row")
        got = TE.workload_from_ops(ops, _make(t_spec), bytes_per_packet=bpp,
                                   name="row")
        assert got.to_dict() == want.to_dict()
        assert got.num_phases == want.num_phases > 0


_ERRORS = {
    "group_size_strict": ([C.CollectiveOp("all-reduce", 64, 4)], {}),
    "group_size_lenient_leaves_nothing": (
        [C.CollectiveOp("all-reduce", 64, 4)], {"strict": False}),
    "lenient_keeps_the_rest": (
        [C.CollectiveOp("all-reduce", 64, 4),
         C.CollectiveOp("all-gather", 640, 8)], {"strict": False}),
    "bytes_per_packet": ([C.CollectiveOp("all-gather", 64, 8)],
                         {"bytes_per_packet": 0}),
    "nothing_recorded": ([], {}),
    "self_pairs_only": ([C.CollectiveOp("collective-permute", 64, 8, 1,
                                        ((0, 0), (3, 3)))], {}),
    "permute_out_of_range": ([C.CollectiveOp("collective-permute", 64, 8, 1,
                                             ((0, 1), (1, 9)))], {}),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_lowering_errors_match_reference(monkeypatch, case):
    ops, kw = _ERRORS[case]
    kw = dict({"bytes_per_packet": 32, "name": "err"}, **kw)
    want = _outcome(lambda: _reference_lowering(monkeypatch, ops,
                                                ("xor", 8), **kw))
    got = _outcome(lambda: TE.workload_from_ops(ops, ("xor", 8), **kw))
    assert got == want
    if case != "lenient_keeps_the_rest":
        assert isinstance(got, str) and got.startswith("ValueError")


# ---------------------------------------------------------------------------
# The recorder.
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_recorder_raises_for_an_unrecorded_call(fake_world):
    x, original = torch.ones(4), dist.all_reduce
    with pytest.raises(RuntimeError, match="all_reduce.: 1"):
        with C.record_collectives() as ops:
            C.library_all_reduce(x)
            dist.all_reduce(x.clone())
    assert [o.kind for o in ops] == ["all-reduce"]
    with pytest.raises(RuntimeError, match="batch_isend_irecv.: 1"):
        with C.record_collectives():
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, x, 1)]):
                req.wait()
    # outside a recording the library's calls are its own again
    assert dist.all_reduce is original


def test_recorder_records_chains_and_library_calls(fake_world):
    """A chain step records its whole matching over global ranks on every
    rank; the backward records the inverse matching; the library
    all-reduce records its whole tensor, forward and backward."""
    x = torch.zeros((8, 3), requires_grad=True)
    before = C.exchanges
    with C.record_collectives() as ops:
        y = C.all_to_all_lacin(x)
        s = C.library_all_reduce(y.sum())
        s.backward()
    assert C.exchanges - before == 14
    kinds = [o.kind for o in ops]
    assert kinds == ["collective-permute"] * 7 + ["all-reduce"] * 2 + \
        ["collective-permute"] * 7
    sched = C.make_schedule("auto", 8)
    fwd = [o.pairs for o in ops[:7]]
    assert fwd == [tuple(sched.perm(i)) for i in range(7)]
    bwd = ops[9:]
    assert sorted(o.pairs for o in bwd) == sorted(
        tuple((b, a) for a, b in p) for p in fwd)
    assert all(o.raw_bytes == 12 and o.group_size == 8
               for o in ops[:7] + bwd)
    assert ops[7].raw_bytes == ops[8].raw_bytes == 4
    with pytest.raises(RuntimeError, match="already open"):
        with C.record_collectives():
            with C.record_collectives():
                pass


def test_ppermute_gives_zeros_where_nothing_arrives(fake_world):
    x = torch.arange(6.0).reshape(2, 3)
    with C.record_collectives() as ops:
        out = C.ppermute(x, [(1, 2), (2, 3)])
    assert torch.equal(out, torch.zeros_like(x))    # rank 0: in no pair
    assert ops == [C.CollectiveOp("collective-permute", 24, 8, 1,
                                  ((1, 2), (2, 3)))]
    with pytest.raises(ValueError, match="not a permutation"):
        C.ppermute(x, [(0, 1), (0, 2)])


def test_same_ops_unites_groups_and_refuses_disagreement():
    a = C.CollectiveOp("collective-permute", 8, 4, 1, ((0, 1), (1, 0)))
    b = C.CollectiveOp("collective-permute", 8, 4, 1, ((4, 5), (5, 4)))
    merged = TE.same_ops([[a], [b]])
    assert merged[0].pairs == ((0, 1), (1, 0), (4, 5), (5, 4))
    with pytest.raises(AssertionError, match="other collectives"):
        TE.same_ops([[a], [C.CollectiveOp("all-reduce", 8, 4)]])
    with pytest.raises(AssertionError, match="not one permutation"):
        TE.same_ops([[a], [C.CollectiveOp("collective-permute", 8, 4, 1,
                                          ((0, 2),))]])


# ---------------------------------------------------------------------------
# The three steps against the reference's compiled HLO.
# ---------------------------------------------------------------------------

_REF_CHILD = r"""
import json, re, sys
import jax, jax.numpy as jnp
from repro._compat.jaxapi import make_auto_mesh
from repro.launch.hlo_analysis import collective_sequence
from repro.models.transformer import init_params
from repro.runtime.pipeline import make_pipeline_loss_fn
from repro.workload.extract import (_tiny_dense_cfg, dp_step_hlo,
                                    moe_step_hlo, pipeline_step_hlo)
out = {}
for key, fn, n, kw in (("moe", moe_step_hlo, 8, {}), ("dp", dp_step_hlo, 8, {}),
                       ("pipeline", pipeline_step_hlo, 4, {}),
                       ("moe_dp2", moe_step_hlo, 8, {"dp": 2})):
    hlo = fn(n, **kw)
    out[key] = [[o.kind, o.raw_bytes, o.group_size, o.count,
                 [list(p) for p in o.pairs]]
                for o in collective_sequence(hlo, n)]
    if key == "pipeline":
        out["pipeline_compiled"] = re.findall(
            r"= (\w+)\[[\d,]*\]\{[\d,]*\} collective-permute\(", hlo)
cfg = _tiny_dense_cfg("extract-pipe", num_layers=4, d_model=32)
mesh = make_auto_mesh((4,), ("pipe",))
zeros = jnp.zeros((4, 8), jnp.int32)
lowered = jax.jit(make_pipeline_loss_fn(cfg, mesh, n_micro=2)).lower(
    init_params(jax.random.PRNGKey(0), cfg), {"tokens": zeros,
                                              "labels": zeros}).as_text()
out["pipeline_lowered"] = re.findall(
    r"collective_permute.*-> tensor<[\dx]*x(\w+)>", lowered)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(reference ops by step, the port's gloo ops by step), the reference
    child running beside the gloo ranks."""
    tmp = tmp_path_factory.mktemp("extract")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", _REF_CHILD,
                            str(tmp / "ref.json")], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        port = {key: TE.extract_ops(key.split("_")[0], n, group="gloo",
                                    **kw)
                for key, (n, kw) in STEPS.items()}
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "ref.json") as f:
        ref_out = json.load(f)
    return ref_out, port


def _ref_ops(rows, program_bytes=1.0):
    return [C.CollectiveOp(kind, int(raw * program_bytes)
                           if kind == "collective-permute" else raw,
                           group, count, tuple(tuple(p) for p in pairs))
            for kind, raw, group, count, pairs in rows]


def _both_workloads(monkeypatch, ref_ops, port_ops, n):
    want = _reference_lowering(monkeypatch, ref_ops, ("xor", n),
                               bytes_per_packet=BPP, name="step")
    got = TE.workload_from_ops(port_ops, ("xor", n), bytes_per_packet=BPP,
                               name="step")
    return Workload.from_dict(want.to_dict()), got


def _bounds(w, n):
    topo = t_make_fabric("xor", n).sim_topology()
    a = replay(topo, "minimal", w, backend="numpy")
    b = replay(topo, "minimal", w, backend="torch", device="cpu")
    assert a.completion_cycles == b.completion_cycles
    assert list(a.phase_cycles) == list(b.phase_cycles)
    return a.completion_cycles, a.ideal_cycles


def _per_collective(w, steps):
    """The phases as one multiset per LACIN collective of ``steps``
    matchings, in program order."""
    return [collections.Counter(w.phases[i:i + steps])
            for i in range(0, w.num_phases, steps)]


def test_pipeline_step_workload_phase_for_phase(steps, monkeypatch):
    ref, port = steps
    # the reference's CPU HLO widens the pipeline's bf16 permutes to f32
    want, got = _both_workloads(monkeypatch, _ref_ops(ref["pipeline"], 0.5),
                                port["pipeline"], 4)
    assert got.phases == want.phases
    assert _bounds(got, 4) == (got.ideal_cycles,) * 2


@pytest.mark.parametrize("key", ["moe", "moe_dp2"])
def test_moe_step_workload_collective_for_collective(steps, monkeypatch,
                                                     key):
    """Dispatch, then combine, each the same matchings; within one
    all-to-all XLA schedules the independent step permutes in its own
    order (step 0, then N-1 down to 1), the port in step order."""
    ref, port = steps
    ep = 8 // STEPS[key][1].get("dp", 1)
    want, got = _both_workloads(monkeypatch, _ref_ops(ref[key]), port[key],
                                8)
    assert _per_collective(got, ep - 1) == _per_collective(want, ep - 1)
    assert len(_per_collective(got, ep - 1)) == 2
    assert got.phases[::ep - 1] == want.phases[::ep - 1]
    assert _bounds(got, 8) == (got.ideal_cycles,) * 2
    if key == "moe":       # BENCH workload.extract
        assert (got.num_phases, got.num_packets, got.ideal_cycles) == \
            (14, 896, 112)
        assert {o.raw_bytes for o in port[key]} == {2048}


def test_pipeline_permutes_are_bf16_in_the_reference_program(steps,
                                                             monkeypatch):
    """The premise of the pipeline's byte scale: the reference's program
    permutes bf16, its CPU compile f32; unscaled, its HLO lowers to the
    table's 11 phases, 144 packets, 46 cycles, the port's program to 11,
    84 and 26."""
    ref, port = steps
    assert ref["pipeline_lowered"] == ["bf16"]
    assert ref["pipeline_compiled"] == ["f32"]
    want, got = _both_workloads(monkeypatch, _ref_ops(ref["pipeline"]),
                                port["pipeline"], 4)
    assert (want.num_phases, want.num_packets, want.ideal_cycles) == \
        (11, 144, 46)
    assert (got.num_phases, got.num_packets, got.ideal_cycles) == \
        (11, 84, 26)
    assert [(o.kind, o.raw_bytes) for o in port["pipeline"]] == \
        [("collective-permute", 1024)] * 5 + [("all-reduce", 4)]


def test_dp_step_workload_as_a_multiset(steps, monkeypatch):
    ref, port = steps
    want, got = _both_workloads(monkeypatch, _ref_ops(ref["dp"]),
                                port["dp"], 8)

    def bag(w):
        return collections.Counter((p.src, p.dst, p.messages)
                                   for p in w.phases)
    assert bag(got) == bag(want)
    assert (got.num_phases, got.num_packets, got.ideal_cycles) == \
        (182, 3360, 420)
    assert _bounds(got, 8) == (420, 420)
    # the loss is the reference's pmean: one library all-reduce of 4 B
    assert [(o.kind, o.raw_bytes) for o in port["dp"]
            if o.kind != "collective-permute"] == [("all-reduce", 4)]


@pytest.mark.parametrize("key", sorted(STEPS))
def test_recording_group_records_what_gloo_ranks_record(steps, key):
    """In one process, as rank 0 of the fake group (and, for dp > 1, as
    the first rank of each EP group), the same ops as every gloo rank."""
    _, port = steps
    n, kw = STEPS[key]
    assert TE.extract_ops(key.split("_")[0], n, group="fake", device="cpu",
                          **kw) == port[key]


def test_extract_ops_refuses_an_open_group(fake_world):
    with pytest.raises(RuntimeError, match="already initialized"):
        TE.extract_ops("moe", 8, device="cpu")
    with pytest.raises(ValueError, match="unknown step"):
        TE.extract_ops("sharded", 8, device="cpu")
