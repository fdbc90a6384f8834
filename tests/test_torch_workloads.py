"""Collective replays in the port (``repro_torch.sim.workloads`` and the
replay host code of ``repro_torch.sim.xengine``) against the reference:
``repro.sim.workloads.collective_workload`` (phases, bounds, dict form),
``repro.sim.workloads.replay`` on the numpy oracle (every RunStats field),
and ``repro.sim.xengine`` with ``bucket=False`` (the torch engine on the
CPU, bit for bit, phase barrier included).  Exact: integers.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
from repro.fabric import make_fabric as R_make_fabric
from repro.sim import workloads as RW
from repro.sim import xengine as RX

from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX
from repro_torch.fabric import make_fabric as T_make_fabric
from repro_torch.sim import workloads as TW
from repro_torch.sim import xengine as TX

#: (reference fabric, port fabric), small: CIN (even and odd), HyperX,
#: Dragonfly.
FABRICS = {
    "cin-xor-16": (lambda: R_make_fabric("xor", 16),
                   lambda: T_make_fabric("xor", 16)),
    "cin-circle-9": (lambda: R_make_fabric("circle", 9),
                     lambda: T_make_fabric("circle", 9)),
    "hyperx-4x4": (lambda: R_make_fabric(R_HyperX((4, 4), 2)),
                   lambda: T_make_fabric(T_HyperX((4, 4), 2))),
    "dragonfly-a4h2g5": (lambda: R_make_fabric(R_Dragonfly(4, 2, 2, 5)),
                         lambda: T_make_fabric(T_Dragonfly(4, 2, 2, 5))),
}
COLLECTIVES = ["all_to_all", "all_reduce", "reduce_scatter", "all_gather"]


def assert_same_stats(a, b):
    """Every RunStats field but the run metadata (timing, trace)."""
    for f in dataclasses.fields(a):
        if f.name in ("timing", "trace"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
        else:
            assert x == y, (f.name, x, y)


@pytest.mark.parametrize("collective", COLLECTIVES)
@pytest.mark.parametrize("name", sorted(FABRICS))
def test_collective_workloads_equal(name, collective):
    """repro.sim.workloads.collective_workload at message sizes 1 and 5
    (Dragonfly global phases carry ceil(m / a)): phases, ideal cycles,
    phase_cum and to_dict; a workload written by either package reads
    back through the other's from_dict."""
    rf, tf = (f() for f in FABRICS[name])
    for m in (1, 5):
        a = RW.collective_workload(rf, collective, message_size=m)
        b = TW.collective_workload(tf, collective, message_size=m)
        assert b.to_dict() == a.to_dict()
        assert [dataclasses.astuple(p) for p in b.phases] == \
            [dataclasses.astuple(p) for p in a.phases]
        assert (b.name, b.num_switches, b.num_phases, b.num_packets,
                b.ideal_cycles) == (a.name, a.num_switches, a.num_phases,
                                    a.num_packets, a.ideal_cycles)
        assert np.array_equal(b.phase_cum(b.num_phases + 3),
                              a.phase_cum(a.num_phases + 3))
        assert TW.Workload.from_dict(a.to_dict()).to_dict() == a.to_dict()
        assert RW.Workload.from_dict(b.to_dict()).to_dict() == b.to_dict()
        tr_a, tr_b = a.traffic(), b.traffic()
        for f in ("src", "dst", "gen"):
            assert np.array_equal(getattr(tr_b, f), getattr(tr_a, f)), f


@pytest.mark.parametrize("name,collective", [
    ("cin-xor-16", "all_to_all"), ("cin-circle-9", "all_reduce"),
    ("hyperx-4x4", "all_to_all"), ("dragonfly-a4h2g5", "all_reduce")])
@pytest.mark.parametrize("policy", ["minimal", "adaptive"])
def test_oracle_replay_equals_the_reference(name, collective, policy):
    """repro.sim.workloads.replay(backend="numpy"): every RunStats field,
    the replay fields included."""
    rf, tf = (f() for f in FABRICS[name])
    a = RW.replay(rf.sim_topology(), policy,
                  RW.collective_workload(rf, collective, message_size=2),
                  backend="numpy", seed=3)
    b = TW.replay(tf.sim_topology(), policy,
                  TW.collective_workload(tf, collective, message_size=2),
                  backend="numpy", seed=3)
    assert_same_stats(a, b)
    assert b.completion_cycles >= b.ideal_cycles


@pytest.mark.parametrize("name", ["cin-xor-16", "hyperx-4x4",
                                  "dragonfly-a4h2g5"])
@pytest.mark.parametrize("policy", ["minimal", "adaptive"])
def test_torch_replay_is_bit_identical_to_xengine(name, policy):
    """repro.sim.workloads.replay(backend="jax", bucket=False) against the
    port's replay(backend="torch", device="cpu"): the phase barrier, each
    phase's closing cycle and every RunStats field."""
    rf, tf = (f() for f in FABRICS[name])
    a = RW.replay(rf.sim_topology(), policy,
                  RW.collective_workload(rf, "all_to_all", message_size=2),
                  backend="jax", seed=5, bucket=False)
    b = TW.replay(tf.sim_topology(), policy,
                  TW.collective_workload(tf, "all_to_all", message_size=2),
                  seed=5, device="cpu")
    assert_same_stats(a, b)
    assert b.timing["backend"] == "torch"


def test_replay_grid_pads_phases_as_xengine():
    """A sweep whose copies replay workloads of different phase counts
    (all-to-all: 15 phases, all-reduce: 30) pads each copy's phase_cum to
    the grid's count: repro.sim.xengine.sweep (bucket=False), bit for bit."""
    rf, tf = R_make_fabric("xor", 16), T_make_fabric("xor", 16)
    rws = [RW.collective_workload(rf, c, message_size=1)
           for c in ("all_to_all", "all_reduce")]
    tws = [TW.collective_workload(tf, c, message_size=1)
           for c in ("all_to_all", "all_reduce")]
    a = RX.sweep(rf.sim_topology(), "adaptive",
                 lambda i, _s: rws[int(i)].traffic(), [0, 1], seeds=(7,),
                 cycles=30, bucket=False)
    b = TX.sweep(tf.sim_topology(), "adaptive",
                 lambda i, _s: tws[int(i)].traffic(), [0, 1], seeds=(7,),
                 cycles=30, device="cpu")
    for ra, rb in zip(a, b):
        assert_same_stats(ra[0], rb[0])
    assert [len(r[0].phase_cycles) for r in b] == [15, 30]


def test_mixed_replay_and_open_loop_grid_raises():
    tf = T_make_fabric("xor", 8)
    topo, w = tf.sim_topology(), TW.collective_workload(tf, "all_to_all")
    from repro_torch import sim as T
    open_loop = T.uniform(8, offered=0.5, cycles=20, terminals=1)
    with pytest.raises(ValueError, match="cannot mix"):
        TX.sweep(topo, "minimal",
                 lambda i: w.traffic() if i == 0 else open_loop, [0, 1],
                 device="cpu")


def test_collective_replay_minimal_arm_meets_the_bounds_on_the_oracle():
    """The bundled collective_replay spec's minimal arm on the port's numpy
    oracle: CIN-16 and HyperX 16x16 complete in exactly the contention-free
    bound, phase by phase; Dragonfly-72 serializes its global steps (142
    against 32, BENCH collective_replay)."""
    fabrics = [T_make_fabric("xor", 16),
               T_make_fabric(T_HyperX((16, 16), 8, "xor")),
               T_make_fabric(T_Dragonfly(6, 3, 2, 12))]
    got = []
    for fab in fabrics:
        w = TW.collective_workload(fab, "all_to_all", message_size=2)
        st = fab.replay("all_to_all", message_size=2, backend="numpy")
        got.append((st.completion_cycles, st.ideal_cycles))
        if fab.name.startswith(("cin", "hyperx")):
            assert list(st.phase_cycles) == [ph.messages for ph in w.phases]
    assert got == [(30, 30), (60, 60), (142, 32)]


def test_replay_entry_points_default_to_the_card(monkeypatch):
    """replay and Fabric.replay default to the torch engine on cuda: without
    CUDA they raise and never run the oracle, degraded replays included;
    "jax" is no backend of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fab = T_make_fabric("xor", 8)
    w = TW.collective_workload(fab, "all_to_all")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fab.replay()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TW.replay(fab.sim_topology(), "minimal", w)
    with pytest.raises(ValueError, match="unknown simulator backend"):
        TW.replay(fab.sim_topology(), "minimal", w, backend="jax")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fab.replay(failures={"link_fraction": 0.1})
    st = fab.replay(device="cpu")
    assert (st.completion_cycles, st.ideal_cycles) == (7, 7)
