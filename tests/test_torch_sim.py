"""The port's simulator host side (``repro_torch.sim``, numpy) against
the reference's (``repro.sim``): topology tables and the dense next-hop
table, link tables, every traffic generator per seed, the arbiter, and
the interpreted oracle engine's RunStats field for field.  Exact: the
same numpy code on the same seeds (float fields come from identical
integers through the same numpy expressions).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import sim as R
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
import repro.fabric.mirror  # noqa: F401  (registers the mirror instance)

from repro_torch import sim as T
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX

#: (name, reference topology factory, port topology factory)
TOPOLOGIES = {
    "swap8": (lambda: R.cin_topology("swap", 8),
              lambda: T.cin_topology("swap", 8)),
    "circle9": (lambda: R.cin_topology("circle", 9),
                lambda: T.cin_topology("circle", 9)),
    "xor16": (lambda: R.cin_topology("xor", 16),
              lambda: T.cin_topology("xor", 16)),
    "mirror9": (lambda: R.cin_topology("mirror", 9),
                lambda: T.cin_topology("mirror", 9)),
    "hyperx4x4": (lambda: R.hyperx_topology(R_HyperX((4, 4), 2)),
                  lambda: T.hyperx_topology(T_HyperX((4, 4), 2))),
    "hyperx3x3_circle": (
        lambda: R.hyperx_topology(R_HyperX((3, 3), 2, "circle")),
        lambda: T.hyperx_topology(T_HyperX((3, 3), 2, "circle"))),
    "dragonfly4_2_2_9": (lambda: R.dragonfly_topology(R_Dragonfly(4, 2, 2, 9)),
                         lambda: T.dragonfly_topology(T_Dragonfly(4, 2, 2, 9))),
    "dragonfly6_3_2_12": (
        lambda: R.dragonfly_topology(R_Dragonfly(6, 3, 2, 12)),
        lambda: T.dragonfly_topology(T_Dragonfly(6, 3, 2, 12))),
}


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


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_tables_equal(name):
    """SimTopology fields, minimal_port_table, LinkTable and the routed
    link loads (repro.sim.topology / repro.sim.link)."""
    rt, tt = (f() for f in TOPOLOGIES[name])
    for field in ("name", "num_switches", "num_ports", "diameter"):
        assert getattr(tt, field) == getattr(rt, field), field
    assert np.array_equal(tt.neighbor, rt.neighbor)
    assert np.array_equal(tt.rev_port, rt.rev_port)
    assert np.array_equal(tt.minimal_port_table(), rt.minimal_port_table())
    tt.validate()
    for v in (1, 3):
        rl, tl = R.LinkTable.for_topology(rt, v), T.LinkTable.for_topology(tt, v)
        for field in ("neighbor_flat", "rev_flat", "wired"):
            assert np.array_equal(getattr(tl, field), getattr(rl, field))
        ids = np.flatnonzero(rl.wired)
        assert all(np.array_equal(x, y) for x, y in
                   zip(tl.endpoints(ids), rl.endpoints(ids)))
    assert T.routed_link_loads(tt) == R.routed_link_loads(rt)


def _same_traffic(a, b):
    for f in ("name", "offered", "horizon", "terminals", "num_packets"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("src", "dst", "gen"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("seed", [0, 7])
def test_traffic_generators_equal(seed):
    """repro.sim.traffic: uniform, permutation, hotspot (both kinds),
    adversarial_same_group and the one-shot workloads."""
    kw = dict(offered=0.6, cycles=40, terminals=3, seed=seed)
    _same_traffic(T.uniform(12, **kw), R.uniform(12, **kw))
    _same_traffic(T.permutation(12, **kw), R.permutation(12, **kw))
    _same_traffic(T.hotspot(12, **kw), R.hotspot(12, **kw))
    _same_traffic(T.hotspot(12, hot_dst=3, hot_fraction=0.5, **kw),
                  R.hotspot(12, hot_dst=3, hot_fraction=0.5, **kw))
    _same_traffic(T.adversarial_same_group(T_Dragonfly(4, 2, 2, 9), **kw),
                  R.adversarial_same_group(R_Dragonfly(4, 2, 2, 9), **kw))
    _same_traffic(T.one_shot_all_to_all(9, terminals=2),
                  R.one_shot_all_to_all(9, terminals=2))
    partners = np.array([3, 2, 1, 0, -1, 4])
    _same_traffic(T.one_shot_permutation(partners),
                  R.one_shot_permutation(partners))


def test_arbiter_equal():
    """repro.sim.switch.arbitrate, k = 1 and k = 2."""
    rng = np.random.default_rng(3)
    group = rng.integers(0, 5, 40)
    cls, rand = rng.integers(0, 2, 40), rng.random(40)
    for k in (1, 2):
        assert np.array_equal(T.arbitrate(group, cls, rand, k=k),
                              R.arbitrate(group, cls, rand, k=k))


@pytest.mark.parametrize("name", ["xor16", "circle9", "hyperx4x4",
                                  "dragonfly4_2_2_9"])
@pytest.mark.parametrize("policy", ["minimal", "valiant", "adaptive"])
def test_oracle_engine_runstats_equal(name, policy):
    """repro.sim.engine.simulate (the numpy oracle), open loop, same seeds:
    every RunStats field; and a drained one-shot all-to-all."""
    rt, tt = (f() for f in TOPOLOGIES[name])
    n = rt.num_switches
    kw = dict(offered=0.5, cycles=60, terminals=2, seed=4)
    a = R.simulate(rt, R.make_policy(policy), R.uniform(n, **kw), warmup=15,
                   seed=9)
    b = T.simulate(tt, T.make_policy(policy), T.uniform(n, **kw), warmup=15,
                   seed=9, backend="numpy")
    assert_same_stats(a, b)
    assert b.timing["backend"] == "numpy"
    a = R.simulate(rt, R.make_policy(policy), R.one_shot_all_to_all(n),
                   terminals=2, seed=1)
    b = T.simulate(tt, T.make_policy(policy), T.one_shot_all_to_all(n),
                   terminals=2, seed=1, backend="numpy")
    assert_same_stats(a, b)


def test_oracle_engine_trace_equal():
    """The numpy engine's time-series trace (repro.obs.trace) and its
    derived series."""
    kw = dict(offered=0.7, cycles=50, terminals=2, seed=2)
    a = R.simulate(R.cin_topology("xor", 8), R.MinimalPolicy(),
                   R.uniform(8, **kw), warmup=10, trace={"stride": 5})
    b = T.simulate(T.cin_topology("xor", 8), T.MinimalPolicy(),
                   T.uniform(8, **kw), warmup=10, trace={"stride": 5},
                   backend="numpy")
    assert_same_stats(a, b)
    for f in ("cycles", "link_load", "queue_occ", "injected", "delivered",
              "backlog"):
        assert np.array_equal(getattr(b.trace, f), getattr(a.trace, f)), f
    assert b.trace.stride == a.trace.stride
    assert np.array_equal(b.trace.in_flight, a.trace.in_flight)
    assert np.array_equal(b.trace.link_util(), a.trace.link_util())
    assert b.trace.to_dict().keys() == a.trace.to_dict().keys()


def test_unported_backends_and_options_raise():
    """"jax" is no backend of the port, and the error names the three that
    are; a malformed failures= is refused as the reference refuses it."""
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=10, terminals=2)
    with pytest.raises(ValueError, match="unknown simulator backend.*'flow'"):
        T.simulate(topo, T.MinimalPolicy(), tr, backend="jax")
    with pytest.raises(TypeError, match="unexpected keyword"):
        T.simulate(topo, T.MinimalPolicy(), tr, failures={"links": 0.1},
                   backend="numpy")
    with pytest.raises(TypeError, match="unexpected keyword"):
        topo.degrade({"links": 0.1})


def test_simulate_defaults_to_the_torch_engine_on_the_card(monkeypatch):
    """The port's ``simulate`` runs the cycle engine on ``cuda`` unless the
    caller asks for the oracle: without CUDA the default raises and never
    runs the numpy engine."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=10, terminals=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.simulate(topo, T.MinimalPolicy(), tr)
    assert T.simulate(topo, T.MinimalPolicy(), tr, backend="numpy"
                      ).timing["backend"] == "numpy"
