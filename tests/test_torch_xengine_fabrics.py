"""The torch cycle engine (``repro_torch.sim.xengine``) beyond single
CINs: multi-copy sweeps, HyperX and Dragonfly fabrics (whose lane blocks
take the sorted-key ejection branch), drained sweeps, the one-shot
all-to-all against the closed form, the gated block loop, and what is not
ported yet.  Held bit for bit against ``repro.sim.xengine.sweep``
(``bucket=False``) on every RunStats field but timing and trace.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import sim as R
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
from repro.sim import xengine as RX

from repro_torch import sim as T
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX
from repro_torch.core.simulate import cin_link_loads
from repro_torch.sim import xengine as TX


def assert_same_grid(ga, gb):
    assert [len(r) for r in ga] == [len(r) for r in gb]
    for ra, rb in zip(ga, gb):
        for a, b in zip(ra, rb):
            for f in dataclasses.fields(a):
                if f.name in ("timing", "trace"):
                    continue
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    assert np.array_equal(np.asarray(x), np.asarray(y)), \
                        f.name
                else:
                    assert x == y, (f.name, x, y)


def _both(ref_topo, port_topo, policy, loads, seeds, cycles, **kw):
    """The same sweep through the reference and through the port."""
    n = ref_topo.num_switches
    t = kw.pop("terminals", 2)

    def factory(mod):
        return lambda load, seed: mod.uniform(n, offered=load, cycles=cycles,
                                              terminals=t, seed=seed)
    port_policy = kw.pop("port_policy", policy)
    a = RX.sweep(ref_topo, policy, factory(R), loads, seeds=seeds,
                 terminals=t, cycles=cycles, bucket=False, **kw)
    b = T.sweep(port_topo, port_policy, factory(T), loads, seeds=seeds,
                terminals=t, cycles=cycles, device="cpu", **kw)
    return a, b


def test_multi_copy_sweep_bit_identical():
    """3 loads x 3 seeds = 9 fabric copies of one flat state, each copy
    drawing from its own folded key (copy 0 from the cycle key)."""
    a, b = _both(R.cin_topology("xor", 16), T.cin_topology("xor", 16),
                 "minimal", [0.25, 0.55, 0.85], (0, 1, 2), 90, warmup=20)
    assert_same_grid(a, b)
    assert b[0][0].timing["grid_points"] == 9


@pytest.mark.parametrize("policy", ["minimal", "valiant", "adaptive"])
def test_hyperx_sweep_bit_identical(policy):
    a, b = _both(R.hyperx_topology(R_HyperX((4, 4), 2)),
                 T.hyperx_topology(T_HyperX((4, 4), 2)), policy, [0.4, 0.8],
                 (1, 2), 80, warmup=20)
    assert_same_grid(a, b)


@pytest.mark.parametrize("policy", ["minimal", "valiant", "adaptive"])
def test_dragonfly_sweep_bit_identical(policy):
    """Dragonfly a=8 p=4 h=4 g=9: 11 ports x 3 VCs = 33 lanes a switch, so
    even minimal routing takes the sorted-key ejection branch (pv > 32)."""
    a, b = _both(R.dragonfly_topology(R_Dragonfly(8, 4, 4, 9)),
                 T.dragonfly_topology(T_Dragonfly(8, 4, 4, 9)), policy,
                 [0.3, 0.9], (3,), 60, warmup=15, terminals=4)
    assert_same_grid(a, b)


def test_drained_dragonfly_sweeps_with_a_non_power_of_two_weight():
    """Valiant, and adaptive with weight 1.3 (the detour threshold's fused
    multiply-add is not exact in float32), drained, on Dragonfly a=6 h=2
    g=12."""
    rt = R.dragonfly_topology(R_Dragonfly(6, 3, 2, 12))
    tt = T.dragonfly_topology(T_Dragonfly(6, 3, 2, 12))
    for ref_p, port_p in [
            (R.ValiantPolicy(), T.ValiantPolicy()),
            (R.AdaptivePolicy(threshold=0.5, weight=1.3),
             T.AdaptivePolicy(threshold=0.5, weight=1.3))]:
        a, b = _both(rt, tt, ref_p, [0.5], (1, 2), 40, warmup=10, drain=True,
                     terminals=3, port_policy=port_p)
        assert_same_grid(a, b)


def test_one_shot_all_to_all_matches_the_closed_form():
    """The README's cross-check: every directed link of CIN xor 16 carries
    exactly one packet (core.simulate.cin_link_loads)."""
    topo = T.cin_topology("xor", 16)
    st = T.simulate_torch(topo, "minimal", T.one_shot_all_to_all(16),
                          terminals=4, device="cpu")
    counter = T.LinkLoadCounter(T.LinkTable.for_topology(topo, 1))
    counter.total = st.link_loads
    assert st.packets_delivered == 240
    assert counter.by_switch_pair() == cin_link_loads("xor", 16)


@pytest.mark.parametrize("drain", [False, True])
def test_gated_blocks_equal_the_per_cycle_loop(drain):
    """Blocks of K gated cycles (a horizon that is no multiple of K, a
    drain that stops inside a block) leave exactly the state of a loop
    that runs one cycle at a time and stops exactly."""
    topo = T.cin_topology("circle", 9)

    def tf(load, seed):
        return T.uniform(9, offered=load, cycles=37, terminals=2, seed=seed)
    prep = TX._prepare(topo, "adaptive", tf, [0.6, 0.9], seeds=(1, 2),
                       terminals=2, cycles=37, warmup=9, drain=drain,
                       device="cpu")
    outs = [TX._run_loop(prep.spec, prep.tb, prep.pkt, block=k)[0]
            for k in (1, 16, 5)]
    for out in outs[1:]:
        assert out.keys() == outs[0].keys()
        for key in out:
            assert np.array_equal(out[key], outs[0][key]), key
    assert int(outs[0]["cycle"]) >= 37


def test_default_device_is_cuda_and_never_falls_back():
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=10, terminals=2)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.simulate_torch(topo, "minimal", tr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.sweep(topo, "minimal", lambda load: tr, [0.5])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.simulate(topo, T.MinimalPolicy(), tr, backend="torch")


def test_simulate_backend_torch_is_the_cycle_engine():
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=30, terminals=2, seed=1)
    a = T.simulate(topo, T.MinimalPolicy(), tr, backend="torch", seed=3,
                   device="cpu")
    b = T.simulate_torch(topo, "minimal", tr, seed=3, device="cpu")
    assert_same_grid([[a]], [[b]])
    assert T.sweep(topo, "minimal", lambda load: tr, [], device="cpu") == []


def test_unported_options_raise_naming_their_roadmap_item():
    """Every option the port once raised for now runs: ``devices="auto"``
    resolves to the CPU's one device and ``devices=1`` is one program, both
    equal to ``devices=None`` to the bit, and asking for more devices than
    are visible raises the reference's ``ValueError``
    (``repro.sim.xengine._resolve_devices``).  Bucketing and serving
    traffic run too (tests/test_torch_bucket.py,
    tests/test_torch_workload.py)."""
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=10, terminals=2)
    run = dict(device="cpu")
    base = T.simulate_torch(topo, "minimal", tr, **run)
    for devices in ("auto", 1):
        assert_same_grid([[base]], [[T.simulate_torch(
            topo, "minimal", tr, devices=devices, **run)]])
    for devices in (2, 0):
        with pytest.raises(ValueError, match="devices"):
            T.simulate_torch(topo, "minimal", tr, devices=devices, **run)
    exact = T.simulate_torch(topo, "minimal", tr, bucket=False, devices=1,
                             **run)
    assert_same_grid([[exact]], [[base]])
    serving = T.uniform(8, offered=0.5, cycles=10, terminals=2)
    serving.request = np.arange(serving.num_packets)
    st = T.simulate_torch(topo, "minimal", serving, **run)
    assert st.request_count == serving.num_packets
