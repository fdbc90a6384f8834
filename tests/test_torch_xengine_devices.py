"""The cycle engine's copies split over devices (``sweep(devices=)``, the
port of ``repro.sim.xengine._sharded_runner``), on the CPU.

The split runs each block of copies through the same step on its own
device and puts the outputs back together on the host; the CPU has one
device, so the block runner (``xengine._block_sweep``) runs the blocks on
the same device, two and three of them, and each grid is held to one
program to the bit (every RunStats field), and to the reference's
``repro.sim.xengine.sweep``.  The scenarios are the reference's
conformance test's (``tests/test_conformance.py``
``test_sharded_program_bit_identical``: xor-16, uniform, 80 cycles, loads
0.3 and 0.7, seeds 0 and 1, and the one-shot all-to-all drained at 4
terminals), and a collective replay of four copies.
"""
import dataclasses

import numpy as np
import pytest

from repro import sim as R
from repro.fabric import make_fabric as r_make_fabric
from repro.sim import xengine as RX
from repro.sim.workloads import collective_workload as r_workload

from repro_torch import sim as T
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.sim import xengine as TX
from repro_torch.sim.workloads import collective_workload as t_workload


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
                    assert x == y or (x != x and y != y), (f.name, x, y)


def _uniform(mod):
    return lambda load, seed: mod.uniform(16, offered=load, cycles=80,
                                          terminals=2, seed=seed)


_UNIFORM = dict(seeds=(0, 1), terminals=2, cycles=80, warmup=20)


def _scenarios():
    """name -> (reference topology, port topology, reference factory, port
    factory, loads, sweep keywords)."""
    r_fab, t_fab = r_make_fabric("xor", 8), t_make_fabric("xor", 8)
    r_w = r_workload(r_fab, "all_to_all", message_size=2)
    t_w = t_workload(t_fab, "all_to_all", message_size=2)
    return {
        "uniform": (R.cin_topology("xor", 16), T.cin_topology("xor", 16),
                    _uniform(R), _uniform(T), [0.3, 0.7], _UNIFORM),
        "drain": (R.cin_topology("xor", 16), T.cin_topology("xor", 16),
                  lambda load, seed: R.one_shot_all_to_all(16),
                  lambda load, seed: T.one_shot_all_to_all(16), [0.0],
                  dict(seeds=(0,), terminals=4)),
        "replay": (r_fab.sim_topology(), t_fab.sim_topology(),
                   lambda load, seed: r_w.traffic(),
                   lambda load, seed: t_w.traffic(), [0.0],
                   dict(seeds=(0, 1, 2, 3))),
    }


@pytest.fixture(scope="module")
def grids():
    """Each scenario through the reference and through one program of the
    port (bucketed, as both default)."""
    out = {}
    for name, (rt, tt, rf, tf, loads, kw) in _scenarios().items():
        out[name] = (RX.sweep(rt, "minimal", rf, loads, **kw),
                     T.sweep(tt, "minimal", tf, loads, device="cpu", **kw))
    return out


@pytest.mark.parametrize("blocks", [2, 3])
@pytest.mark.parametrize("name", ["uniform", "drain", "replay"])
def test_blocks_equal_one_program_and_the_reference(grids, name, blocks):
    _, tt, _, tf, loads, kw = _scenarios()[name]
    ref, one = grids[name]
    assert_same_grid(ref, one)
    split = TX._block_sweep(["cpu"] * blocks, tt, "minimal", tf, loads, **kw)
    assert_same_grid(one, split)
    assert split[0][0].timing["grid_points"] == sum(len(r) for r in split)


def test_blocks_equal_one_program_unbucketed():
    """Without bucketing the copies pad only to whole blocks: three blocks
    of two copies hold the uniform scenario's four points and two padded
    copies, the last block padding alone."""
    tt, tf = T.cin_topology("xor", 16), _uniform(T)
    run = TX._prepare(tt, "minimal", tf, [0.3, 0.7], bucket=False,
                      block_devices=["cpu"] * 3, **_UNIFORM)
    assert [b[1]["copy_id"].tolist() for b in run.blocks] == [[0, 1], [2, 3],
                                                              [4, 5]]
    assert [int(b[1]["total_m"]) for b in run.blocks][2] == 0
    one = T.sweep(tt, "minimal", tf, [0.3, 0.7], bucket=False, device="cpu",
                  **_UNIFORM)
    assert_same_grid(one, TX._block_sweep(["cpu"] * 3, tt, "minimal", tf,
                                          [0.3, 0.7], bucket=False,
                                          **_UNIFORM))


def test_blocks_share_packets_and_global_copy_ids():
    """Every block holds the whole packet arrays and its own contiguous
    copy ids (the threefry fold keys), so no id is remapped."""
    tt, tf = T.cin_topology("xor", 16), _uniform(T)
    run = TX._prepare(tt, "minimal", tf, [0.3, 0.7], block_devices=["cpu"] * 2,
                      **_UNIFORM)
    one = TX._prepare(tt, "minimal", tf, [0.3, 0.7], device="cpu", **_UNIFORM)
    assert len(run.blocks) == 2 and len(one.blocks) == 1
    for _, pkt in run.blocks:
        for k in ("src", "dst", "gen"):
            assert np.array_equal(pkt[k].numpy(), one.pkt[k].numpy())
    ids = np.concatenate([pkt["copy_id"].numpy() for _, pkt in run.blocks])
    assert np.array_equal(ids, one.pkt["copy_id"].numpy())
    assert sum(int(pkt["total_m"]) for _, pkt in run.blocks) == \
        int(one.pkt["total_m"])


def test_traced_run_stays_one_block():
    """A traced sweep keeps one block, as the reference's does, and its
    traces equal the one program's."""
    tt, tf = T.cin_topology("xor", 16), _uniform(T)
    run = TX._prepare(tt, "minimal", tf, [0.3, 0.7], trace=True,
                      block_devices=["cpu"] * 2, **_UNIFORM)
    assert len(run.blocks) == 1
    got = TX._block_sweep(["cpu"] * 2, tt, "minimal", tf, [0.3, 0.7],
                          trace=True, **_UNIFORM)
    want = T.sweep(tt, "minimal", tf, [0.3, 0.7], trace=True, device="cpu",
                   **_UNIFORM)
    assert_same_grid(want, got)
    for a, b in zip(got[0], want[0]):
        assert a.trace.equals(b.trace)


def test_devices_resolve_as_the_references():
    """``_resolve_devices``: None and 1 one block, "auto" the CPU's one
    device; 0 and more than are visible raise ValueError."""
    import torch
    cpu = torch.device("cpu")
    assert [TX._resolve_devices(d, cpu) for d in (None, 1, "auto")] == [1] * 3
    for bad in (0, 2):
        with pytest.raises(ValueError, match="devices"):
            TX._resolve_devices(bad, cpu)
