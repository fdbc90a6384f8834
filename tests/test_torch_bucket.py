"""Shape bucketing and graphs kept across calls in the torch cycle engine
(``repro_torch.sim.xengine``, ROADMAP A3h and A7), on the CPU.

The reference's four bucketing tests (tests/test_conformance.py: sweep,
drain, replay and the property over grid widths and horizons) for the
torch engine, ``bucket=True`` against ``bucket=False`` and against the
reference's default (bucketed) program, bit for bit on every RunStats
field but ``timing``/``trace``; ``_bucket_count`` against the
reference's.  Then the graph cache's refill path, which the CPU runs
eagerly on kept buffers when ``"cpu"`` is added to
``xengine._CACHE_DEVICES``: a hit equals a fresh run, whatever the
previous call left in the buffers, and the LRU evicts past its limit.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import sim as R
from repro.fabric import make_fabric as r_make_fabric
from repro.sim import xengine as RX

from repro_torch import sim as T
from repro_torch import workload as TW
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.obs import telemetry
from repro_torch.sim import xengine as TX


def assert_same_stats(a, b):
    for f in dataclasses.fields(a):
        if f.name in ("timing", "trace"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
        else:
            assert x == y, (f.name, x, y)


def assert_same_grids(a, b):
    assert [len(row) for row in a] == [len(row) for row in b]
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert_same_stats(x, y)


def test_bucket_count_equals_the_reference():
    got = [TX._bucket_count(x) for x in range(-2, 5001)]
    assert got == [RX._bucket_count(x) for x in range(-2, 5001)]


def _sweep(mod, **kw):
    """tests/test_conformance.py's _sweep: 9 copies, 90 cycles and a
    packet count strictly inside bucket boundaries, so bucketing pads
    every axis."""
    topo = mod.cin_topology("xor", 16)

    def tf(load, seed):
        return mod.uniform(16, offered=load, cycles=90, terminals=2,
                           seed=seed)
    eng = RX if mod is R else TX
    extra = {} if mod is R else {"device": "cpu"}
    return eng.sweep(topo, "minimal", tf, [0.25, 0.55, 0.85],
                     seeds=(0, 1, 2), terminals=2, cycles=90, warmup=20,
                     **extra, **kw)


def test_bucketed_sweep_bit_identical_to_exact():
    bucketed = _sweep(T)
    assert_same_grids(_sweep(T, bucket=False), bucketed)
    assert_same_grids(_sweep(R), bucketed)
    run = TX._prepare(T.cin_topology("xor", 16), "minimal",
                      lambda load, seed: T.uniform(16, offered=load,
                                                   cycles=90, terminals=2,
                                                   seed=seed),
                      [0.25, 0.55, 0.85], seeds=(0, 1, 2), terminals=2,
                      cycles=90, warmup=20, device="cpu")
    m = sum(int(pk["m_real"]) for pk in run.packed)
    assert (run.pkt["copy_id"].numel(), run.spec.horizon,
            run.pkt["src"].numel()) == (16, 96, TX._bucket_count(m))
    assert run.pkt["src"].numel() > m and run.pkt["lim"][0] == 90


def test_bucketed_drain_bit_identical_to_exact():
    tr = T.one_shot_all_to_all(9)
    kw = dict(terminals=4, device="cpu")
    exact = T.simulate_torch(T.cin_topology("circle", 9), T.MinimalPolicy(),
                             tr, bucket=False, **kw)
    bucketed = T.simulate_torch(T.cin_topology("circle", 9),
                                T.MinimalPolicy(), tr, **kw)
    assert_same_stats(exact, bucketed)
    ref = RX.simulate_jax(R.cin_topology("circle", 9), R.MinimalPolicy(),
                          R.one_shot_all_to_all(9), terminals=4)
    assert_same_stats(ref, bucketed)


def test_bucketed_replay_bit_identical_to_exact():
    a = t_make_fabric("xor", 8).replay("all_to_all", message_size=2,
                                       bucket=False, device="cpu")
    b = t_make_fabric("xor", 8).replay("all_to_all", message_size=2,
                                       device="cpu")
    assert_same_stats(a, b)
    ref = r_make_fabric("xor", 8).replay("all_to_all", message_size=2,
                                         backend="jax")
    assert_same_stats(ref, b)


@settings(max_examples=4, deadline=None)
@given(points=st.integers(1, 5), cycles=st.integers(40, 88))
def test_bucketing_invariance_property(points, cycles):
    """Any grid width x any horizon: padding the batch, the packet axis
    and the cycle loop never changes a single statistic."""
    topo = T.cin_topology("xor", 8)

    def tf(load, seed):
        return T.uniform(8, offered=load, cycles=cycles, terminals=2,
                         seed=seed)
    loads = [round(0.2 + 0.15 * i, 2) for i in range(points)]
    kw = dict(seeds=(0,), terminals=2, cycles=cycles, warmup=cycles // 4,
              device="cpu")
    assert_same_grids(T.sweep(topo, "minimal", tf, loads, bucket=False, **kw),
                      T.sweep(topo, "minimal", tf, loads, **kw))


def test_bucketing_runs_no_extra_cycle():
    """The host loop stops at the runtime horizon: a 100-cycle sweep (static
    horizon 128) runs 7 blocks of 16, bucketed or not."""
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=100, terminals=2, seed=1)
    trips = []
    for bucket in (False, True):
        before = TX.block_runs
        T.simulate_torch(topo, "minimal", tr, bucket=bucket, device="cpu")
        trips.append(TX.block_runs - before)
    assert trips == [7, 7]


# ---------------------------------------------------------------------------
# The graph cache's refill path, eagerly on the CPU.
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_cache(monkeypatch):
    """Keep CPU runs in the cache, from empty counters and an empty cache."""
    monkeypatch.setattr(TX, "_CACHE_DEVICES", ("cuda", "cpu"))
    telemetry.clear_caches()
    telemetry.reset_cache_stats()
    yield telemetry
    telemetry.clear_caches()
    telemetry.reset_cache_stats()


def _uncached(fn):
    """``fn()`` with the cache off: the reference result of a hit."""
    keep = TX._CACHE_DEVICES
    TX._CACHE_DEVICES = ("cuda",)
    try:
        return fn()
    finally:
        TX._CACHE_DEVICES = keep


def test_a_hit_refills_every_buffer_and_equals_a_fresh_run(cpu_cache):
    """Two open-loop sweeps of one key with other seeds and loads: the
    second is a memory hit and equals an uncached run, so no table,
    packet, base key, bound or state field kept the first call's values."""
    topo = T.cin_topology("xor", 8)

    def run(loads, seeds):
        def tf(load, seed):
            return T.uniform(8, offered=load, cycles=60, terminals=2,
                             seed=seed)
        return T.sweep(topo, "adaptive", tf, loads, seeds=seeds,
                       terminals=2, cycles=60, warmup=15, device="cpu")
    first = run([0.3, 0.9], (1, 2))
    second = run([0.4, 0.8], (5, 6))
    assert first[0][0].timing["compile_cached"] is False
    assert second[0][0].timing["compile_cached"] == "memory"
    assert second[0][0].timing["compile_s"] == 0.0
    assert cpu_cache.cache_stats()["misses"] == 1
    assert cpu_cache.cache_stats()["memory_hits"] == 1
    assert_same_grids(second, _uncached(lambda: run([0.4, 0.8], (5, 6))))
    assert_same_grids(first, _uncached(lambda: run([0.3, 0.9], (1, 2))))


def test_a_hit_resets_drain_replay_and_trace_state(cpu_cache):
    """Drained replays share a key across seeds: the phase record, the
    trace rings and the delivery record start again from cycle 0."""
    fab = t_make_fabric("xor", 8)

    def run(seed):
        return fab.replay("all_to_all", message_size=2, seed=seed,
                          trace=True, policy="adaptive", device="cpu")
    a, b = run(0), run(3)
    assert b.timing["compile_cached"] == "memory"
    fresh = _uncached(lambda: run(3))
    assert_same_stats(b, fresh)
    assert b.trace.equals(fresh.trace)
    assert a.completion_cycles == b.completion_cycles == 14


def test_a_hit_resets_the_serving_state(cpu_cache):
    """Serving sweeps at two loads: other packet counts in one bucket."""
    spec = TW.ArrivalSpec(kind="mmpp", rate=0.03, burst=6.0)
    topo = T.cin_topology("xor", 8)

    def run(load):
        tr = TW.serving_traffic(spec, 8, cycles=80, load=load,
                                packets_per_request=4, slo=20.0, seed=4)
        return T.simulate_torch(topo, "minimal", tr, cycles=80, warmup=0,
                                drain=True, device="cpu")
    runs = [run(load) for load in (1.0, 1.15)]
    assert runs[0].packets_generated != runs[1].packets_generated
    assert runs[1].timing["compile_cached"] == "memory"
    assert_same_stats(runs[1], _uncached(lambda: run(1.15)))


def test_the_cache_evicts_past_its_limit(cpu_cache, monkeypatch):
    monkeypatch.setattr(telemetry, "_CACHE_LIMIT", 2)
    topo = T.cin_topology("xor", 8)
    for cycles in (20, 40, 60, 20):         # horizons 24, 40, 64, 24
        tr = T.uniform(8, offered=0.5, cycles=cycles, terminals=2, seed=1)
        st = T.simulate_torch(topo, "minimal", tr, device="cpu")
    assert st.timing["compile_cached"] is False      # 20 was evicted
    assert cpu_cache.cache_stats() == dict(
        memory_hits=0, disk_hits=0, misses=4, evictions=2, disk_writes=0,
        disk_errors=0)
    assert len(telemetry._CACHE) == 2
