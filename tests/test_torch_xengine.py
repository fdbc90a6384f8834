"""The torch cycle engine (``repro_torch.sim.xengine``, on the CPU)
against the reference's compiled engine (``repro.sim.xengine``) bit for
bit: every RunStats field but the run metadata (timing, trace), on the
instances of tests/test_conformance.py, with minimal, Valiant and
adaptive routing, open loop and drained.

The reference runs exact shapes (``bucket=False``), which its own
conformance suite pins bit-identical to its default bucketed program.
The same threefry stream (repro_torch.sim.threefry) makes arbitration
draws equal, so latencies and link loads are equal, not just close.
"""
import dataclasses

import numpy as np
import pytest

import repro.fabric.mirror  # noqa: F401  (registers the mirror instance)
from repro import sim as R
from repro.sim import xengine as RX

import repro_torch.fabric  # noqa: F401  (registers the mirror instance)
from repro_torch import sim as T

INSTANCES = [("swap", 8), ("circle", 9), ("xor", 8), ("mirror", 9)]
POLICIES = ["minimal", "valiant", "adaptive"]


def assert_same_stats(a, b):
    for f in dataclasses.fields(a):
        if f.name in ("timing", "trace"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
        else:
            assert x == y, (f.name, x, y)


@pytest.mark.parametrize("inst,n", INSTANCES)
@pytest.mark.parametrize("policy", POLICIES)
def test_open_loop_bit_identical(inst, n, policy):
    """repro.sim.xengine.simulate_jax, open-loop uniform traffic past
    saturation, a fixed horizon with a warm-up window."""
    kw = dict(offered=0.7, cycles=100, terminals=3, seed=2)
    a = RX.simulate_jax(R.cin_topology(inst, n), policy, R.uniform(n, **kw),
                        warmup=25, seed=5, bucket=False)
    b = T.simulate_torch(T.cin_topology(inst, n), policy, T.uniform(n, **kw),
                         warmup=25, seed=5, device="cpu")
    assert_same_stats(a, b)
    assert b.packets_delivered > 0
    assert b.timing["backend"] == "torch"
    assert b.timing["compile_cached"] is False


@pytest.mark.parametrize("inst,n", INSTANCES)
@pytest.mark.parametrize("policy", POLICIES)
def test_drained_one_shot_bit_identical(inst, n, policy):
    """repro.sim.xengine.simulate_jax, drained one-shot all-to-all (the
    scatter delivery record, the drain predicate)."""
    a = RX.simulate_jax(R.cin_topology(inst, n), policy,
                        R.one_shot_all_to_all(n), terminals=4, bucket=False)
    b = T.simulate_torch(T.cin_topology(inst, n), policy,
                         T.one_shot_all_to_all(n), terminals=4, device="cpu")
    assert_same_stats(a, b)
    assert b.packets_delivered == n * (n - 1)
