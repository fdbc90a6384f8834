"""``repro_torch.sim.threefry`` against ``jax.random`` bit for bit: the
stream the torch cycle engine draws must be the reference engine's.  And
the engine's fused multiply-add rounding against XLA:CPU's.

Held against ``jax.random.PRNGKey`` / ``fold_in`` / ``bits`` (jax with
``jax_threefry_partitionable`` on, the installed default), and against the
per-copy keying of ``repro.sim.xengine._step`` (copy 0 keeps the cycle
key, copy b folds its copy id).  Exact: integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.sim import xengine as XE
from repro_torch.sim.threefry import fold_in, prng_key, random_bits

SEEDS = [0, 1, 2, 12345, 2**31 - 2, 2**31 - 1]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_over_cycles(seed):
    """jax.random.PRNGKey, then fold_in over cycles 0..2000."""
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(_u32(key), prng_key(seed).numpy())
    cycles = np.arange(2001)
    want = _u32(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.asarray(cycles, jnp.int32)))
    got = fold_in(prng_key(seed), torch.from_numpy(cycles)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
@pytest.mark.parametrize("cycle", [0, 1, 1999, 2000])
def test_random_bits_per_copy(seed, cycle):
    """jax.random.bits under the reference's per-copy keying: copy 0 draws
    from the cycle key, copies 1.. from fold_in(cycle key, copy id)."""
    words = 777
    ck = jax.random.fold_in(jax.random.PRNGKey(seed), cycle)
    copy_ids = np.arange(5)
    folded = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        ck, jnp.asarray(copy_ids, jnp.int32))
    keys = jnp.where((jnp.asarray(copy_ids) == 0)[:, None], ck, folded)
    want = _u32(jax.vmap(lambda k: jax.random.bits(k, (words,)))(keys))

    tck = fold_in(prng_key(seed), torch.tensor(cycle))
    tid = torch.from_numpy(copy_ids)
    tkeys = torch.where((tid == 0)[:, None], tck, fold_in(tck, tid))
    got = random_bits(tkeys, words).numpy()
    assert np.array_equal(got, want)


def test_block_bits_are_the_reference_steps_bits():
    """xengine._block_bits draws, for each cycle of a block, the words
    repro.sim.xengine._step draws at that cycle (n*P*V + n*T per copy)."""
    from repro_torch import sim

    topo = sim.cin_topology("xor", 4)

    def tf(load, seed):
        return sim.uniform(4, offered=load, cycles=8, terminals=2, seed=seed)
    prep = XE._prepare(topo, "minimal", tf, [0.5], seeds=(3, 4, 5),
                       terminals=2, cycles=8, device="cpu")
    seed = hash((3, 4, 5)) & 0x7FFFFFFF
    words = 4 * 3 + 4 * 2
    got = XE._block_bits(prep.spec, prep.tb, prep.pkt,
                         torch.tensor(6, dtype=torch.int32), 3).numpy()
    base = jax.random.PRNGKey(seed)
    for j, c in enumerate(range(6, 9)):
        ck = jax.random.fold_in(base, c)
        for b in range(3):
            k = ck if b == 0 else jax.random.fold_in(ck, b)
            assert np.array_equal(got[j, b],
                                  _u32(jax.random.bits(k, (words,))))


def test_prng_key_rejects_seeds_outside_32_bits():
    with pytest.raises(ValueError):
        prng_key(-1)
    with pytest.raises(ValueError):
        prng_key(2**32)


def test_fused_multiply_add_rounds_as_xla_cpu():
    """xengine._fma32 against the reference's two float expressions
    jitted on the CPU, where XLA contracts each into one FMA: the pressure
    EWMA ``p + alpha * (d - p)`` (repro.sim.xengine:540) and the detour
    threshold ``w * c + t`` (:477).  Exact, on 2**18 values including
    decayed (tiny) pressures; rounding product and sum apart differs."""
    rng = np.random.default_rng(0)
    n = 1 << 18
    p = np.concatenate([rng.random(n // 2) * 30,
                        np.exp(rng.uniform(-80, 3, n // 2))]).astype(np.float32)
    d = rng.integers(0, 40, n).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, d: p + 0.05 * (d - p))(p, d))
    tp = torch.from_numpy(p)
    got = XE._fma32(0.05, torch.from_numpy(d).float() - tp, tp).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    c = p + rng.integers(0, 12, n).astype(np.float32)
    for w, t in [(1.3, 0.5), (2.0, 1.0), (0.7, 1e-3)]:
        want = np.asarray(jax.jit(lambda c: w * c + t)(c))
        got = XE._fma32(w, torch.from_numpy(c), t).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), w
    apart = np.float32(1.3) * c + np.float32(0.5)
    want = np.asarray(jax.jit(lambda c: 1.3 * c + 0.5)(c))
    assert not np.array_equal(apart.view(np.int32), want.view(np.int32))
