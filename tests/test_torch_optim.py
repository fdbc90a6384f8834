"""repro_torch.optim against the JAX reference repro.optim, on the CPU.

The same numpy trees (seeded) go through ``repro.optim.adamw_update`` in
the reference's stacked layout and through the port's ``adamw_update`` in
the port's per-layer layout, in fp32 and in the same order of operations
(the reference jitted, where XLA:CPU may contract a product and a sum into
one FMA, C6), so the differences are the last bits of those FMAs, of
``pow`` and ``cos``, and the order of the global norm's fp32 sum (about
1e-6 relative over 1e6 squares).  That norm scales every
gradient through the clip, and a step moves a parameter by
``lr * delta``, so the states are drawn at the scale of a running AdamW
state (v >= 1e-4, so ``delta`` stays O(1)).  rtol 1e-6, with atol 5e-7
(four fp32 ulps of a unit-sized operand) for elements near 0, where
``b1 * m + (1 - b1) * g`` or ``p - lr * delta`` cancels and one rounding
of an O(1) addend is a large share of the result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JOpt
from repro.optim import adamw as JA

from repro_torch.models import get_config, numpy_from_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import (OptConfig, adamw_update, clip_by_global_norm,
                               global_norm, init_opt_state, schedule)
from repro_torch.optim.adamw import _decay_mask, tree_leaves

TOL = dict(rtol=1e-6, atol=5e-7)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small models run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them made these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(cfg, rng, scale=1.0):
    """A tree of the reference's layout for ``cfg`` (stacked runs), numpy
    fp32 normals: the reference's ``init_params`` shapes."""
    import repro.models.transformer as JT
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32),
        shapes)


def _configs():
    """Reduced lacin-demo with attention and MLP biases (``bo``, ``bi``
    per layer: 1-D in the port, 2-D stacked in the reference) and
    reduced granite-moe-3b-a800m."""
    import repro.models as JM
    out = []
    for arch, extra in (("lacin-demo", dict(attn_bias=True, mlp_bias=True)),
                        ("granite-moe-3b-a800m", {})):
        out.append((dataclasses.replace(JM.get_config(arch).reduced(),
                                        **extra),
                    dataclasses.replace(get_config(arch).reduced(), **extra)))
    return out


def _ported(tree, cfg):
    return params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("step0", [0, 7])
def test_adamw_update_matches_reference(which, step0):
    """One update from random m, v (and step ``step0``) on a tree with a
    per-layer bias: params, m, v, grad_norm and lr equal the reference's."""
    cj, ct = _configs()[which]
    rng = np.random.default_rng(which + step0)
    p, g = _tree(cj, rng), _tree(cj, rng, scale=0.3)
    m = _tree(cj, rng, 0.1)
    v = jax.tree_util.tree_map(lambda a: 1e-4 + a * a, _tree(cj, rng, 0.1))
    opt = OptConfig(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=100.0)
    jst = {"m": m, "v": v, "step": jnp.asarray(step0, jnp.int32)}
    jopt = JOpt(**dataclasses.asdict(opt))
    jp, jst2, jmet = jax.jit(JA.adamw_update, static_argnums=3)(p, g, jst,
                                                                jopt)
    tst = {"m": _ported(m, ct), "v": _ported(v, ct),
           "step": torch.tensor(step0, dtype=torch.int32)}
    tp, tst2, tmet = adamw_update(_ported(p, ct), _ported(g, ct), tst, opt)
    for got, want in ((tp, jp), (tst2["m"], jst2["m"]),
                      (tst2["v"], jst2["v"])):
        for a, b in zip(jax.tree_util.tree_leaves(numpy_from_params(got, ct)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert int(tst2["step"]) == int(jst2["step"]) == step0 + 1
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    # The norm sums ~1e6 fp32 squares, and the reference's jnp.sum is
    # about 1e-6 off the float64 sum on granite's tree, so the port's is
    # held to float64 at 1e-6 and to the reference at 1e-5.
    exact = np.sqrt(sum(np.square(a.astype(np.float64)).sum()
                        for a in jax.tree_util.tree_leaves(g)))
    np.testing.assert_allclose(float(tmet["grad_norm"]), exact, rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)


def test_stacked_bias_decays_as_in_reference():
    """A per-layer ``bo`` (1-D here, 2-D stacked there) decays; a norm
    scale does not; weight decay alone moves exactly those leaves."""
    cj, ct = _configs()[0]
    rng = np.random.default_rng(3)
    p = _tree(cj, rng)
    zeros = jax.tree_util.tree_map(np.zeros_like, p)
    opt = OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    tp, _, _ = adamw_update(_ported(p, ct), _ported(zeros, ct),
                            init_opt_state(_ported(p, ct)), opt)
    jp, _, _ = jax.jit(JA.adamw_update, static_argnums=3)(
        p, zeros, JA.init_opt_state(p), JOpt(**dataclasses.asdict(opt)))
    moved = numpy_from_params(tp, ct)
    assert not np.array_equal(moved["stack"][0]["attn"]["bo"],
                              p["stack"][0]["attn"]["bo"])
    assert np.array_equal(moved["stack"][0]["ln1"]["scale"],
                          p["stack"][0]["ln1"]["scale"])
    for a, b in zip(jax.tree_util.tree_leaves(moved),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("path,want", [
    (("layers", 0, "attn", "bo"), True),
    (("layers", 1, "ln1", "scale"), False),
    (("final_norm", "scale"), False), (("embed", "table"), True),
    (("layers", 0, "mlp", "bias"), False), (("layers", 2, "q_scale"), False)])
def test_decay_mask_names_as_reference(path, want):
    jpath = tuple(jax.tree_util.DictKey(k) if isinstance(k, str)
                  else jax.tree_util.SequenceKey(k) for k in path)
    assert JA._decay_mask(jpath) == _decay_mask(path) == want


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 100, 150])
def test_schedule_matches_reference(step):
    opt = OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    want = float(JA.schedule(JOpt(**dataclasses.asdict(opt)),
                             jnp.asarray(step, jnp.int32)))
    got = float(schedule(opt, torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(5)
    g = {"a": rng.normal(size=(7, 3)).astype(np.float32),
         "b": [rng.normal(size=(11,)).astype(np.float32)]}
    jc, jn = JA.clip_by_global_norm(g, 1.0)
    tg = {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]}
    tc, tn = clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(tg)), float(jn), rtol=1e-6)
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    small, n = clip_by_global_norm(tg, 1e6)         # under the limit: as is
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(small),
                                                 tree_leaves(tg)))


def test_adamw_minimizes_quadratic():
    """repro's tests/test_substrates.py case, on the port."""
    opt = OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, opt)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state["step"]) == 150 and state["m"]["w"].dtype == torch.float32
