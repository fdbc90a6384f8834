"""repro_torch's xLSTM parts against the JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, go through each JAX function and
its port: the mLSTM cell math of ``repro.models.xlstm`` (sequential oracle
and chunkwise), ``ops.mlstm_scan`` (on the CPU the kernel's plain version)
against the Pallas kernel ``repro.kernels.ops.mlstm_scan`` in interpret
mode, the sLSTM scan, the causal convolution of ``repro.models.ssm``, and
one mLSTM and one sLSTM block on weights converted by ``params_from_numpy``.
The CUDA kernel itself is held against its plain version in
tests/test_torch_cuda.py.

Tolerances.  Where both sides run the same algorithm in float32, each
element is held to 1e-5 of the array's largest magnitude: the sums are
taken in other orders, and h = num / den amplifies their rounding where
|den| is small (one element of 12288 differs by 4e-5 of its own value, 5e-7
of the array's largest, |h| reaching 30).  Across algorithms (sequential
against chunkwise, the Pallas kernel against the chunkwise plain version):
rtol 5e-4, atol 5e-5, as tests/test_kernels.py.  bfloat16 inputs: 5e-2, as
there.  Blocks in bfloat16: atol 2e-2 on outputs of magnitude about 1 to 5,
a few bf16 ulps, as tests/test_torch_model.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import mlstm_scan as pallas_mlstm_scan
from repro.models import get_config as jax_get_config
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.models.layers import AxisRules

from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import ops
from repro_torch.kernels.ref import reference_mlstm, reference_mlstm_scan
from repro_torch.models import get_config, params_from_numpy
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX

SAME = 1e-5            # of the array's largest magnitude
ACROSS = dict(rtol=5e-4, atol=5e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
BLOCK_TOL = {"float32": dict(rtol=0, atol=1e-5),
             "bfloat16": dict(rtol=0, atol=2e-2)}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(x, dtype="float32"):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), dtype), t


def _mlstm_inputs(seed, b, t, h, d, dtype="float32", state=False):
    """q, k, v, log_i, log_f (and an initial state) as jnp and torch."""
    rng = np.random.default_rng(seed)
    qkv = [_pair(rng.normal(size=(b, t, h, d)), dtype) for _ in range(3)]
    li = rng.normal(size=(b, t, h)) * 2
    pre_f = rng.normal(size=(b, t, h)) * 2 + 1
    lf = -np.logaddexp(0.0, -pre_f)                    # log_sigmoid
    gates = [_pair(li), _pair(lf)]
    jx = [a for a, _ in qkv + gates]
    tx = [a for _, a in qkv + gates]
    if not state:
        return jx, tx, None, None
    st = [_pair(rng.normal(size=(b, h, d, d)) * 0.1),
          _pair(np.abs(rng.normal(size=(b, h, d)))),
          _pair(rng.normal(size=(b, h)))]
    return jx, tx, tuple(a for a, _ in st), tuple(a for _, a in st)


def _assert_all_close(got, want, tol):
    """``tol``: rtol/atol, or SAME (relative to the array's scale)."""
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        kw = (dict(rtol=0, atol=tol * np.abs(w).max())
              if isinstance(tol, float) else tol)
        np.testing.assert_allclose(g, w, **kw)


@pytest.mark.parametrize("state", [False, True])
def test_mlstm_sequential_matches_reference(state):
    """repro.models.xlstm.mlstm_sequential: h and the final (C, n, m)."""
    jx, tx, js, ts = _mlstm_inputs(1, 2, 40, 2, 16, state=state)
    hj, sj = JX.mlstm_sequential(*jx, js)
    ht, st = TX.mlstm_sequential(*tx, ts)
    assert ht.dtype == torch.float32 and ht.shape == tx[0].shape
    _assert_all_close([ht, *st], [hj, *sj], SAME)
    _assert_all_close([reference_mlstm(*tx, ts)[0]], [hj], SAME)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("chunk", [16, 48])
def test_mlstm_chunkwise_matches_reference(chunk, state):
    """repro.models.xlstm.mlstm_chunkwise: h and the final (C, n, m); and
    against the port's own sequential oracle."""
    jx, tx, js, ts = _mlstm_inputs(2, 2, 96, 2, 32, state=state)
    hj, sj = JX.mlstm_chunkwise(*jx, js, chunk=chunk)
    ht, st = TX.mlstm_chunkwise(*tx, ts, chunk=chunk)
    _assert_all_close([ht, *st], [hj, *sj], SAME)
    hs, ss = TX.mlstm_sequential(*tx, ts)
    _assert_all_close([ht, *st], [hs, *ss], ACROSS)


def test_mlstm_chunkwise_refuses_a_ragged_length():
    _, tx, _, _ = _mlstm_inputs(3, 1, 40, 1, 16)
    with pytest.raises(ValueError, match="multiple"):
        TX.mlstm_chunkwise(*tx, chunk=16)


# The sweep of tests/test_kernels.py::test_mlstm_pallas_kernel_vs_oracle.
@pytest.mark.parametrize("b,t,h,d,chunk", [
    (1, 64, 1, 16, 16),
    (2, 128, 3, 32, 32),
    (2, 256, 2, 64, 64),
    (1, 96, 2, 32, 48),
])
def test_ops_mlstm_scan_matches_pallas_kernel(b, t, h, d, chunk):
    """ops.mlstm_scan on CPU tensors (the plain version) vs the Pallas
    kernel repro.kernels.ops.mlstm_scan(interpret=True), which starts from
    a zero state; the returned state vs repro.models.xlstm.mlstm_chunkwise."""
    jx, tx, _, _ = _mlstm_inputs(b * t + d, b, t, h, d)
    want = pallas_mlstm_scan(*jx, chunk=chunk, interpret=True)
    got, state = ops.mlstm_scan(*tx, chunk=chunk)
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **ACROSS)
    _, sj = JX.mlstm_chunkwise(*jx, chunk=chunk)
    _assert_all_close(state, sj, SAME)


def test_ops_mlstm_scan_bf16_matches_pallas_kernel():
    """bfloat16 q/k/v: h in bfloat16, against the Pallas kernel (5e-2)."""
    jx, tx, _, _ = _mlstm_inputs(11, 1, 64, 2, 32, dtype="bfloat16")
    want = pallas_mlstm_scan(*jx, chunk=32, interpret=True)
    got, _ = ops.mlstm_scan(*tx, chunk=32)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    ref, _ = reference_mlstm_scan(*tx, chunk=32)
    np.testing.assert_array_equal(_f32(got), _f32(ref))


def test_ops_mlstm_scan_continues_a_state():
    """Two calls, the second from the first's state, equal one call over
    both halves (the contract decode relies on)."""
    _, tx, _, _ = _mlstm_inputs(5, 2, 128, 2, 32)
    whole, s_whole = ops.mlstm_scan(*tx, chunk=32)
    first, s1 = ops.mlstm_scan(*(a[:, :64] for a in tx), chunk=32)
    second, s2 = ops.mlstm_scan(*(a[:, 64:] for a in tx), s1, chunk=32)
    _assert_all_close([torch.cat([first, second], 1), *s2],
                      [whole, *s_whole], SAME)


# -- the scan under autograd (MLSTMScan) --------------------------------------

# name: (b, t, h, d, chunk, gates): log_i ~ N(0, 2) and log_f = log_sigmoid
# of N(1, 2), as _mlstm_inputs draws them; "input_x30" scales log_i by 30,
# "forget_minus40" shifts the forget pre-activation by -40 (log_f near
# -40: each step forgets nearly all), "first_gate_minus100" opens every
# sequence with log_i = -100, below float32's exponent range (exp(100)
# overflows), where the reference's gradient is NaN.
GRAD_CASES = {
    "one_chunk": (2, 16, 2, 16, 16, "normal"),
    "four_chunks": (2, 64, 2, 16, 16, "normal"),
    "input_x30": (2, 64, 2, 16, 16, "input_x30"),
    "forget_minus40": (2, 64, 2, 16, 16, "forget_minus40"),
    "first_gate_minus100": (2, 64, 2, 16, 16, "first_gate_minus100"),
    "bh1": (1, 64, 1, 16, 16, "normal"),
}
GRAD_TOL = 1e-4        # of each gradient's largest magnitude


def _grad_inputs(name):
    """q, k, v, log_i, log_f and the output gradient dh, as numpy."""
    b, t, h, d, chunk, gates = GRAD_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, dh = (rng.normal(size=(b, t, h, d)).astype(np.float32)
                   for _ in range(4))
    li = rng.normal(size=(b, t, h)) * 2
    pre_f = rng.normal(size=(b, t, h)) * 2 + 1
    if gates == "input_x30":
        li = li * 30
    if gates == "forget_minus40":
        pre_f = pre_f - 40
    if gates == "first_gate_minus100":
        li[:, 0] = -100.0
    lf = -np.logaddexp(0.0, -pre_f)                    # log_sigmoid
    return ([q, k, v, li.astype(np.float32), lf.astype(np.float32)], dh,
            chunk)


@functools.lru_cache(maxsize=None)
def _reference_grads(name):
    """jax.grad of sum(h * dh) through repro.models.xlstm.mlstm_chunkwise."""
    x, dh, chunk = _grad_inputs(name)
    fn = jax.jit(jax.grad(lambda *a: jnp.sum(
        JX.mlstm_chunkwise(*a, chunk=chunk)[0] * dh), argnums=range(5)))
    return [np.asarray(g) for g in fn(*x)]


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_mlstm_scan_function_grads_match_reference(name):
    """MLSTMScan on CPU tensors (forward: the kernel's plain version;
    backward: mlstm_chunkwise recomputed) against jax.grad of
    repro.models.xlstm.mlstm_chunkwise: dq, dk, dv, dlog_i and dlog_f
    within GRAD_TOL of each one's largest magnitude, and finite everywhere.
    Where the reference's gradient is NaN (exp(-m) overflows at a row whose
    stabilizer m is below -88.7, and 0 * inf is NaN), the port's is finite
    and within the same tolerance of 0, the limit of the exact gradient
    there (h itself underflows to 0)."""
    x, dh, chunk = _grad_inputs(name)
    want = _reference_grads(name)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    before = TX.backward_calls
    h, (C, n, m) = TX.mlstm_scan_grad(*leaves, chunk=chunk)
    assert h.dtype == torch.float32 and not C.requires_grad
    got = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    assert TX.backward_calls == before + 1
    hj, _ = JX.mlstm_chunkwise(*x, chunk=chunk)
    _assert_all_close([h], [hj], SAME)
    for what, g, w in zip(("dq", "dk", "dv", "dlog_i", "dlog_f"), got, want):
        g = g.numpy()
        assert np.isfinite(g).all(), what
        ok = np.isfinite(w)
        scale = np.abs(w[ok]).max()
        np.testing.assert_allclose(g, np.where(ok, w, 0.0), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=what)
    if name == "first_gate_minus100":     # the case the reference fails
        assert not all(np.isfinite(w).all() for w in want)


def test_mlstm_sequential_grads_are_finite_where_reference_is_nan():
    """Autograd through mlstm_sequential (the path of lengths that are not
    a multiple of the chunk) on the first_gate_minus100 inputs, against
    jax.grad of repro.models.xlstm.mlstm_sequential, whose gradient is NaN
    there: the port's is finite, within GRAD_TOL of the reference's where
    that is finite and of 0 where it is not."""
    x, dh, _ = _grad_inputs("first_gate_minus100")
    want = [np.asarray(g) for g in jax.jit(jax.grad(lambda *a: jnp.sum(
        JX.mlstm_sequential(*a)[0] * dh), argnums=range(5)))(*x)]
    assert not all(np.isfinite(w).all() for w in want)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    h, _ = TX.mlstm_sequential(*leaves)
    got = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        ok = np.isfinite(w)
        np.testing.assert_allclose(g, np.where(ok, w, 0.0), rtol=0,
                                   atol=GRAD_TOL * np.abs(w[ok]).max())


def test_mlstm_scan_function_takes_no_state():
    _, tx, _, ts = _mlstm_inputs(7, 1, 32, 1, 16, state=True)
    with pytest.raises(ValueError, match="zero state"):
        TX.mlstm_scan_grad(*tx, ts, chunk=16)


def test_mlstm_block_takes_the_function_under_grad(monkeypatch):
    """Under grad, a length that is a multiple of the chunk goes through
    MLSTMScan, which reaches ops.mlstm_scan once in its forward and counts
    one backward; other lengths take mlstm_sequential under autograd."""
    _, ct, _, pt = _block("mlstm", "float32")
    calls = []
    scan = ops.mlstm_scan
    monkeypatch.setattr(ops, "mlstm_scan",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or scan(*a, **kw))
    p = {k: v.detach().requires_grad_(True) for k, v in pt.items()}
    for t in (1, 32, 40, 64):
        before = TX.backward_calls
        x = torch.randn((1, t, ct.d_model), generator=torch.Generator()
                        .manual_seed(t))
        out, _ = TX.apply_mlstm_block(p, x, ct, chunk=32)
        g = torch.autograd.grad(out.sum(), p["wq"])[0]
        assert torch.isfinite(g).all() and g.any()
        assert TX.backward_calls == before + (t % 32 == 0)
    assert calls == [32, 64]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: CPU tensors go through ops."""
    _, tx, _, _ = _mlstm_inputs(6, 1, 16, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ms.mlstm_scan(*tx, chunk=16)


@pytest.mark.parametrize("state", [False, True])
def test_slstm_scan_matches_reference(state):
    """repro.models.xlstm.slstm_scan: h per step and the final (h, c, n, m)."""
    rng = np.random.default_rng(7)
    b, t, nh, d = 2, 24, 4, 32
    wx = _pair(rng.normal(size=(b, t, 4 * d)))
    r = _pair(rng.normal(size=(nh, d // nh, 4 * d // nh)) / np.sqrt(d // nh))
    if state:
        init = [_pair(rng.normal(size=(b, d))) for _ in range(2)] + [
            _pair(np.abs(rng.normal(size=(b, d))) + 0.5),
            _pair(rng.normal(size=(b, d)))]
    else:
        z = np.zeros((b, d))
        init = [_pair(z), _pair(z), _pair(z), _pair(np.full((b, d), -np.inf))]
    hj, sj = JX.slstm_scan(wx[0], r[0], *(a for a, _ in init), nh=nh)
    ht, st = TX.slstm_scan(wx[1], r[1], *(a for _, a in init), nh=nh)
    _assert_all_close([ht, *st], [hj, *sj], SAME)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype, with_state):
    """repro.models.ssm._causal_conv: output and the new state, in the
    input's dtype; a given state is cast to it."""
    rng = np.random.default_rng(8)
    x = _pair(rng.normal(size=(2, 7, 12)), dtype)
    w = _pair(rng.normal(size=(4, 12)), dtype)
    st = _pair(rng.normal(size=(2, 3, 12))) if with_state else (None, None)
    yj, nj = JS._causal_conv(x[0], w[0], st[0])
    yt, nt = TS._causal_conv(x[1], w[1], st[1])
    assert yt.dtype == nt.dtype == x[1].dtype and str(nj.dtype) == dtype
    tol = dict(rtol=0, atol=0) if dtype == "bfloat16" else SAME
    _assert_all_close([yt, nt], [yj, nj], tol)


def _block(kind, dtype):
    """Layer `kind` of the reduced xlstm-350m: its reference parameters
    (cast as the reference's _run_body casts them) and the port's, converted
    by params_from_numpy and cast once by cast_params."""
    cj = dataclasses.replace(jax_get_config("xlstm-350m").reduced(), dtype=dtype)
    ct = dataclasses.replace(get_config("xlstm-350m").reduced(), dtype=dtype)
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    pt = TT.cast_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, pj), ct, device="cpu"), ct)
    layer = ct.block_pattern.index(kind)
    run = [r.kind for r in JT.build_runs(cj)].index(kind)
    pjl = JT._cast(jax.tree_util.tree_map(lambda a: a[0], pj["stack"][run]),
                   cj.dtype)
    return cj, ct, pjl, pt["layers"][layer]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 5, 64])
def test_mlstm_block_matches_reference(t, dtype):
    """repro.models.xlstm.apply_mlstm_block on converted weights: prefill
    (no cache) at T = 1 and 5 (sequential) and 64 (chunkwise, chunk 32);
    then one decode step from the returned cache."""
    cj, ct, pj, pt = _block("mlstm", dtype)
    x = np.random.default_rng(9).normal(size=(2, t, cj.d_model))
    xj, xt = _pair(x, dtype)
    oj, cache_j = JX.apply_mlstm_block(pj, xj, cj, AxisRules(), chunk=32)
    ot, cache_t = TX.apply_mlstm_block(pt, xt, ct, chunk=32)
    assert ot.dtype == xt.dtype
    np.testing.assert_allclose(_f32(ot), _f32(oj), **BLOCK_TOL[dtype])
    assert {k: str(v.dtype).removeprefix("torch.")
            for k, v in cache_t.items()} == {k: str(v.dtype)
                                             for k, v in cache_j.items()}
    yj, yt = _pair(np.random.default_rng(10).normal(size=(2, 1, cj.d_model)),
                   dtype)
    oj, _ = JX.apply_mlstm_block(pj, yj, cj, AxisRules(), cache=cache_j)
    ot, _ = TX.apply_mlstm_block(pt, yt, ct, cache=cache_t)
    np.testing.assert_allclose(_f32(ot), _f32(oj), **BLOCK_TOL[dtype])


def test_mlstm_block_dispatch_follows_reference(monkeypatch):
    """A length that is a multiple of the chunk goes to ops.mlstm_scan (the
    kernel on the card); T = 1 and any other length to mlstm_sequential."""
    _, ct, _, pt = _block("mlstm", "float32")
    calls = []
    scan = ops.mlstm_scan
    monkeypatch.setattr(ops, "mlstm_scan",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or scan(*a, **kw))
    for t in (1, 32, 40, 64):
        x = torch.zeros((1, t, ct.d_model))
        TX.apply_mlstm_block(pt, x, ct, chunk=32)
    assert calls == [32, 64]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_matches_reference(dtype):
    """repro.models.xlstm.apply_slstm_block on converted weights: prefill
    (no cache), then one step from the returned cache."""
    cj, ct, pj, pt = _block("slstm", dtype)
    xj, xt = _pair(np.random.default_rng(11).normal(size=(2, 9, cj.d_model)),
                   dtype)
    oj, cache_j = JX.apply_slstm_block(pj, xj, cj, AxisRules())
    ot, cache_t = TX.apply_slstm_block(pt, xt, ct)
    np.testing.assert_allclose(_f32(ot), _f32(oj), **BLOCK_TOL[dtype])
    yj, yt = _pair(np.random.default_rng(12).normal(size=(2, 1, cj.d_model)),
                   dtype)
    oj, _ = JX.apply_slstm_block(pj, yj, cj, AxisRules(), cache=cache_j)
    ot, _ = TX.apply_slstm_block(pt, yt, ct, cache=cache_t)
    np.testing.assert_allclose(_f32(ot), _f32(oj), **BLOCK_TOL[dtype])


def test_recurrent_caches_match_reference_init():
    """repro.models.transformer.init_caches for xlstm-350m: one cache per
    layer with the reference's leaves, shapes, dtypes and values."""
    cj = jax_get_config("xlstm-350m").reduced()
    ct = get_config("xlstm-350m").reduced()
    ref = JT.init_caches(cj, 3, 16)
    ours = TT.init_caches(ct, 3, 16, device="cpu")
    layer = 0
    for run, stacked in zip(JT.build_runs(cj), ref):
        for i in range(run.count):
            mine = ours[layer]
            assert set(mine) == set(stacked)
            for n, a in stacked.items():
                assert str(mine[n].dtype).removeprefix("torch.") == str(a.dtype)
                np.testing.assert_array_equal(_f32(mine[n]), _f32(a[i]))
            layer += 1
    assert layer == len(ours) == ct.num_layers
