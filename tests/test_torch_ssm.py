"""repro_torch.models.ssm (the selective SSM of hymba's blocks) against the
JAX reference repro.models.ssm, on the CPU.

The reduced hymba-1.5b's widths (d 64, inner 128, state 8), the
reference's ``init_ssm`` weights copied into torch, and seeded numpy
inputs.  Tolerances as tests/test_torch_model.py's: outputs float32 atol
1e-5, bfloat16 atol 2e-2; the fp32 state h to 1e-5 of its largest
magnitude in float32 and to relative L2 5e-2 in bfloat16, the conv window
as the outputs.  Gradients (float32) as tests/test_torch_train.py holds
them: rtol 1e-4, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jax_get_config
from repro.models import ssm as JS
from repro.models.layers import AxisRules

from repro_torch.models import get_config
from repro_torch.models import ssm as TS

TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=0, atol=2e-2)}
STATE_TOL = 1e-5
STATE_REL_L2 = 5e-2
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _setup(dtype):
    """The reduced hymba config, the reference's SSM weights in the compute
    dtype (A_log and D float32, dt_bias as stored: the reference's _cast)
    on both sides."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config("hymba-1.5b").reduced(),
                               dtype=dtype)
    pj = JS.init_ssm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    pj = {k: v if k in ("A_log", "D", "dt_bias") else v.astype(dtype)
          for k, v in pj.items()}
    pt = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else getattr(torch, dtype))
        for k, v in pj.items()}
    return cfg, jcfg, pj, pt


def _x(t, cfg, dtype, seed=0, b=2):
    x = np.random.default_rng(seed).normal(size=(b, t, cfg.d_model))
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(xt.float().numpy(), dtype), xt


def _cache(cfg, dtype, seed=1, b=2):
    """A non-zero cache: conv inputs in the compute dtype, h in float32."""
    rng = np.random.default_rng(seed)
    inner = cfg.ssm_expand * cfg.d_model
    conv = rng.normal(size=(b, cfg.conv_kernel - 1, inner)).astype(np.float32)
    state = rng.normal(size=(b, inner, cfg.ssm_state)).astype(np.float32)
    ct = {"conv": torch.from_numpy(conv).to(getattr(torch, dtype)),
          "state": torch.from_numpy(state)}
    cj = {"conv": jnp.asarray(ct["conv"].float().numpy(), dtype),
          "state": jnp.asarray(state)}
    return cj, ct


def _check_state(got, want, dtype):
    for name in ("conv", "state"):
        a, b = _f32(got[name]), _f32(want[name])
        assert a.shape == b.shape and got[name].dtype == getattr(
            torch, str(want[name].dtype)), name
        if name == "conv":
            np.testing.assert_allclose(a, b, **TOL[dtype])
        elif dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=STATE_TOL * np.abs(b).max())
        else:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= STATE_REL_L2, (name, rel)


def test_init_ssm_matches_reference_tree():
    """repro.models.ssm.init_ssm: same leaves, shapes and dtypes (A_log and
    D float32 in a bf16 init), A_log, D and dt_bias equal (A_log to an fp32
    ulp: torch's log and XLA's round apart), the dense leaves' scales
    within 20% (the draws differ: torch.Generator against jax.random)."""
    cfg = get_config("hymba-1.5b").reduced()
    jcfg = jax_get_config("hymba-1.5b").reduced()
    pj = JS.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    pt = TS.init_ssm(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert list(pt) == list(pj)
    for name, a in pt.items():
        b = pj[name]
        assert tuple(a.shape) == b.shape and str(a.dtype) == \
            "torch." + str(b.dtype), name
        if name in ("A_log", "D", "dt_bias"):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1.2e-7,
                                       atol=0)
        else:
            np.testing.assert_allclose(_f32(a).std(), _f32(b).std(),
                                       rtol=0.2)
    cj = JS.init_ssm_cache(jcfg, 3)
    ct = TS.init_ssm_cache(cfg, 3, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ct.items()} == \
        {k: (v.shape, "torch." + str(v.dtype)) for k, v in cj.items()}


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("t", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_matches_reference(dtype, t, with_cache):
    """repro.models.ssm.apply_ssm at T 64 (its flat scan) and T 256 (its
    chunked scan under jax.checkpoint, two chunks of 128), from a zero
    state and from a given (conv, state) cache: output and new cache."""
    cfg, jcfg, pj, pt = _setup(dtype)
    xj, xt = _x(t, cfg, dtype)
    cj, ct = _cache(cfg, dtype) if with_cache else (None, None)
    yj, nj = JS.apply_ssm(pj, xj, jcfg, AxisRules(), cache=cj)
    yt, nt = TS.apply_ssm(pt, xt, cfg, cache=ct)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == yj.shape
    np.testing.assert_allclose(_f32(yt), _f32(yj), **TOL[dtype])
    _check_state(nt, nj, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_continue_the_prefill(dtype):
    """A prefill of 40 positions, then 3 single-position steps, each from
    the cache the previous call returned, on both sides; and the port's
    steps give the outputs of one call over all 43 positions."""
    cfg, jcfg, pj, pt = _setup(dtype)
    xj, xt = _x(43, cfg, dtype, seed=5)
    yj, cj = JS.apply_ssm(pj, xj[:, :40], jcfg, AxisRules())
    yt, ct = TS.apply_ssm(pt, xt[:, :40], cfg)
    np.testing.assert_allclose(_f32(yt), _f32(yj), **TOL[dtype])
    steps = [yt]
    for i in range(40, 43):
        yj, cj = JS.apply_ssm(pj, xj[:, i:i + 1], jcfg, AxisRules(), cache=cj)
        yt, ct = TS.apply_ssm(pt, xt[:, i:i + 1], cfg, cache=ct)
        np.testing.assert_allclose(_f32(yt), _f32(yj), **TOL[dtype])
        _check_state(ct, cj, dtype)
        steps.append(yt)
    whole, cw = TS.apply_ssm(pt, xt, cfg)
    np.testing.assert_allclose(_f32(torch.cat(steps, 1)), _f32(whole),
                               **TOL[dtype])
    a, b = _f32(ct["state"]), _f32(cw["state"])
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=STATE_TOL * np.abs(b).max())
    else:
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= STATE_REL_L2


def _serving_loop(p, x, cfg):
    """The recurrence as serving runs it, a position at a time (dec * h +
    drv, then h C): apply_ssm without grad must give its bits."""
    inner = cfg.ssm_expand * cfg.d_model
    xz = x @ p["in_proj"]
    xs, z = xz[..., :inner], xz[..., inner:]
    xc, _ = TS._causal_conv(xs, p["conv_w"])
    xc = TS.silu(xc)
    dt, b_t, c_t = TS._ssm_params(p, xc, cfg)
    a = -torch.exp(p["A_log"])
    xf = xc.float()
    h = torch.zeros((x.shape[0], inner, cfg.ssm_state))
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * xf[:, t])[..., None] * b_t[:, t, None, :])
        ys.append(torch.bmm(h, c_t[:, t, :, None])[..., 0])
    y = (torch.stack(ys, dim=1) + p["D"] * xf).to(x.dtype) * TS.silu(z)
    return y @ p["out_proj"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [200, 256])
def test_serving_output_is_the_loop_to_the_bit(dtype, t):
    """Without grad apply_ssm keeps serving's loop over positions: its
    output equals that loop's to the bit, at a flat and a chunked length
    (the chunked, checkpointed scan runs only under grad)."""
    cfg, _, _, pt = _setup(dtype)
    _, xt = _x(t, cfg, dtype, seed=4)
    with torch.no_grad():
        got, _ = TS.apply_ssm(pt, xt, cfg)
        assert torch.equal(got, _serving_loop(pt, xt, cfg))
    # and the inference-mode call (grad on, nothing requires it) too
    got2, _ = TS.apply_ssm(pt, xt, cfg)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("t", [200, 256])
def test_apply_ssm_gradients_match_reference(t):
    """Every parameter's and the input's gradient of mean(y * w) (w a
    seeded cotangent; a mean over positions, as a training loss is, the
    scale GRAD_TOL is set for) against jax.grad of
    repro.models.ssm.apply_ssm, at T 200 (the flat scan) and T 256 (two
    chunks of 128, each under a checkpoint; the reference's under
    jax.checkpoint), in float32."""
    cfg, jcfg, pj, pt = _setup("float32")
    xj, xt = _x(t, cfg, "float32", seed=6)
    w = (np.random.default_rng(7).normal(size=(2, t, cfg.d_model))
         / (2 * t)).astype(np.float32)

    def ref_loss(p, x):
        y, _ = JS.apply_ssm(p, x, jcfg, AxisRules())
        return jnp.sum(y * w)
    gpj, gxj = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(pj, xj)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    x = xt.clone().requires_grad_(True)
    y, _ = TS.apply_ssm(leaves, x, cfg)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_f32(x.grad), _f32(gxj), **GRAD_TOL)
    for name, leaf in leaves.items():
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(_f32(leaf.grad), _f32(gpj[name]),
                                   err_msg=name, **GRAD_TOL)


def _saved_bytes(fn):
    """Bytes of the distinct storages autograd saves for the backward while
    ``fn`` runs (a checkpointed region saves through its own hooks and
    shows none)."""
    seen = {}

    def pack(a):
        seen[a.untyped_storage().data_ptr()] = a.untyped_storage().nbytes()
        return a
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda a: a):
        fn()
    return sum(seen.values())


def test_chunked_scan_keeps_only_chunk_boundaries():
    """Under grad, the scan at T 1024 (eight checkpointed chunks) saves less
    than a fifth of what the flat scan at T 1000 saves (its every carry,
    decay and output); the whole SSM saves less than half."""
    cfg, _, _, pt = _setup("float32")
    inner, state = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    rng = np.random.default_rng(8)

    def scan(t):
        f = lambda *s: torch.from_numpy(  # noqa: E731
            rng.normal(size=s).astype(np.float32)).requires_grad_(True)
        dt = torch.nn.functional.softplus(f(2, t, inner))
        args = (torch.zeros((2, inner, state)), dt, f(2, t, state),
                f(2, t, state), f(2, t, inner), -torch.exp(f(inner, state)))
        return lambda: TS._scan_grad(*args)

    def layer(t):
        p = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
        return lambda: TS.apply_ssm(p, _x(t, cfg, "float32")[1], cfg)
    chunked, flat = _saved_bytes(scan(1024)), _saved_bytes(scan(1000))
    assert flat > 0 and chunked < flat / 5, (chunked, flat)
    assert _saved_bytes(layer(1024)) < _saved_bytes(layer(1000)) / 2
