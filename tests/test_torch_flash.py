"""repro_torch.models.flash (the flash-attention autograd Function) against
the JAX reference repro.models.flash, on the CPU.

On the CPU the Function's forward is the attention kernel's plain version
with its log-sum-exp; its backward is the port of ``_flash_bwd``.  Both
are held to ``jax.vjp`` of ``flash_attention_jnp`` (o, lse, dq, dk, dv)
and, on cases where every query sees a key, to ``jax.grad`` of
``attention_naive``.  Inputs and the output cotangent are numpy draws
from a seed; fp32, rtol 1e-5, and atol 5e-6 for entries near 0, which the
two reach by cancelling O(1) terms summed in other orders (about ten fp32
ulps of those terms).  The reference side of each case is one ``jax.jit``
of the vjp, computed once per case and shared by the tests.

Mask conventions: the port masks a key by ``kv_pos < 0``, the reference's
``_mask`` by ``kv_pos == int32 max``; the reference gets the port's
``kv_pos`` with every negative entry mapped to int32 max.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as JF
from repro.models.layers import attention_naive

from repro_torch.kernels import ops
from repro_torch.models import flash as TF

TOL = dict(rtol=1e-5, atol=5e-6)
I32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small models run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them made these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# name: (b, t, s, h, kvh, d, q_pos, kv_pos, causal, window).  q_pos None =
# arange(t), "tail" = the last t of s positions; kv_pos None = arange(s),
# else a list (negative = masked).
CASES = {
    "gqa3_causal": (2, 40, 40, 6, 2, 16, None, None, True, 0),
    "gqa2_window5": (1, 33, 33, 4, 2, 32, None, None, True, 5),
    "mha_d64": (1, 24, 24, 2, 2, 64, None, None, True, 0),
    "mqa_tail_noncausal_window": (1, 20, 50, 3, 1, 16, "tail", None, False,
                                  9),
    "rows_see_nothing": (1, 16, 32, 6, 2, 16, list(range(-8, 8)), None,
                         True, 0),
    "padded_keys": (2, 20, 27, 4, 2, 16, "tail",
                    list(range(20)) + [-1] * 7, True, 0),
    # gemma3-1b's head dim and group (H4 KV1), a window
    "mqa_d256_window": (1, 24, 24, 4, 1, 256, None, None, True, 5),
}
ALL_SEEN = ["gqa3_causal", "gqa2_window5", "mha_d64",
            "mqa_tail_noncausal_window", "mqa_d256_window"]


def _case(name):
    b, t, s, h, kvh, d, q_pos, kv_pos, causal, window = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    do = rng.normal(size=(b, t, h, d)).astype(np.float32)
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    q_pos = np.asarray(range(t) if q_pos is None else q_pos, np.int32)
    kv_pos = np.asarray(range(s) if kv_pos is None else kv_pos, np.int32)
    return q, k, v, do, q_pos, kv_pos, causal, window


def _torch_grads(q, k, v, do, q_pos, kv_pos, causal, window):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = TF.flash_attention(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                           kv_pos=torch.from_numpy(kv_pos), window=window,
                           causal=causal)
    o.backward(torch.from_numpy(do))
    return o.detach(), tq.grad, tk.grad, tv.grad


def _ref_kv_pos(kv_pos):
    return jnp.asarray(np.where(kv_pos < 0, I32_MAX, kv_pos), jnp.int32)


@functools.lru_cache(maxsize=None)
def _reference(name, naive=False):
    """(o, dq, dk, dv) by jax.vjp of flash_attention_jnp (blocks of 16
    queries and 8 keys), or of attention_naive; and the lse of
    ``_flash_fwd_impl`` (None for naive), as numpy."""
    q, k, v, do, q_pos, kv_pos, causal, window = _case(name)
    qp, kp = jnp.asarray(q_pos), _ref_kv_pos(kv_pos)
    w = jnp.asarray(window, jnp.int32)

    def attend(q_, k_, v_):
        if naive:
            return attention_naive(q_, k_, v_, q_pos=qp, kv_pos=kp,
                                   window=w, causal=causal)
        return JF.flash_attention_jnp(q_, k_, v_, qp, kp, w, causal, 16, 8)

    @jax.jit
    def run(q_, k_, v_, do_):
        o, vjp = jax.vjp(attend, q_, k_, v_)
        lse = (None if naive else JF._flash_fwd_impl(
            q_, k_, v_, qp, kp, w, causal, 16, 8)[1])
        return (o, *vjp(do_)), lse
    grads, lse = run(*(jnp.asarray(a) for a in (q, k, v, do)))
    return ([np.asarray(a) for a in grads],
            None if lse is None else np.asarray(lse))


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_flash_jnp_vjp(name):
    """o, dq, dk, dv against jax.vjp of repro.models.flash.
    flash_attention_jnp (blocks of 16 queries and 8 keys)."""
    got = _torch_grads(*_case(name))
    for g, w in zip(got, _reference(name)[0]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_matches_reference(name):
    """The forward's log-sum-exp (the plain version's, on the CPU) against
    the reference's ``_flash_fwd_impl``: 1e30 on rows that see no key."""
    q, k, v, _, q_pos, kv_pos, causal, window = _case(name)
    b, t, h, _ = q.shape
    lse_j = _reference(name)[1]
    o, lse = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos),
        causal=causal, window=window, return_lse=True)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_j.reshape(b, h, t), **TOL)
    assert torch.equal(o, ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos),
        causal=causal, window=window))
    if name == "rows_see_nothing":
        assert (lse[:, :, :8] == TF.LSE_EMPTY).all()
        assert (lse[:, :, 8:] < 1e29).all()


@pytest.mark.parametrize("name", ALL_SEEN)
def test_function_matches_naive_attention_grad(name):
    """o, dq, dk, dv against jax.vjp of repro.models.layers.
    attention_naive, the reference's training attention at S <= 2048."""
    got = _torch_grads(*_case(name))
    for g, w in zip(got, _reference(name, naive=True)[0]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name", ["gqa3_causal", "padded_keys",
                                  "rows_see_nothing"])
def test_blocked_backward_matches_reference_blocks(name):
    """flash_backward with blocks of 16 queries and 8 keys (ragged last
    blocks) equals the whole-tensor backward and the reference's."""
    q, k, v, do, q_pos, kv_pos, causal, window = _case(name)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    pos = (torch.from_numpy(q_pos), torch.from_numpy(kv_pos))
    o, lse = ops.flash_attention(*args, q_pos=pos[0], kv_pos=pos[1],
                                 causal=causal, window=window,
                                 return_lse=True)
    kw = dict(window=window, causal=causal)
    small = TF.flash_backward(*args, *pos, o, lse, torch.from_numpy(do),
                              q_block=16, kv_chunk=8, **kw)
    whole = TF.flash_backward(*args, *pos, o, lse, torch.from_numpy(do), **kw)
    for a, b, w in zip(small, whole, _reference(name)[0][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        np.testing.assert_allclose(a.numpy(), w, **TOL)
    if name == "rows_see_nothing":
        assert not small[0][:, :8].any()        # no gradient where no key


def test_backward_is_counted_and_forward_reaches_the_kernel_entry(
        monkeypatch):
    """The Function's forward calls ops.flash_attention with
    return_lse=True (on the card: the kernel wrapper), once; its backward
    adds one to ``backward_calls``."""
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("return_lse"))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    q, k, v, do, q_pos, kv_pos, causal, window = _case("gqa3_causal")
    before = TF.backward_calls
    _torch_grads(q, k, v, do, q_pos, kv_pos, causal, window)
    assert calls == [True] and TF.backward_calls == before + 1


@pytest.mark.parametrize("t,window", [(5000, 0), (3000, 700), (1024, 0)])
def test_block_bounds_equal_reference(t, window):
    for causal in (True, False):
        kw = dict(causal=causal, window=window, q_block=1024, kv_chunk=512)
        assert TF.block_bounds(t, t, **kw) == JF.block_bounds(t, t, **kw)


def test_layer_attention_takes_the_function_only_under_grad():
    """layers.attention: the Function when grad mode is on and an input
    requires grad, else the kernel entry; both give the same o."""
    from repro_torch.models import layers as TL
    q, k, v, _, q_pos, kv_pos, causal, window = _case("gqa3_causal")
    args = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos),
              window=window, causal=causal)
    plain = TL.attention(*args, **kw)
    assert plain.grad_fn is None
    live = TL.attention(args[0].requires_grad_(True), *args[1:], **kw)
    assert type(live.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(live.detach(), plain, rtol=0, atol=0)
    with torch.no_grad():
        assert TL.attention(*args, **kw).grad_fn is None
