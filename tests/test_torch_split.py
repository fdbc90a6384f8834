"""A CPU model of the split precision of the fp32 tensor-core kernels,
attention (csrc/flash_attention_fp32tc.cu) and the mLSTM scan
(csrc/mlstm_scan_fp32tc.cu, in its order of passes and steps), and of the
check an fp32 scan is held to (mlstm_scan.check_fp32, ROADMAP C21).

Each fp32 operand is split into bf16 terms, each the top 8 significant
bits of what the terms before it leave (truncation), and each product is
the sum of the term products a_i b_j with i + j < terms, smallest first,
accumulated in fp32.  The term count is the attention wrapper's
``FP32_TERMS``, the constant the kernel's ``kTerms`` mirrors, so that the
model and the kernel read one number.  Here the model is held to float64
within a quarter of the fp32 attention tolerance (2e-5 / 4) on hazard
inputs, with one term fewer shown to miss that margin, and to the Pallas
kernels in interpret mode at the repo's fp32 tolerances (attention 2e-5;
mLSTM rtol 5e-4, atol 5e-5).  On a C21 hazard (D 512, forget gates near
one) the scan model meets check_fp32 against float64, and a scan with two
terms or with its chunk state rounded once to bf16 fails it.  The kernels
themselves are held to their plain versions on the card
(tests/test_torch_cuda.py).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ops import mlstm_scan as pallas_mlstm_scan

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels.ref import reference_mlstm_scan_float64
from repro_torch.models.xlstm import _denominator, mlstm_chunkwise

ATTN_TOL = 2e-5        # fp32 attention, atol = rtol (tests/test_kernels.py)
MARGIN = 4             # the split must hold ATTN_TOL / MARGIN
MLSTM_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split(x, terms):
    """fp32 ``x`` as ``terms`` bf16-valued fp32 tensors, each the top 16
    bits of what the terms before it leave."""
    out, rest = [], x.float()
    for _ in range(terms):
        top = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(top)
        rest = rest - top
    return out


def split_matmul(a, b, terms):
    """a @ b as the kernels form it: the term products a_i b_j with
    i + j < terms, smallest first, each exact, summed in fp32."""
    sa, sb = split(a, terms), split(b, terms)
    pairs = sorted(((i, j) for i in range(terms) for j in range(terms)
                    if i + j < terms), key=lambda p: -(p[0] + p[1]))
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i, j in pairs:
        acc = acc + sa[i] @ sb[j]
    return acc


def split_attention(q, k, v, q_pos, kv_pos, causal, window, terms):
    """The fp32 tensor-core kernel's arithmetic: q scaled in fp32, key tiles
    of 64 (32 at D = 256), an fp32 online softmax, S = Q K^T and P V in
    split precision.  q (B,T,H,D), k/v (B,S,KV,D) -> (out, lse (B,H,T))."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tile = 32 if d == 256 else 64
    qs = (q.float() * (1.0 / math.sqrt(d))).reshape(b, t, kvh, g, d)
    qs = qs.permute(0, 2, 3, 1, 4)                       # (B,KV,G,T,D)
    kk, vv = (x.float().permute(0, 2, 1, 3)[:, :, None] for x in (k, v))
    m = torch.full((b, kvh, g, t, 1), -1e30)
    l = torch.zeros((b, kvh, g, t, 1))
    o = torch.zeros((b, kvh, g, t, d))
    for s0 in range(0, s, tile):
        kp = kv_pos[s0:s0 + tile]
        ok = (kp[None, :] >= 0).expand(t, -1)
        if causal:
            ok = ok & (kp[None, :] <= q_pos[:, None])
        if window > 0:
            ok = ok & ((q_pos[:, None] - kp[None, :]) < window)
        sc = split_matmul(qs, kk[..., s0:s0 + tile, :].transpose(-1, -2),
                          terms)
        mx = sc.masked_fill(~ok, -1e30).amax(-1, keepdim=True)
        m_new = torch.maximum(m, mx)
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new).masked_fill(~ok, 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + split_matmul(p, vv[..., s0:s0 + tile, :], terms)
        m = m_new
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(l), 1e30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    return out, lse.reshape(b, h, t)


def attention64(q, k, v, q_pos, kv_pos, causal, window):
    """Attention in float64: (out, lse), zeros and 1e30 where a row sees
    no key."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qg = q.double().reshape(b, t, kvh, h // kvh, d) / math.sqrt(d)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.double())
    ok = (kv_pos[None, :] >= 0).expand(t, -1)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    logits = logits.masked_fill(~ok, -math.inf)
    seen = ok.any(-1)
    w = torch.softmax(logits.masked_fill(~seen[:, None], 0.0), -1)
    o = torch.einsum("bkgts,bskd->btkgd", w, v.double())
    o = (o * seen[None, :, None, None, None]).reshape(b, t, h, d)
    lse = torch.logsumexp(logits, -1).masked_fill(~seen, 1e30)
    return o, lse.reshape(b, h, t)


# name: (b, t, s, h, kvh, d, q_pos, causal, window); q_pos None = arange(t),
# "tail" = the last t of s positions.  "wide" cases scale q's and k's
# columns by reciprocal factors from 1e-3 to 1e3 (every row of q and of k
# spans that range; scores stay O(1)) and v's columns by factors from 1 to
# 1e-6 (an output of 1e3 would carry fp32's own 1e-4 from any order of
# summation, past the tolerance).
HAZARDS = {
    "gqa3_d64_odd": (1, 67, 67, 6, 2, 64, None, True, 0),
    "wide_d64": (1, 70, 70, 4, 2, 64, None, True, 0),
    "wide_d256": (1, 40, 40, 2, 1, 256, None, True, 0),
    "mqa_d256_tail": (1, 33, 70, 4, 1, 256, "tail", True, 0),
    "gqa5_d16_window": (1, 45, 45, 10, 2, 16, None, True, 9),
    "some_rows_masked": (1, 24, 40, 6, 2, 32, list(range(-8, 16)), True, 0),
    "noncausal_d128": (1, 20, 90, 3, 1, 128, None, False, 0),
}


def _attention_inputs(name):
    b, t, s, h, kvh, d, q_pos, causal, window = HAZARDS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    if name.startswith("wide"):
        span = (10.0 ** np.linspace(-3, 3, d)).astype(np.float32)
        q, k, v = q * span, k / span, v * span[::-1] / 1e3
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    if q_pos is None:
        q_pos = list(range(t))
    return ([torch.from_numpy(x) for x in (q, k, v)],
            torch.tensor(q_pos, dtype=torch.int32),
            torch.arange(s, dtype=torch.int32), causal, window)


@pytest.mark.parametrize("terms", [1, 2, 3, 4])
def test_split_sums_back_exactly(terms):
    """The terms sum to the fp32 value exactly from FP32_TERMS on (3 x 8
    bits cover fp32's 24), whatever its magnitude; fewer leave a rest."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(
        -30, 30, size=4096)).astype(np.float32))
    parts = split(x, terms)
    for p in parts:  # every term is a bf16 value
        assert torch.equal(p.bfloat16().float(), p)
    total = parts[0].double()
    for p in parts[1:]:
        total = total + p.double()
    exact = bool(torch.equal(total, x.double()))
    assert exact == (terms >= fa.FP32_TERMS)
    assert fa.FP32_TERMS == 3


@pytest.mark.parametrize("name", sorted(HAZARDS))
def test_split_attention_holds_float64_with_margin(name):
    """The modelled kernel (FP32_TERMS terms) is within ATTN_TOL / MARGIN
    of float64 on every hazard input, output and lse; one term fewer is
    not (the split cannot drop a term)."""
    (q, k, v), qp, kp, causal, window = _attention_inputs(name)
    want, want_lse = attention64(q, k, v, qp, kp, causal, window)
    tol = ATTN_TOL / MARGIN
    for terms in (fa.FP32_TERMS, fa.FP32_TERMS - 1):
        got, lse = split_attention(q, k, v, qp, kp, causal, window, terms)
        excess = float(((got.double() - want).abs()
                        - tol * want.abs()).max())
        seen = want_lse < 1e29
        assert torch.equal(lse >= 1e29, ~seen)
        lse_err = float((lse.double() - want_lse)[seen].abs().max())
        if terms == fa.FP32_TERMS:
            assert excess <= tol and lse_err <= tol, (excess, lse_err)
        else:
            assert excess > tol or lse_err > tol


@pytest.mark.parametrize("name", ["gqa3_d64_odd", "some_rows_masked",
                                  "wide_d64"])
def test_split_attention_matches_pallas_kernel(name):
    """The modelled kernel vs repro.kernels.flash_attention
    (interpret=True), fp32 tolerance 2e-5."""
    (q, k, v), qp, kp, causal, window = _attention_inputs(name)
    got, _ = split_attention(q, k, v, qp, kp, causal, window, fa.FP32_TERMS)
    want = pallas_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                        q_pos=jnp.asarray(qp.numpy()), causal=causal,
                        window=window, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


def split_steps(a, b, terms, init=None):
    """a @ b (..., M, K) x (..., K, N) as the fp32 scan kernel forms it: per
    step of 16 in the reduction, the term products a_i b_j with
    i + j < terms, smallest first, in a fresh fp32 accumulator, then added
    to the running sum (``init``, or zero) one step after another."""
    kd = a.shape[-1]
    pad = -kd % 16
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    steps = a.shape[-1] // 16
    sa = [x.unflatten(-1, (steps, 16)).movedim(-2, -3) for x in split(a, terms)]
    sb = [x.unflatten(-2, (steps, 16)) for x in split(b, terms)]
    pairs = sorted(((i, j) for i in range(terms) for j in range(terms)
                    if i + j < terms), key=lambda p: -(p[0] + p[1]))
    part = None
    for i, j in pairs:  # (..., steps, M, N)
        prod = sa[i] @ sb[j]
        part = prod if part is None else part + prod
    acc = torch.zeros(part.shape[:-3] + part.shape[-2:]) if init is None \
        else init
    for st in range(steps):
        acc = acc + part[..., st, :, :]
    return acc


def split_mlstm(q, k, v, log_i, log_f, chunk, terms=3, state=None,
                state_in_bf16=False):
    """csrc/mlstm_scan_fp32tc.cu's arithmetic, in its order.  The state
    pass walks the chunks: it keeps the C entering each chunk (the scratch,
    exact in its three terms; rounded once to bf16 with ``state_in_bf16``)
    and forms C1 = a C0 + k^T (w v), the chunk's product summed apart.  The
    output pass then forms, per chunk, O = c_in (q C0), S = q k^T, P = S
    exp(e - m_row) masked, O += P v key step by key step, the row sums of P
    and q.n0 in fp32, h = O / max(|dot|, exp(-m_row)).  q is scaled in
    fp32 first; every product is :func:`split_steps` with ``terms``.
    Returns h (B,T,H,D) and (C, n, m)."""
    b, t, h, d = q.shape
    nc = t // chunk
    qs = (q.float() * (1.0 / math.sqrt(d))).permute(0, 2, 1, 3)  # (B,H,T,D)
    kk, vv = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    li, lf = (x.float().permute(0, 2, 1) for x in (log_i, log_f))  # (B,H,T)
    if state is None:
        c0, n0 = torch.zeros((b, h, d, d)), torch.zeros((b, h, d))
        m0 = torch.full((b, h), -math.inf)
    else:
        c0, n0, m0 = (x.float() for x in state)
    sl = [slice(c * chunk, (c + 1) * chunk) for c in range(nc)]
    bcums = [lf[..., s].cumsum(-1) for s in sl]
    entering = []  # (C0 as the output pass reads it, n0, m0) of each chunk
    for c in range(nc):  # the state pass
        kc, vc, lic, bcum = kk[:, :, sl[c]], vv[:, :, sl[c]], li[..., sl[c]], \
            bcums[c]
        entering.append((c0.bfloat16().float() if state_in_bf16 else c0, n0,
                         m0))
        btot = bcum[..., -1]
        m_new = torch.maximum(btot + m0, ((btot[..., None] - bcum) + lic)
                              .amax(-1))
        a = torch.exp((btot + m0) - m_new)
        w = torch.exp(((btot[..., None] - bcum) + lic) - m_new[..., None])
        c0 = a[..., None, None] * c0 + split_steps(
            kc.transpose(-1, -2), w[..., None] * vc, terms)
        n0 = a[..., None] * n0 + (w[..., None] * kc).sum(-2)
        m0 = m_new
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    hs = []
    for c in range(nc):  # the output pass
        qc, kc, vc, lic, bcum = qs[:, :, sl[c]], kk[:, :, sl[c]], \
            vv[:, :, sl[c]], li[..., sl[c]], bcums[c]
        cc, nn, mm = entering[c]
        e = (bcum[..., :, None] - bcum[..., None, :]) + lic[..., None, :]
        e = e.masked_fill(~tri, -math.inf)
        g = bcum + mm[..., None]
        m_row = torch.clamp_min(torch.maximum(e.amax(-1), g), -1e30)
        c_in = torch.exp(g - m_row)
        o = split_steps(qc, cc, terms) * c_in[..., None]
        p = split_steps(qc, kc.transpose(-1, -2), terms) * torch.exp(
            e - m_row[..., None])
        p = p.masked_fill(~tri, 0.0)
        o = split_steps(p, vc, terms, init=o)
        dot = p.sum(-1) + c_in * (qc * nn[..., None, :]).sum(-1)
        hs.append(o / _denominator(dot, m_row)[..., None])
    out = torch.cat(hs, dim=2).permute(0, 2, 1, 3)
    return out, (c0, n0, m0)


def _mlstm_inputs(b, t, h, d, gates, seed, with_state=False):
    """q, k, v, log_i, log_f (torch fp32) and an initial state or None;
    forget gates near one shift the forget pre-activation by 20 (log_f ~
    0: C sums every step of T), as chip_smoke.py's hazards do."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    li = (rng.normal(size=(b, t, h)) * 2).astype(np.float32)
    pre_f = rng.normal(size=(b, t, h)) * 2 + (20.0 if gates != "normal"
                                              else 1.0)
    lf = (-np.logaddexp(0.0, -pre_f)).astype(np.float32)
    state = None
    if with_state:
        state = (torch.from_numpy((rng.normal(size=(b, h, d, d)) * 0.1)
                                  .astype(np.float32)),
                 torch.from_numpy(np.abs(rng.normal(size=(b, h, d)))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)))
    return [torch.from_numpy(x) for x in (q, k, v, li, lf)], state


@pytest.mark.parametrize("gates", ["normal", "forget_near_one"])
def test_split_mlstm_matches_pallas_kernel(gates):
    """The modelled fp32 scan kernel vs repro.kernels.mlstm_scan
    (interpret=True) at MLSTM_TOL, with forget gates near one and
    without."""
    b, t, h, d, chunk = 1, 128, 2, 32, 32
    args, _ = _mlstm_inputs(b, t, h, d, gates, seed=7)
    got, _ = split_mlstm(*args, chunk, fa.FP32_TERMS)
    want = pallas_mlstm_scan(*(jnp.asarray(x.numpy()) for x in args),
                             chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLSTM_TOL)


# A C21 hazard at CPU size: D 512, forget gates near one, two chunks of
# 256, from zero and from a given state.
C21_SHAPE = (1, 512, 1, 512, 256)


def _c21(with_state):
    b, t, h, d, chunk = C21_SHAPE
    args, state = _mlstm_inputs(b, t, h, d, "forget_near_one", seed=21,
                                with_state=with_state)
    exact = reference_mlstm_scan_float64(*args, state, chunk=chunk)
    plain = mlstm_chunkwise(*args, state, chunk)
    return args, state, chunk, exact, plain


def _as_dict(out):
    return dict(zip("hCnm", (out[0], *out[1])))


@pytest.mark.parametrize("with_state", [False, True])
def test_split_mlstm_meets_the_fp32_check_on_a_c21_hazard(with_state):
    """chip_smoke.py's check of an fp32 scan (mlstm_scan.check_fp32): on a
    C21 hazard the plain fp32 version is outside MLSTM_TOL of float64 on
    some elements, so the modelled kernel is held to float64, row by row
    and by its count of elements outside, and the plain version meets the
    row check too."""
    args, state, chunk, exact, plain = _c21(with_state)
    got = split_mlstm(*args, chunk, fa.FP32_TERMS, state)
    r = ms.check_fp32(_as_dict(got), _as_dict(plain), _as_dict(exact))
    assert r["held_to"] == "float64" and r["ok"], r
    assert r["row_outside_vs_float64"] == 0
    assert r["plain_row_outside_vs_float64"] == 0


@pytest.mark.parametrize("variant", ["two_terms", "state_in_bf16"])
def test_the_fp32_check_fails_a_coarser_scan(variant):
    """The check has teeth: the modelled kernel with two terms an operand,
    or with the chunk state read once rounded to bf16, fails it on the
    same C21 hazard (from a given state)."""
    args, state, chunk, exact, plain = _c21(True)
    got = split_mlstm(*args, chunk, 2 if variant == "two_terms" else 3,
                      state, state_in_bf16=variant == "state_in_bf16")
    r = ms.check_fp32(_as_dict(got), _as_dict(plain), _as_dict(exact))
    assert not r["ok"], r


def test_the_fp32_check_holds_the_plain_version_where_it_meets_float64():
    """Where the plain version is within MLSTM_TOL of float64 everywhere
    the kernel is held to it element by element: a kernel one tolerance
    off on one element fails, though it meets float64 row by row."""
    args, state = _mlstm_inputs(1, 128, 2, 64, "normal", seed=3)
    exact = reference_mlstm_scan_float64(*args, chunk=64)
    plain = mlstm_chunkwise(*args, None, 64)
    got = split_mlstm(*args, 64)
    r = ms.check_fp32(_as_dict(got), _as_dict(plain), _as_dict(exact))
    assert r["held_to"] == "plain" and r["ok"], r
    h = got[0].clone()
    h[0, 5, 1, 7] += 10 * (MLSTM_TOL["atol"]
                           + MLSTM_TOL["rtol"] * abs(float(h[0, 5, 1, 7])))
    r = ms.check_fp32(dict(_as_dict(got), h=h), _as_dict(plain),
                      _as_dict(exact))
    assert r["held_to"] == "plain" and not r["ok"]
