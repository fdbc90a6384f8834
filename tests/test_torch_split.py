"""A CPU model of the split precision of the fp32 tensor-core attention
kernel (csrc/flash_attention_fp32tc.cu), and of the same split applied to
the mLSTM scan, whose fp32 calls no tensor-core kernel takes yet (they stay
on csrc/mlstm_scan.cu: ROADMAP C21).

Each fp32 operand is split into bf16 terms, each the top 8 significant
bits of what the terms before it leave (truncation), and each product is
the sum of the term products a_i b_j with i + j < terms, smallest first,
accumulated in fp32.  The term count is the attention wrapper's
``FP32_TERMS``, the constant the kernel's ``kTerms`` mirrors, so that the
model and the kernel read one number.  Here the model is held to float64
within a quarter of the fp32 attention tolerance (2e-5 / 4) on hazard
inputs, with one term fewer shown to miss that margin, and to the Pallas
kernels in interpret mode at the repo's fp32 tolerances (attention 2e-5;
mLSTM rtol 5e-4, atol 5e-5).  The attention kernel itself is held to its
plain version on the card (tests/test_torch_cuda.py).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ops import mlstm_scan as pallas_mlstm_scan

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.xlstm import _denominator

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


def split_mlstm(q, k, v, log_i, log_f, chunk, terms):
    """A split fp32 scan's arithmetic: mlstm_chunkwise with q
    scaled in fp32 and every product (q k^T, p v, q C0, k^T (w v)) in split
    precision; C carried in fp32.  Returns h (B,T,H,D) and (C, n, m)."""
    b, t, h, d = q.shape
    nc = t // chunk
    qs = (q.float() * (1.0 / math.sqrt(d))).permute(0, 2, 1, 3)  # (B,H,T,D)
    kk, vv = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    li, lf = (x.float().permute(0, 2, 1) for x in (log_i, log_f))  # (B,H,T)
    c0 = torch.zeros((b, h, d, d))
    n0 = torch.zeros((b, h, d))
    m0 = torch.full((b, h), -math.inf)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, lic = qs[:, :, sl], kk[:, :, sl], vv[:, :, sl], li[:, :, sl]
        bcum = lf[:, :, sl].cumsum(-1)
        btot = bcum[..., -1]
        e = (bcum[..., :, None] - bcum[..., None, :]) + lic[..., None, :]
        e = e.masked_fill(~tri, -math.inf)
        g = bcum + m0[..., None]
        m_row = torch.clamp_min(torch.maximum(e.amax(-1), g), -1e30)
        p = split_matmul(qc, kc.transpose(-1, -2), terms) * torch.exp(
            e - m_row[..., None])
        p = p.masked_fill(~tri, 0.0)
        c_in = torch.exp(g - m_row)
        num = (split_matmul(p, vc, terms)
               + c_in[..., None] * split_matmul(qc, c0, terms))
        dot = p.sum(-1) + c_in * (qc * n0[..., None, :]).sum(-1)
        hs.append(num / _denominator(dot, m_row)[..., None])
        m_new = torch.maximum(btot + m0, ((btot[..., None] - bcum) + lic)
                              .amax(-1))
        a = torch.exp((btot + m0) - m_new)
        w = torch.exp(((btot[..., None] - bcum) + lic) - m_new[..., None])
        c0 = a[..., None, None] * c0 + split_matmul(
            kc.transpose(-1, -2), w[..., None] * vc, terms)
        n0 = a[..., None] * n0 + (w[..., None] * kc).sum(-2)
        m0 = m_new
    out = torch.cat(hs, dim=2).permute(0, 2, 1, 3)
    return out, (c0, n0, m0)


@pytest.mark.parametrize("gates", ["normal", "forget_near_one"])
def test_split_mlstm_matches_pallas_kernel(gates):
    """The modelled fp32 scan vs repro.kernels.mlstm_scan (interpret=True)
    at MLSTM_TOL, with forget gates near one (log_f ~ 0: C sums every step
    of T) and without."""
    b, t, h, d, chunk = 1, 128, 2, 32, 32
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    li = (rng.normal(size=(b, t, h)) * 2).astype(np.float32)
    pre_f = rng.normal(size=(b, t, h)) * 2 + (20.0 if gates != "normal"
                                              else 1.0)
    lf = (-np.logaddexp(0.0, -pre_f)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (q, k, v, li, lf)]
    got, _ = split_mlstm(*args, chunk, fa.FP32_TERMS)
    want = pallas_mlstm_scan(*(jnp.asarray(x) for x in (q, k, v, li, lf)),
                             chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLSTM_TOL)
