"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential with block-diagonal recurrence).  [arXiv:2405.04517]

Port of ``repro.models.xlstm``.  The mLSTM recurrence (per batch, per head;
stabilizer ``m``):

    m_t = max(lf_t + m_{t-1}, li_t)
    C_t = e^{lf_t + m_{t-1} - m_t} C_{t-1} + e^{li_t - m_t} k_t v_t^T
    n_t = e^{lf_t + m_{t-1} - m_t} n_{t-1} + e^{li_t - m_t} k_t
    h_t = (q_t C_t) / max(|q_t n_t|, e^{-m_t})          q pre-scaled 1/sqrt(dk)

:func:`mlstm_sequential` is the exact oracle and the decode step;
:func:`mlstm_chunkwise` computes the same chunk-parallel and is the plain
version of the ``mlstm_scan`` kernel, which the mLSTM block reaches through
:func:`repro_torch.kernels.ops.mlstm_scan`.  Both run in float32.  The
sLSTM scan is a plain loop over time.

Under autograd the block reaches the kernel through :class:`MLSTMScan`:
the kernel forward, and a backward that recomputes :func:`mlstm_chunkwise`
from the saved inputs and differentiates it, as the reference
differentiates its jnp ``mlstm_chunkwise`` (it has no Pallas backward).
``backward_calls`` counts those backward passes, as the kernel wrappers
count their launches.

On a mesh with a ``tp`` axis, given this rank's ``tp`` slices of ``wq``,
``wk``, ``wv`` (columns) and ``down`` (rows), the mLSTM block is
head-parallel over its ``nh`` heads (:func:`apply_mlstm_block`); where the
heads do not split over ``tp`` it is handed whole leaves and computes
whole.  The sLSTM block computes whole on every rank: its block-diagonal
recurrent product is split into the four gates, so each element of the
next h reads every head's h, and a head split would need an exchange at
every time step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from . import layers as L
from .layers import AxisRules, apply_norm, dense_init, silu
from .ssm import _causal_conv


# ---------------------------------------------------------------------------
# mLSTM cell math.
# ---------------------------------------------------------------------------

#: The largest exponent whose exp is finite in float32 (88.72), rounded
#: down.  The denominator's floor exp(-m) is taken at no more than this:
#: where m < -88.7 the reference's exp(-m) is inf, h underflows to 0, and
#: its gradient is 0 * inf = NaN.  Clamped, h is the same to 1e-36 and the
#: gradient is finite (0 to float32 precision, as the exact one is).
EXP_MAX = 88.0


def _denominator(dot, m):
    """max(|q n|, exp(-m)), the floor's exponent clamped at
    :data:`EXP_MAX`.  h is continuous where the two sides are equal, but
    its gradient jumps there: rounding that moves a position across
    changes that position's gradient by a step, not by a rounding."""
    return torch.maximum(dot.abs(), torch.exp(torch.clamp_max(-m, EXP_MAX)))


def _zero_state(b, h, d, device):
    return (torch.zeros((b, h, d, d), dtype=torch.float32, device=device),
            torch.zeros((b, h, d), dtype=torch.float32, device=device),
            torch.full((b, h), -math.inf, dtype=torch.float32, device=device))


def _f32_inputs(q, k, v, log_i, log_f):
    d = q.shape[-1]
    return (q.float() / math.sqrt(d), k.float(), v.float(), log_i.float(),
            log_f.float())


def mlstm_sequential(q, k, v, log_i, log_f, state=None):
    """Exact recurrence.  q,k,v: (B,T,H,D); log_i/log_f: (B,T,H).

    Returns (h (B,T,H,D) float32, state) with state = (C (B,H,D,D),
    n (B,H,D), m (B,H)).  All math in fp32.
    """
    b, t, h, d = q.shape
    q, k, v, li, lf = _f32_inputs(q, k, v, log_i, log_f)
    C, n, m = (_zero_state(b, h, d, q.device) if state is None
               else tuple(s.float() for s in state))
    hs = []
    for i in range(t):
        qt, kt, vt, lit, lft = q[:, i], k[:, i], v[:, i], li[:, i], lf[:, i]
        m_new = torch.maximum(lft + m, lit)
        a = torch.exp(lft + m - m_new)[..., None]          # (B,H,1)
        bcoef = torch.exp(lit - m_new)[..., None]
        C = (a[..., None] * C
             + bcoef[..., None] * kt[..., None] * vt[..., None, :])
        n = a * n + bcoef * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        dot = torch.einsum("bhd,bhd->bh", qt, n)
        den = _denominator(dot, m_new)[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def _chunk_terms(qc, kc, vc, lic, lfc, tri, C0, n0, m0):
    """One chunk of the chunkwise scan (float32, (B, C, H, *) inputs, the
    entering state C0, n0, m0): the UN-normalized terms num (B,C,H,D) and
    dot (B,C,H), the row stabilizer m_row (B,C,H), the inclusive sum of
    log_f bcum (B,C,H), and the chunk-end state (C, n, m)."""
    bcum = lfc.cumsum(dim=1)            # inclusive sum of log_f, (B,C,H)
    btot = bcum[:, -1]                  # (B,H)
    # intra-chunk log weights e_ts = bcum_t - bcum_s + li_s (s <= t)
    e = bcum[:, :, None, :] - bcum[:, None, :, :] + lic[:, None, :, :]
    e = e.masked_fill(~tri, -math.inf)  # (B,t,s,H)
    g = bcum + m0[:, None, :]           # inter exponent (B,C,H)
    m_row = torch.maximum(e.amax(dim=2), g)
    m_row = torch.clamp_min(m_row, -1e30)          # guard -inf rows
    s_mat = torch.einsum("bthd,bshd->btsh", qc, kc) * torch.exp(
        e - m_row[:, :, None, :])
    s_mat = s_mat.masked_fill(~tri, 0.0)
    c_inter = torch.exp(g - m_row)                  # (B,C,H)
    num = (torch.einsum("btsh,bshd->bthd", s_mat, vc)
           + c_inter[..., None] * torch.einsum("bthd,bhde->bthe", qc, C0))
    dot = (s_mat.sum(dim=2)
           + c_inter * torch.einsum("bthd,bhd->bth", qc, n0))
    # chunk-end state update
    m_new = torch.maximum(btot + m0,
                          (btot[:, None] - bcum + lic).amax(dim=1))
    scale0 = torch.exp(btot + m0 - m_new)           # (B,H)
    w_s = torch.exp(btot[:, None] - bcum + lic - m_new[:, None])
    C1 = (scale0[..., None, None] * C0
          + torch.einsum("bsh,bshd,bshe->bhde", w_s, kc, vc))
    n1 = scale0[..., None] * n0 + torch.einsum("bsh,bshd->bhd", w_s, kc)
    return num, dot, m_row, bcum, (C1, n1, m_new)


def _chunks(q, k, v, log_i, log_f, chunk):
    """The float32 inputs as (B, nc, chunk, H, *) and the causal mask of
    a chunk; T must be a multiple of ``chunk``."""
    b, t = q.shape[:2]
    if t % chunk:
        raise ValueError(f"T={t} must be a multiple of chunk={chunk}")
    parts = tuple(x.reshape(b, t // chunk, chunk, *x.shape[2:])
                  for x in _f32_inputs(q, k, v, log_i, log_f))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]   # s <= t
    return parts, tri


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk: int = 256):
    """Chunk-parallel mLSTM, the semantics of :func:`mlstm_sequential`.
    T must be a multiple of ``chunk``.  Returns h in float32."""
    b, t, h, d = q.shape
    parts, tri = _chunks(q, k, v, log_i, log_f, chunk)
    state = (_zero_state(b, h, d, q.device) if state is None
             else tuple(s.float() for s in state))
    hs = []
    for c in range(t // chunk):
        num, dot, m_row, _, state = _chunk_terms(
            *(x[:, c] for x in parts), tri, *state)
        hs.append(num / _denominator(dot, m_row)[..., None])
    return torch.stack(hs, dim=1).reshape(b, t, h, d), state


def mlstm_chunkwise_raw(q, k, v, log_i, log_f, chunk: int = 256):
    """Zero-init chunkwise mLSTM returning the UN-normalized per-position
    terms, for a context-parallel state correction
    (:mod:`.xlstm_sp`): ``(num (B,T,H,D), dot (B,T,H), m_loc (B,T,H),
    b_global (B,T,H), (F_total (B,H), C, n, m))``, all float32.
    ``h = num / max(|dot|, exp(-m_loc))`` is the local result,
    ``b_global`` the inclusive cumulative log-forget within the segment and
    ``F_total = b_global[:, -1]``.  Port of
    ``repro.models.xlstm.mlstm_chunkwise_raw``; T must be a multiple of
    ``chunk``."""
    b, t, h, d = q.shape
    parts, tri = _chunks(q, k, v, log_i, log_f, chunk)
    state = _zero_state(b, h, d, q.device)
    f0 = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    terms = []
    for c in range(t // chunk):
        num, dot, m_row, bcum, state = _chunk_terms(
            *(x[:, c] for x in parts), tri, *state)
        terms.append((num, dot, m_row, bcum + f0[:, None, :]))
        f0 = f0 + bcum[:, -1]
    return (*(torch.cat(x, dim=1) for x in zip(*terms)), (f0, *state))


# ---------------------------------------------------------------------------
# The scan under autograd.
# ---------------------------------------------------------------------------

#: Backward passes of :class:`MLSTMScan` since the count was last set to 0.
backward_calls = 0


class MLSTMScan(torch.autograd.Function):
    """The chunkwise mLSTM from a zero state, differentiable in q, k, v,
    log_i and log_f.

    Forward: :func:`repro_torch.kernels.ops.mlstm_scan` under
    ``torch.no_grad()`` (on the card the kernel, on the CPU its plain
    version), looked up at call time; it saves only the inputs.  Backward:
    :func:`mlstm_chunkwise` recomputed from them under grad, and its
    gradients.  h comes out in q's dtype; the final (C, n, m) come out
    beside it, not differentiable (training drops them, as the reference's
    ``forward_train`` does)."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, chunk: int):
        q, k, v, log_i, log_f = (x.contiguous()
                                 for x in (q, k, v, log_i, log_f))
        with torch.no_grad():
            h, (C, n, m) = kops.mlstm_scan(q, k, v, log_i, log_f, None,
                                           chunk=chunk)
        ctx.save_for_backward(q, k, v, log_i, log_f)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(C, n, m)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, *_):
        global backward_calls
        backward_calls += 1
        return (*mlstm_backward(*ctx.saved_tensors, dh, chunk=ctx.chunk),
                None)


def mlstm_backward(q, k, v, log_i, log_f, dh, *, chunk: int = 256):
    """dq, dk, dv, dlog_i, dlog_f of h = :func:`mlstm_chunkwise` (from a
    zero state) for the output gradient ``dh``: the scan recomputed from
    the inputs under grad and differentiated, in float32; each gradient in
    its input's dtype.  The backward of :class:`MLSTMScan`."""
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v, log_i,
                                                        log_f)]
    with torch.enable_grad():
        h, _ = mlstm_chunkwise(*inputs, chunk=chunk)
        return torch.autograd.grad(h, inputs, dh.to(h.dtype))


def mlstm_scan_grad(q, k, v, log_i, log_f, state=None, *, chunk: int = 256):
    """:class:`MLSTMScan`: (h in q's dtype, (C, n, m) float32), the
    contract of :func:`repro_torch.kernels.ops.mlstm_scan`, differentiable
    in h.  Takes no initial state: every training sequence starts from
    zero."""
    if state is not None:
        raise ValueError("the mLSTM scan under autograd starts from a zero "
                         "state; pass state=None")
    h, C, n, m = MLSTMScan.apply(q, k, v, log_i, log_f, chunk)
    return h, (C, n, m)


# ---------------------------------------------------------------------------
# mLSTM block.
# ---------------------------------------------------------------------------

def init_mlstm_block(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    dev = gen.device
    return {
        "norm_scale": torch.zeros((d,), dtype=dtype, device=dev),
        "up": dense_init(gen, (d, 2 * inner), dtype),
        "conv_w": dense_init(gen, (cfg.conv_kernel, inner), dtype,
                             fan_in=cfg.conv_kernel),
        "wq": dense_init(gen, (inner, inner), dtype),
        "wk": dense_init(gen, (inner, inner), dtype),
        "wv": dense_init(gen, (inner, inner), dtype),
        "w_i": dense_init(gen, (inner, cfg.num_heads), dtype),
        "w_f": dense_init(gen, (inner, cfg.num_heads), dtype),
        "b_i": torch.zeros((cfg.num_heads,), dtype=dtype, device=dev),
        "b_f": torch.full((cfg.num_heads,), 3.0, dtype=dtype, device=dev),
        "hnorm_scale": torch.zeros((inner,), dtype=dtype, device=dev),
        "down": dense_init(gen, (inner, d), dtype, fan_in=inner),
    }


def mlstm_heads(cfg, rules: AxisRules = AxisRules()) -> int:
    """The mLSTM heads a rank computes: ``nh/tp`` where the heads split over
    ``tp``, else all ``nh`` (the block then computes whole)."""
    nh = cfg.num_heads
    return nh // rules.tp_size if nh % rules.tp_size == 0 else nh


def _rms_norm_over_tp(h, scale, width: int, rules: AxisRules,
                      eps: float = 1e-6):
    """:func:`~.layers.apply_norm`'s RMS norm of ``h`` (B, T, this rank's
    columns of ``width``), the mean square over all ``width`` columns: each
    rank's sum of squares summed over ``tp`` both ways
    (:func:`~.layers.sum_tp`), since each rank normalises its own columns
    by it."""
    hf = h.float()
    ms = L.sum_tp(hf.square().sum(dim=-1, keepdim=True), rules) / width
    return (hf * torch.rsqrt(ms + eps) * (1.0 + scale.float())).to(h.dtype)


def apply_mlstm_block(p, x, cfg, *, cache=None, chunk: int = 256,
                      rules: AxisRules = AxisRules()):
    """Pre-norm residual mLSTM block.  cache: {"conv", "C", "n", "m"}.

    A prompt whose length is a multiple of ``chunk`` goes through
    :func:`repro_torch.kernels.ops.mlstm_scan` (the kernel on the card),
    and under autograd through :func:`mlstm_scan_grad` (the kernel forward
    and the plain backward); a single step or any other length through
    :func:`mlstm_sequential`, under autograd too, as in the reference.

    Head-parallel where ``wq`` holds this rank's ``tp`` slice (``wq``,
    ``wk``, ``wv``: its heads' ``dh``-wide column blocks; ``down``: their
    rows).  The input side is whole on every rank, since each head's q, k
    and v read every channel of ``xc`` and ``xin``: ``up``'s ``xin``
    columns, the causal conv and silu compute whole, and ``xc``, ``xin``
    enter the column-parallel products through :func:`~.layers.enter_tp`.
    ``up``'s ``z`` half, ``w_i``, ``w_f``, ``b_i``, ``b_f`` and
    ``hnorm_scale`` are cut to this rank's heads (:func:`~.layers.tp_cut`),
    the output norm reads the sum of squares over all of ``inner``, and
    ``down``'s partial product is all-reduced.  ``C``, ``n``, ``m`` hold
    this rank's heads; ``conv`` is whole.
    """
    b, t, d = x.shape
    inner = cfg.ssm_expand * d
    nh = cfg.num_heads
    dh = inner // nh
    sliced = L.tp_sliced(p["wq"].shape[1], inner, rules, "wq")
    if sliced and nh % rules.tp_size:
        raise ValueError(f"wq holds {p['wq'].shape[1]} of {inner} columns: "
                         f"{nh} heads do not split over {rules.tp_size} tp "
                         "ranks; pass it whole")
    hl = nh // rules.tp_size if sliced else nh
    y = apply_norm({"scale": p["norm_scale"]}, x)
    if sliced:
        h0, c0 = rules.tp_rank * hl, rules.tp_rank * hl * dh
        xin = y @ p["up"][:, :inner]
        z = L.enter_tp(y, rules) @ L.tp_cut(p["up"][:, inner:], 1, c0,
                                            hl * dh, rules)
        gates = {n: L.tp_cut(p[n], -1, h0, hl, rules)
                 for n in ("w_i", "w_f", "b_i", "b_f")}
        hnorm = L.tp_cut(p["hnorm_scale"], 0, c0, hl * dh, rules)
    else:
        up = y @ p["up"]
        xin, z = up[..., :inner], up[..., inner:]
        gates = {n: p[n] for n in ("w_i", "w_f", "b_i", "b_f")}
    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_conv(xin, p["conv_w"], conv_state)
    xc = silu(xc)
    xq, xv = ((L.enter_tp(xc, rules), L.enter_tp(xin, rules)) if sliced
              else (xc, xin))
    q = (xq @ p["wq"]).reshape(b, t, hl, dh)
    k = (xq @ p["wk"]).reshape(b, t, hl, dh)
    v = (xv @ p["wv"]).reshape(b, t, hl, dh)
    log_i = (xq @ gates["w_i"] + gates["b_i"]).float()
    log_f = F.logsigmoid((xq @ gates["w_f"] + gates["b_f"]).float())
    state = None if cache is None else (cache["C"], cache["n"], cache["m"])
    scan_in = (q, k, v, log_i, log_f)
    if t == 1 or t % chunk:
        h, (C, n, m) = mlstm_sequential(*scan_in, state)
    elif torch.is_grad_enabled() and any(x.requires_grad for x in scan_in):
        h, (C, n, m) = mlstm_scan_grad(*scan_in, state, chunk=chunk)
    else:
        h, (C, n, m) = kops.mlstm_scan(*scan_in, state, chunk=chunk)
    h = h.reshape(b, t, hl * dh).to(x.dtype)
    if sliced:                                             # output norm
        h = _rms_norm_over_tp(h, hnorm, inner, rules)
    else:
        h = apply_norm({"scale": p["hnorm_scale"]}, h)
    h = h * silu(z)
    out = h @ p["down"]
    if sliced:
        out = L.reduce_tp(out, rules)
    return x + out, {"conv": new_conv, "C": C, "n": n, "m": m}


def init_mlstm_cache(cfg, batch, *, device,
                     rules: AxisRules = AxisRules()) -> dict:
    """A zero cache: ``C``, ``n``, ``m`` of this rank's heads
    (:func:`mlstm_heads`), ``conv`` whole."""
    inner = cfg.ssm_expand * cfg.d_model
    dh = inner // cfg.num_heads
    C, n, m = _zero_state(batch, mlstm_heads(cfg, rules), dh, device)
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, inner),
                                dtype=torch.float32, device=device),
            "C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM block.
# ---------------------------------------------------------------------------

def init_slstm_block(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    ff = int(d * 4 / 3)
    dev = gen.device
    return {
        "norm_scale": torch.zeros((d,), dtype=dtype, device=dev),
        "w_gates": dense_init(gen, (d, 4 * d), dtype),      # z, i, f, o
        "r_gates": dense_init(gen, (nh, dh, 4 * dh), dtype, fan_in=dh),
        "b_gates": torch.cat([
            torch.zeros((2 * d,), device=dev), torch.full((d,), 3.0, device=dev),
            torch.zeros((d,), device=dev)]).to(dtype),
        "hnorm_scale": torch.zeros((d,), dtype=dtype, device=dev),
        "ffn_wi": dense_init(gen, (d, ff), dtype),
        "ffn_wg": dense_init(gen, (d, ff), dtype),
        "ffn_wo": dense_init(gen, (ff, d), dtype, fan_in=ff),
        "ffn_norm_scale": torch.zeros((d,), dtype=dtype, device=dev),
    }


def slstm_scan(wx, r_gates, h0, c0, n0, m0, nh):
    """Sequential sLSTM.  wx: (B,T,4d) input-driven gate preactivations.

    Per step, the recurrent contribution uses block-diagonal R per head.
    Returns (h (B,T,d), (h,c,n,m) final).  fp32 math.
    """
    b, t, d4 = wx.shape
    d = d4 // 4
    dh = d // nh
    h, c, n, m = h0, c0, n0, m0                 # (B,d) fp32
    hs = []
    for i in range(t):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, dh),
                           r_gates).reshape(b, 4 * d)
        pre = wx[:, i].float() + rec
        zt, it, ft, ot = pre.split(d, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lf + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def apply_slstm_block(p, x, cfg, *, cache=None):
    b, t, d = x.shape
    nh = cfg.num_heads
    y = apply_norm({"scale": p["norm_scale"]}, x)
    wx = y @ p["w_gates"] + p["b_gates"]
    if cache is None:
        c = init_slstm_cache(cfg, b, device=x.device)
        state = (c["h"], c["c"], c["n"], c["m"])
    else:
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
    r = p["r_gates"].float()
    hs, (h, c, n, m) = slstm_scan(wx, r, *state, nh=nh)
    hs = apply_norm({"scale": p["hnorm_scale"]}, hs.to(x.dtype))
    x = x + hs
    # gated FFN (factor 4/3)
    y = apply_norm({"scale": p["ffn_norm_scale"]}, x)
    hff = silu(y @ p["ffn_wg"]) * (y @ p["ffn_wi"])
    x = x + hff @ p["ffn_wo"]
    return x, {"h": h, "c": c, "n": n, "m": m}


def init_slstm_cache(cfg, batch, *, device) -> dict:
    d = cfg.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((batch, d), -math.inf, dtype=torch.float32,
                            device=device)}
