"""Mamba-style selective SSM branch (hymba's parallel heads), and the
depthwise causal convolution it shares with the xLSTM blocks.

Port of ``repro.models.ssm``.  Prefill runs the recurrence one position at
a time with an fp32 state carry h of (B, inner, state): the (B, T, inner,
state) decay and drive tensors are never formed (at hymba-1.5b's width and
640 positions they would be 524 MB a layer).  Decode is one step of the
same recurrence against the cached (conv window, ssm state) pair.  The loop
is plain PyTorch: the reference's is a ``lax.scan`` in jnp, not a Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .layers import dense_init, silu

DT_RANK_DIV = 16  # dt_rank = max(d_model // 16, 8)
#: The reference's chunk of its checkpointed two-level scan.
CHUNK = 128


def init_ssm(gen: torch.Generator, cfg, dtype) -> dict:
    """The reference's leaves and distributions; ``A_log`` (S4D-real) and
    ``D`` are float32 whatever ``dtype`` is, as there."""
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    state = cfg.ssm_state
    dt_rank = max(d // DT_RANK_DIV, 8)
    dev = gen.device
    a_init = torch.arange(1, state + 1, dtype=torch.float32,
                          device=dev).expand(inner, state)
    return {
        "in_proj": dense_init(gen, (d, 2 * inner), dtype),
        "conv_w": dense_init(gen, (cfg.conv_kernel, inner), dtype,
                             fan_in=cfg.conv_kernel),
        "x_proj": dense_init(gen, (inner, dt_rank + 2 * state), dtype),
        "dt_proj": dense_init(gen, (dt_rank, inner), dtype, fan_in=dt_rank),
        "dt_bias": torch.zeros((inner,), dtype=dtype, device=dev),
        "A_log": torch.log(a_init).contiguous(),
        "D": torch.ones((inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (inner, d), dtype, fan_in=inner),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv over time.  x: (B,T,C), w: (K,C).

    ``state`` (B, K-1, C) holds the trailing inputs for decode.  Computes in
    x's dtype, the state included; returns (y, new_state) with new_state
    (B, K-1, C) in x's dtype.
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:], dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return y, new_state


def _ssm_params(p, xc, cfg):
    """Input-dependent dt (B,T,inner), B and C (B,T,state), all float32,
    from the conv output."""
    state = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]
    dt_lowrank = proj[..., :dt_rank]
    b_t = proj[..., dt_rank:dt_rank + state].float()
    c_t = proj[..., dt_rank + state:].float()
    dt = F.softplus((dt_lowrank @ p["dt_proj"]).float()
                    + p["dt_bias"].float())
    return dt, b_t, c_t


def _scan_chunk(h, dt, b_t, c_t, xf, a):
    """The recurrence over one chunk under grad: h (B, inner, S) and the
    chunk's dt, xf (B, C, inner), B and C (B, C, S), all float32.  Returns
    (y (B, C, inner), the last h)."""
    dec = torch.exp(dt[..., None] * a)                       # (B,C,inner,S)
    drv = (dt * xf)[..., None] * b_t[:, :, None, :]
    # unbind, not an index a position: the backward stacks the positions'
    # gradients once, where each index's backward would fill and add a
    # whole (B, C, inner, S) gradient
    hs = []
    for dec_t, drv_t in zip(dec.unbind(1), drv.unbind(1)):
        h = torch.addcmul(drv_t, dec_t, h)
        hs.append(h)
    y = torch.einsum("btis,bts->bti", torch.stack(hs, dim=1), c_t)
    return y, h


def _scan_grad(h, dt, b_t, c_t, xf, a):
    """The scan under grad: chunks of CHUNK positions, each checkpointed,
    where the reference chunks (T > CHUNK, T % CHUNK == 0); else one flat
    chunk."""
    t = dt.shape[1]
    if not (t > CHUNK and t % CHUNK == 0):
        return _scan_chunk(h, dt, b_t, c_t, xf, a)
    ys = []
    for c0 in range(0, t, CHUNK):
        y, h = _ckpt.checkpoint(
            _scan_chunk, h, *(x[:, c0:c0 + CHUNK] for x in (dt, b_t, c_t,
                                                             xf)), a,
            use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def apply_ssm(p: dict, x, cfg, *, cache=None):
    """x: (B, T, d) -> (y (B, T, d), new_cache).

    cache = {"conv": (B, K-1, inner), "state": (B, inner, state) float32}
    or None (a zero state).  Without grad the recurrence is a loop over
    positions, a step at a time; under grad (an input or a parameter that
    requires it) :func:`_scan_grad`, chunked and checkpointed as the
    reference's scan.  Both give the numbers of the reference's flat scan.
    """
    inner = cfg.ssm_expand * cfg.d_model
    xz = x @ p["in_proj"]
    xs, z = xz[..., :inner], xz[..., inner:]
    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xc = silu(xc)

    dt, b_t, c_t = _ssm_params(p, xc, cfg)          # (B,T,inner), (B,T,S)x2
    a = -torch.exp(p["A_log"])                       # (inner, S) fp32
    xf = xc.float()
    h = (torch.zeros((x.shape[0], inner, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
         if cache is None else cache["state"])
    if torch.is_grad_enabled() and (dt.requires_grad or xf.requires_grad
                                    or a.requires_grad or h.requires_grad):
        y, h = _scan_grad(h, dt, b_t, c_t, xf, a)
    else:
        ys = []
        for t in range(x.shape[1]):
            dec = torch.exp(dt[:, t, :, None] * a)               # (B,inner,S)
            drv = (dt[:, t] * xf[:, t])[..., None] * b_t[:, t, None, :]
            h = dec * h + drv
            ys.append(torch.bmm(h, c_t[:, t, :, None])[..., 0])  # (B,inner)
        y = torch.stack(ys, dim=1)                               # (B,T,inner)
    y = y + p["D"] * xf
    y = y.to(x.dtype) * silu(z)
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "state": h}


def init_ssm_cache(cfg, batch: int, *, device) -> dict:
    inner = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, inner),
                                dtype=torch.float32, device=device),
            "state": torch.zeros((batch, inner, cfg.ssm_state),
                                 dtype=torch.float32, device=device)}
