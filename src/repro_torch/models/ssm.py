"""Mamba-style selective SSM branch (hymba's parallel heads), and the
depthwise causal convolution it shares with the xLSTM blocks.

Port of ``repro.models.ssm``.  Prefill runs the recurrence one position at
a time with an fp32 state carry h of (B, inner, state): the (B, T, inner,
state) decay and drive tensors are never formed (at hymba-1.5b's width and
640 positions they would be 524 MB a layer).  Decode is one step of the
same recurrence against the cached (conv window, ssm state) pair.  The loop
is plain PyTorch: the reference's is a ``lax.scan`` in jnp, not a Pallas
kernel.

On a mesh with a ``tp`` axis, given this rank's ``tp`` slices of the
channel leaves (``conv_w``, ``x_proj``, ``dt_proj``, ``dt_bias``,
``A_log``, ``D``, ``out_proj``, as ``runtime.sharding.param_specs`` places
them), the branch is channel-parallel: each rank runs the recurrence on
its ``inner/tp`` channels, which needs no exchange, ``x_proj`` is
row-parallel with its sum all-reduced both ways (:func:`~.layers.sum_tp`:
every rank's channels read the whole dt, B and C) and ``out_proj``
row-parallel.  ``in_proj`` holds ``[xs | z]`` side by side, so its
contiguous ``tp`` slices would give one rank every ``xs`` column and the
next every ``z`` column: the layer takes it whole and cuts this rank's
columns of both halves.  Given whole leaves it computes whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from . import layers as L
from .layers import AxisRules, dense_init, silu

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


def _ssm_params(p, xc, cfg, rules: AxisRules = AxisRules(),
                sliced: bool = False):
    """Input-dependent dt (B,T,inner), B and C (B,T,state), all float32,
    from the conv output; ``sliced``: ``xc`` and the leaves this rank's
    channels, the ``x_proj`` product summed over ``tp`` both ways."""
    state = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]
    if sliced:
        proj = L.sum_tp(proj, rules)
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


def ssm_channels(cfg, rules: AxisRules = AxisRules()) -> int:
    """The SSM channels a rank computes: ``inner/tp`` where they split over
    ``tp`` (the leaves are then placed on it), else all of ``inner``."""
    inner = cfg.ssm_expand * cfg.d_model
    tp = rules.tp_size
    return inner // tp if inner % tp == 0 else inner


def _in_proj(p, x, cfg, rules: AxisRules, sliced: bool):
    """xs and z (B, T, channels): ``in_proj``'s two halves, whole, or this
    rank's columns of each cut from the whole leaf (its input's and its own
    gradients summed over ``tp``)."""
    inner = cfg.ssm_expand * cfg.d_model
    if not sliced:
        xz = x @ p["in_proj"]
        return xz[..., :inner], xz[..., inner:]
    ci = p["out_proj"].shape[0]
    c0 = rules.tp_rank * ci
    w = L.enter_tp(p["in_proj"], rules)
    w = torch.cat([w[:, c0:c0 + ci], w[:, inner + c0:inner + c0 + ci]], 1)
    xz = L.enter_tp(x, rules) @ w
    return xz[..., :ci], xz[..., ci:]


def apply_ssm(p: dict, x, cfg, *, cache=None,
              rules: AxisRules = AxisRules()):
    """x: (B, T, d) -> (y (B, T, d), new_cache).

    cache = {"conv": (B, K-1, channels), "state": (B, channels, state)
    float32} or None (a zero state); channels are ``inner``, or this rank's
    ``inner/tp`` where ``out_proj`` holds its ``tp`` slice (the module
    docstring).  Without grad the recurrence is a loop over positions, a
    step at a time; under grad (an input or a parameter that requires it)
    :func:`_scan_grad`, chunked and checkpointed as the reference's scan.
    Both give the numbers of the reference's flat scan.
    """
    inner = cfg.ssm_expand * cfg.d_model
    sliced = L.tp_sliced(p["out_proj"].shape[0], inner, rules, "out_proj")
    xs, z = _in_proj(p, x, cfg, rules, sliced)
    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xc = silu(xc)

    dt, b_t, c_t = _ssm_params(p, xc, cfg, rules, sliced)  # (B,T,ci), (B,T,S)
    a = -torch.exp(p["A_log"])                       # (ci, S) fp32
    xf = xc.float()
    h = (torch.zeros((x.shape[0], xs.shape[-1], cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
         if cache is None else cache["state"])
    if torch.is_grad_enabled() and (dt.requires_grad or xf.requires_grad
                                    or a.requires_grad or h.requires_grad):
        y, h = _scan_grad(h, dt, b_t, c_t, xf, a)
    else:
        ys = []
        for t in range(x.shape[1]):
            dec = torch.exp(dt[:, t, :, None] * a)               # (B,ci,S)
            drv = (dt[:, t] * xf[:, t])[..., None] * b_t[:, t, None, :]
            h = dec * h + drv
            ys.append(torch.bmm(h, c_t[:, t, :, None])[..., 0])  # (B,ci)
        y = torch.stack(ys, dim=1)                               # (B,T,ci)
    y = y + p["D"] * xf
    y = y.to(x.dtype) * silu(z)
    out = y @ p["out_proj"]
    if sliced:
        out = L.reduce_tp(out, rules)
    return out, {"conv": new_conv, "state": h}


def init_ssm_cache(cfg, batch: int, *, device,
                   rules: AxisRules = AxisRules()) -> dict:
    """A zero cache of this rank's channels (:func:`ssm_channels`)."""
    ci = ssm_channels(cfg, rules)
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, ci),
                                dtype=torch.float32, device=device),
            "state": torch.zeros((batch, ci, cfg.ssm_state),
                                 dtype=torch.float32, device=device)}
