"""Flash attention under autograd: the Hopper kernel forward, a blocked
FlashAttention-2 backward.

Port of ``repro.models.flash``, whose ``flash_attention_jnp`` is a
``jax.custom_vjp`` that saves only (O, LSE) and recomputes the probability
blocks in the backward.  Here the same split is a ``torch.autograd.Function``:

- forward: the attention kernel through :func:`repro_torch.kernels.ops.
  flash_attention` with ``return_lse=True``, so on the card the bf16
  prefill kernel (``csrc/flash_attention_prefill.cu``, whatever T is) or
  the fp32 kernel (``csrc/flash_attention_fp32tc.cu``), and on the CPU their
  plain version.  It saves ``(q, k, v, o, lse)``.
- backward: :func:`flash_backward`, the reference's ``_flash_bwd`` in
  plain PyTorch, blocked as it blocks: a dQ pass (each Q block over the KV
  chunks) and a dK/dV pass (each KV chunk over the Q blocks), each
  recomputing ``p = exp(s - lse)`` block by block, in fp32, with dK and dV
  summed over the G query heads of a KV group.  The reference computes that
  backward in jnp/XLA outside any Pallas kernel, so it is not a kernel port.

Conventions:

- ``lse`` is 1e30 on a row that sees no key, so its ``p`` and its
  gradients are exactly 0.
- A key is masked by ``kv_pos < 0`` (the kernel's contract); the
  reference's ``_mask`` masks by ``kv_pos == int32 max``.  Padded rows and
  chunks are never built here: a short last block is a slice.

``backward_calls`` counts backward passes, as the kernel wrappers count
their launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops

#: Backward passes of :class:`FlashAttention` since the count was last set
#: to 0.
backward_calls = 0

LSE_EMPTY = 1e30       # the lse of a row that sees no key


def block_bounds(t: int, s: int, *, causal: bool, window: int,
                 q_block: int, kv_chunk: int):
    """Static per-Q-block [lo, hi) KV-chunk ranges for aligned causal
    self-attention (q_pos == kv_pos == arange(t), t == s).  A copy of
    ``repro.models.flash.block_bounds``."""
    tp = t + (-t) % q_block
    sp = s + (-s) % kv_chunk
    nq, nk = tp // q_block, sp // kv_chunk
    out = []
    for i in range(nq):
        q_lo, q_hi = i * q_block, min((i + 1) * q_block, t) - 1
        hi = min(nk, -(-(q_hi + 1) // kv_chunk)) if causal else nk
        if window and window > 0:
            lo = max(0, (q_lo - window + 1) // kv_chunk)
        else:
            lo = 0
        out.append((lo, max(hi, lo + 1)))
    return tuple(out)


def _visible(qp, kp, window: int, causal: bool):
    """(bq, bk) boolean visibility under the kernel's mask convention."""
    ok = (kp[None, :] >= 0).expand(qp.shape[0], -1)
    if causal:
        ok = ok & (kp[None, :] <= qp[:, None])
    if window > 0:
        ok = ok & ((qp[:, None] - kp[None, :]) < window)
    return ok


def flash_backward(q, k, v, q_pos, kv_pos, o, lse, do, *, window: int,
                   causal: bool, q_block: int = 1024, kv_chunk: int = 1024):
    """dq, dk, dv of attention (q (B,T,H,D), k/v (B,S,KV,D)) given the
    forward's output ``o`` and log-sum-exp ``lse`` (B,H,T) and the output
    gradient ``do``.  fp32 throughout; the results in the inputs' dtypes.
    Port of ``repro.models.flash._flash_bwd`` (without ``bands``)."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)

    def grouped(x):                       # (b,t,h,d) -> (b,kvh,g,t,d) fp32
        return x.reshape(b, t, kvh, g, d).permute(0, 2, 3, 1, 4).float()

    qg, dog, og = grouped(q), grouped(do), grouped(o)
    kg = k.permute(0, 2, 1, 3).float()    # (b,kvh,s,d)
    vg = v.permute(0, 2, 1, 3).float()
    delta = (dog * og).sum(-1)            # (b,kvh,g,t)
    lse_g = lse.reshape(b, kvh, g, t)
    qs = [(i, min(i + q_block, t)) for i in range(0, t, q_block)]
    ks = [(j, min(j + kv_chunk, s)) for j in range(0, s, kv_chunk)]

    def p_of(i0, i1, j0, j1):
        sblk = torch.einsum("bkgtd,bksd->bkgts", qg[:, :, :, i0:i1],
                            kg[:, :, j0:j1]) * scale
        p = torch.exp(sblk - lse_g[:, :, :, i0:i1, None])
        ok = _visible(q_pos[i0:i1], kv_pos[j0:j1], window, causal)
        return p.masked_fill(~ok, 0.0)

    def ds_of(p, i0, i1, j0, j1):
        dp = torch.einsum("bkgtd,bksd->bkgts", dog[:, :, :, i0:i1],
                          vg[:, :, j0:j1])
        return p * (dp - delta[:, :, :, i0:i1, None])

    # pass 1: dQ (outer over Q blocks, KV chunks inside)
    dq = torch.empty_like(qg)
    for i0, i1 in qs:
        acc = torch.zeros_like(qg[:, :, :, i0:i1])
        for j0, j1 in ks:
            ds = ds_of(p_of(i0, i1, j0, j1), i0, i1, j0, j1)
            acc = acc + torch.einsum("bkgts,bksd->bkgtd", ds,
                                     kg[:, :, j0:j1]) * scale
        dq[:, :, :, i0:i1] = acc

    # pass 2: dK, dV (outer over KV chunks, Q blocks inside)
    dk = torch.empty_like(kg)
    dv = torch.empty_like(vg)
    for j0, j1 in ks:
        dk_j = torch.zeros_like(kg[:, :, j0:j1])
        dv_j = torch.zeros_like(vg[:, :, j0:j1])
        for i0, i1 in qs:
            p = p_of(i0, i1, j0, j1)
            dv_j = dv_j + torch.einsum("bkgts,bkgtd->bksd", p,
                                       dog[:, :, :, i0:i1])
            ds = ds_of(p, i0, i1, j0, j1)
            dk_j = dk_j + torch.einsum("bkgts,bkgtd->bksd", ds,
                                       qg[:, :, :, i0:i1]) * scale
        dk[:, :, j0:j1] = dk_j
        dv[:, :, j0:j1] = dv_j

    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel forward and :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window: int, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = kops.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                      causal=causal, window=window,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, o, lse)
        ctx.window, ctx.causal = window, causal
        return o

    @staticmethod
    def backward(ctx, do):
        global backward_calls
        q, k, v, q_pos, kv_pos, o, lse = ctx.saved_tensors
        backward_calls += 1
        dq, dk, dv = flash_backward(q, k, v, q_pos, kv_pos, o, lse, do,
                                    window=ctx.window, causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, q_pos, kv_pos, window: int = 0,
                    causal: bool = True):
    """q: (B,T,H,D); k/v: (B,S,KV,D) -> (B,T,H,D), differentiable in q, k
    and v.  ``q_pos`` (T,) and ``kv_pos`` (S,) int32 on q's device."""
    return FlashAttention.apply(q, k, v, q_pos, kv_pos, window, causal)
