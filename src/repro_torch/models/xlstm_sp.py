"""Context-parallel mLSTM: sequence parallelism for the recurrent arch.

Port of ``repro.models.xlstm_sp`` over a ``torch.distributed`` group, the
sequence split across its ranks in rank order.  Every rank runs the
zero-init chunkwise pass on its segment
(:func:`~.xlstm.mlstm_chunkwise_raw`); the per-segment affine state
summaries ``(F, C, n, m)`` are prefix-combined across ranks with a
log2(S)-step Hillis-Steele scan of
:func:`~repro_torch.core.collectives.ppermute` shifts (differentiable:
each shift's backward is the inverse shift), and each position is then
corrected with its inbound prefix state:

    m'   = max(m_loc, b + m_in)
    num' = e^{m_loc - m'} num + e^{b + m_in - m'} (q C_in)
    dot' = e^{m_loc - m'} dot + e^{b + m_in - m'} (q n_in)
    h    = num' / max(|dot'|, e^{-m'})

The state combine is associative, so the scan is exact.  On the paper's
fabric each scan step's shift is contention-free (a subset of a 1-factor),
and the state traffic is log2(S) * |state| where a sequential chain of
segments moves S * |state|.  The denominator's floor is the port's
:func:`~.xlstm._denominator` (exponent clamped, ROADMAP C16).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.collectives import ppermute

from .xlstm import _denominator, mlstm_chunkwise_raw


def _combine(a, b):
    """Sequential composition: segment ``a`` then segment ``b``.  States
    are (F, C, n, m) with true_C = e^m * C_stored."""
    Fa, Ca, na, ma = a
    Fb, Cb, nb, mb = b
    m_new = torch.maximum(Fb + ma, mb)
    sa = torch.exp(Fb + ma - m_new)
    sb = torch.exp(mb - m_new)
    C = sa[..., None, None] * Ca + sb[..., None, None] * Cb
    n = sa[..., None] * na + sb[..., None] * nb
    return (Fa + Fb, C, n, m_new)


def _identity_like(state):
    F, C, n, m = state
    return (torch.zeros_like(F), torch.zeros_like(C), torch.zeros_like(n),
            torch.full_like(m, -math.inf))


def _where(cond: bool, a, b):
    """``a`` where ``cond`` else ``b``, leaf by leaf, with both in the
    graph: every rank builds the same autograd graph, so each shift's
    backward runs on every rank, as the reference's ``jnp.where`` keeps
    it."""
    c = torch.tensor(cond, device=a[0].device)
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def distributed_exclusive_scan(state, group=None):
    """Exclusive prefix of the segment states over ``group``'s ranks
    (Hillis-Steele: log2(S) shifts, then one shift by a rank).  Every
    rank of the group calls it."""
    size, idx = dist.get_world_size(group), dist.get_rank(group)
    prefix = state                      # the inclusive prefix so far
    k = 1
    while k < size:
        pairs = [(i, i + k) for i in range(size - k)]
        recv = tuple(ppermute(x, pairs, group) for x in prefix)
        prefix = _where(idx >= k, _combine(recv, prefix), prefix)
        k *= 2
    # exclusive = the inclusive prefix of the previous rank
    shift = [(i, i + 1) for i in range(size - 1)]
    excl = tuple(ppermute(x, shift, group) for x in prefix)
    return _where(idx == 0, _identity_like(state), excl)


def apply_inbound(q, raw, inbound):
    """h (B, T, H, D) in q's dtype of a segment from its raw chunkwise
    terms (:func:`~.xlstm.mlstm_chunkwise_raw`'s output) and the state
    ``inbound`` (F, C, n, m) of everything before it."""
    num, dot, m_loc, bg, _ = raw
    _, C_in, n_in, m_in = inbound
    qs = q.float() / math.sqrt(q.shape[-1])
    corr_num = torch.einsum("bthd,bhde->bthe", qs, C_in)
    corr_dot = torch.einsum("bthd,bhd->bth", qs, n_in)
    expo = bg + m_in[:, None, :]                       # (B,T,H)
    m_tot = torch.maximum(m_loc, expo)
    s_loc = torch.exp(m_loc - m_tot)
    s_in = torch.exp(expo - m_tot)
    num2 = s_loc[..., None] * num + s_in[..., None] * corr_num
    dot2 = s_loc * dot + s_in * corr_dot
    return (num2 / _denominator(dot2, m_tot)[..., None]).to(q.dtype)


def mlstm_context_parallel(q, k, v, log_i, log_f, *, group=None,
                           chunk: int = 64):
    """q/k/v: (B, T_local, H, D), this rank's segment of the sequence
    (rank r holds positions r*T_local to (r+1)*T_local - 1); log_i/log_f:
    (B, T_local, H).  Returns h (B, T_local, H, D) in q's dtype, equal to
    the sequential mLSTM over the whole sequence.  Every rank of
    ``group`` calls it."""
    raw = mlstm_chunkwise_raw(q, k, v, log_i, log_f, chunk=chunk)
    return apply_inbound(q, raw, distributed_exclusive_scan(raw[4], group))
