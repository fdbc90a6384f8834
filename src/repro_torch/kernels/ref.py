"""Plain PyTorch versions of the hand-written kernels in this package.

Each is the kernel's contract written in the most obvious O(T*S)-memory
way.  On the CPU the wrappers in :mod:`repro_torch.kernels.ops` run these;
on the card the kernels are held against them.
"""
from __future__ import annotations

import math

import torch


def reference_attention(q, k, v, *, q_pos=None, kv_pos=None,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q: (B,T,H,D); k/v: (B,S,KV,D) -> (B,T,H,D).  fp32 softmax.

    Query head h reads KV head ``h // (H/KV)``.  A key is visible iff
    ``kv_pos >= 0``, and with ``causal`` iff ``kv_pos <= q_pos``, and with
    ``window > 0`` iff ``q_pos - kv_pos < window``.  Rows that see no key
    are zeros.  With ``return_lse`` also the log-sum-exp of each row's
    visible scaled scores, fp32 (B, H, T), 1e30 for a row that sees no
    key (as ``repro.models.flash`` keeps it).  Port of
    ``repro.kernels.ref.reference_attention``.
    """
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if q_pos is None:
        q_pos = torch.arange(t, dtype=torch.int32, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(s, dtype=torch.int32, device=q.device)
    qg = q.reshape(b, t, kvh, g, d).float() / math.sqrt(d)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    ok = kv_pos[None, :] >= 0
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    logits = logits.masked_fill(~ok, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    seen = ok.any(dim=-1)
    o = (o * seen[None, :, None, None, None]).reshape(b, t, h, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(logits, dim=-1).masked_fill(~seen, 1e30)
    return o, lse.reshape(b, h, t)


def reference_mlstm(q, k, v, log_i, log_f, state=None):
    """Sequential stabilized mLSTM, the exact oracle: a re-export of
    :func:`repro_torch.models.xlstm.mlstm_sequential` (imported here, at
    call time, because that module imports this package).  Port of
    ``repro.kernels.ref.reference_mlstm``."""
    from repro_torch.models.xlstm import mlstm_sequential
    return mlstm_sequential(q, k, v, log_i, log_f, state)


def reference_mlstm_scan(q, k, v, log_i, log_f, state=None, *,
                         chunk: int = 256):
    """The plain version of the ``mlstm_scan`` kernel:
    :func:`repro_torch.models.xlstm.mlstm_chunkwise`, with h in q's dtype.
    Returns (h (B,T,H,D), (C, n, m) float32)."""
    from repro_torch.models.xlstm import mlstm_chunkwise
    h, final = mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk)
    return h.to(q.dtype), final


def reference_mlstm_scan_float64(q, k, v, log_i, log_f, state=None, *,
                                 chunk: int = 256):
    """:func:`reference_mlstm_scan`'s arithmetic in float64 on the same
    inputs (and state): the answer an fp32 scan is read against where its
    plain version misses it (``mlstm_scan.check_fp32``).  Returns h and
    (C, n, m) in float64."""
    from repro_torch.models.xlstm import _chunk_terms, _denominator
    b, t, h, d = q.shape
    q, k, v, li, lf = (x.double() for x in (q, k, v, log_i, log_f))
    q = q / math.sqrt(d)
    if state is None:
        state = (q.new_zeros((b, h, d, d)), q.new_zeros((b, h, d)),
                 q.new_full((b, h), -math.inf))
    state = tuple(x.double() for x in state)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]
    hs = []
    for c in range(t // chunk):
        s = slice(c * chunk, (c + 1) * chunk)
        num, dot, m_row, _, state = _chunk_terms(
            q[:, s], k[:, s], v[:, s], li[:, s], lf[:, s], tri, *state)
        hs.append(num / _denominator(dot, m_row)[..., None])
    return torch.cat(hs, dim=1), state
