"""Public entry points of the kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises.  A
CPU tensor goes to the kernel's plain version in :mod:`.ref`.  There is no
other switch and no fallback.  Port of ``repro.kernels.ops``.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import mlstm_scan as _ms
from .ref import reference_attention, reference_mlstm_scan


def flash_attention(q, k, v, *, q_pos=None, kv_pos=None, causal: bool = True,
                    window: int = 0, return_lse: bool = False):
    """q: (B,T,H,D); k/v: (B,S,KV,D) -> (B,T,H,D), and with ``return_lse``
    the (B,H,T) fp32 log-sum-exp beside it.  See :mod:`.ref`."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                   causal=causal, window=window,
                                   return_lse=return_lse)
    return reference_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               causal=causal, window=window,
                               return_lse=return_lse)


def mlstm_scan(q, k, v, log_i, log_f, state=None, *, chunk: int = 256):
    """q/k/v: (B,T,H,D); log_i/log_f: (B,T,H) -> (h in q's dtype,
    (C, n, m) float32).  T a multiple of ``chunk``; ``state`` None starts
    from zero.  See :func:`.ref.reference_mlstm_scan`."""
    if q.is_cuda:
        return _ms.mlstm_scan(q, k, v, log_i, log_f, state, chunk=chunk)
    return reference_mlstm_scan(q, k, v, log_i, log_f, state, chunk=chunk)
