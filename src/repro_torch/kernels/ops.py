"""Public entry points of the kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises.  A
CPU tensor goes to the kernel's plain version in :mod:`.ref`.  There is no
other switch and no fallback.  Port of ``repro.kernels.ops``.
"""
from __future__ import annotations

from . import flash_attention as _fa
from .ref import reference_attention


def flash_attention(q, k, v, *, q_pos=None, kv_pos=None, causal: bool = True,
                    window: int = 0):
    """q: (B,T,H,D); k/v: (B,S,KV,D) -> (B,T,H,D).  See :mod:`.ref`."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                   causal=causal, window=window)
    return reference_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               causal=causal, window=window)
