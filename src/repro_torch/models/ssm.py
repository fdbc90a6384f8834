"""The depthwise causal convolution of the recurrent blocks.

Port of ``repro.models.ssm._causal_conv``; the selective SSM of that module
comes with the hybrid blocks that use it (ROADMAP queue A, item 10).
"""
from __future__ import annotations

import torch


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
