"""JAX's threefry2x32 random stream in torch, bit for bit.

The cycle engine draws its arbitration and Valiant bits exactly as the
reference's compiled engine does (``jax.random`` with
``jax_threefry_partitionable=True``), so the two can be held equal on every
statistic.  Words are ``int64`` tensors holding unsigned 32-bit values:
every sum is masked back to 32 bits, and rotations shift in 64 bits where
nothing overflows.  (``torch.uint32`` has no shifts on CUDA.)

* ``prng_key(s)``         = ``(0, s)``, JAX's ``PRNGKey`` for ``0 <= s < 2**32``;
* ``fold_in(k, d)``       = ``threefry2x32(k, (0, d))``;
* ``random_bits(k, n)[i]`` = ``y0 ^ y1`` of ``threefry2x32(k, (0, i))``.

Keys are ``(..., 2)`` tensors; every function broadcasts over the leading
axes, so one call folds or draws for many cycles and copies at once.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block of JAX's ``threefry_2x32``: key
    words ``(k0, k1)``, counter words ``(x0, x1)``, all broadcastable
    int64 tensors of 32-bit values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``: ``(0, seed)``."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``, broadcast over ``key[..., 0]``
    and ``data`` (int tensors; ``data`` taken mod 2**32)."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data.to(torch.int64) & _MASK)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, n: int,
                counter: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32 words as int64) for each key
    of ``key`` (shape ``(..., 2)``): returns ``(..., n)``.  ``counter``
    may pass a precomputed ``arange(n)`` on the key's device."""
    if counter is None:
        counter = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros((), dtype=torch.int64,
                                      device=key.device), counter)
    return y0 ^ y1
