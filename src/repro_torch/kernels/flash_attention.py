"""Flash-attention forward on the card: the wrapper of
``csrc/flash_attention.cu``.

Port of the TPU kernel ``repro.kernels.flash_attention`` (Pallas).  Same
contract as :func:`repro_torch.kernels.ref.reference_attention`, its plain
version: GQA attention on q (B,T,H,D) and k/v (B,S,KV,D) with causal,
sliding-window and ``kv_pos < 0`` masking by absolute positions, an fp32
online softmax, zeros for rows that see no key, and the output in q's
dtype.  ``window`` is a plain Python int passed to the kernel at run time.

The kernel pads T and S to its tiles itself, the way the reference pads
them: zero rows, query position 0 and key position -1, so padded KV slots
are masked.  Nothing is copied or padded here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: Kernel launches since the count was last set to 0.
launches = 0

_HEAD_DIMS = (16, 32, 64, 128)
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        fn = lib.repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _positions(pos, n, device, name):
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    if pos.dtype != torch.int32 or pos.shape != (n,) or pos.device != device \
            or not pos.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 vector of length "
                         f"{n} on {device}; got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    return pos


def flash_attention(q, k, v, *, q_pos=None, kv_pos=None, causal: bool = True,
                    window: int = 0):
    """q: (B, T, H, D); k/v: (B, S, KV, D) on the card -> (B, T, H, D)."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention runs on CUDA tensors, all on one "
                         "device; CPU tensors go to ops.flash_attention")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,T,H,D) and k, v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    _, s, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"batch and head_dim must match and KV heads divide "
                         f"query heads; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if t == 0 or s == 0:
        raise ValueError("T and S must be positive")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not isinstance(window, int):
        raise TypeError(f"window must be a Python int, got {type(window)}")
    lib = _library()
    block_q = 16 if t <= 16 else 64
    qp = _positions(q_pos, t, q.device, "q_pos")
    kp = _positions(kv_pos, s, q.device, "kv_pos")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
        out.data_ptr(), b, t, s, h, kvh, d, block_q, int(causal), window,
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
