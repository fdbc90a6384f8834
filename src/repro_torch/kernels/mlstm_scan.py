"""Chunkwise mLSTM forward on the card: the wrapper of ``csrc/mlstm_scan.cu``.

Port of the TPU kernel ``repro.kernels.mlstm_scan`` (Pallas).  Same
contract as :func:`repro_torch.kernels.ref.reference_mlstm_scan`, its plain
version: the stabilized mLSTM recurrence over q/k/v (B,T,H,D) and the gate
pre-activations log_i/log_f (B,T,H), T a multiple of ``chunk``, q scaled by
1/sqrt(D), fp32 arithmetic, h in q's dtype.  Unlike the Pallas kernel it
also takes an initial state and returns the final one, (C (B,H,D,D),
n (B,H,D), m (B,H)) in fp32, which decode continues from.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: Kernel launches since the count was last set to 0.
launches = 0

MAX_HEAD_DIM = 512     # C[:, 64 columns] of fp32 fills 128 KB of shared memory
MAX_CHUNK = 1024
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("mlstm_scan")
        fn = lib.repro_mlstm_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_state(state, b, h, d, device):
    if state is None:
        return None, None, None
    shapes = ((b, h, d, d), (b, h, d), (b, h))
    if len(state) != 3 or any(
            s.shape != shape or s.dtype != torch.float32 or s.device != device
            or not s.is_contiguous() for s, shape in zip(state, shapes)):
        raise ValueError(f"state must be contiguous float32 (C, n, m) of "
                         f"shapes {shapes} on {device}")
    return tuple(s.data_ptr() for s in state)


def mlstm_scan(q, k, v, log_i, log_f, state=None, *, chunk: int = 256):
    """q/k/v: (B,T,H,D); log_i/log_f: (B,T,H) float32, on the card ->
    (h (B,T,H,D) in q's dtype, (C, n, m) float32)."""
    global launches
    tensors = (q, k, v, log_i, log_f)
    if not (q.is_cuda and all(x.device == q.device for x in tensors)):
        raise ValueError("mlstm_scan runs on CUDA tensors, all on one device; "
                         "CPU tensors go to ops.mlstm_scan")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if log_i.dtype != torch.float32 or log_f.dtype != torch.float32:
        raise TypeError(f"log_i and log_f must be float32; got {log_i.dtype}, "
                        f"{log_f.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v (B,T,H,D) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if log_i.shape != (b, t, h) or log_f.shape != (b, t, h):
        raise ValueError(f"want log_i, log_f of shape {(b, t, h)}; got "
                         f"{tuple(log_i.shape)}, {tuple(log_f.shape)}")
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if not (isinstance(chunk, int) and 0 < chunk <= MAX_CHUNK):
        raise ValueError(f"chunk must be an int in 1..{MAX_CHUNK}, got {chunk}")
    if t == 0 or t % chunk:
        raise ValueError(f"T={t} must be a positive multiple of chunk={chunk}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v, log_i and log_f must be contiguous")
    c_in, n_in, m_in = _check_state(state, b, h, d, q.device)
    lib = _library()
    out = torch.empty_like(q)
    c = torch.empty((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_mlstm_scan_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(), c_in, n_in, m_in, out.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), b, t, h, d, chunk, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: cudaError_t {err}")
    launches += 1
    return out, (c, n, m)
