"""Flash-attention forward on the card: the wrapper of the CUDA kernels.

Port of the TPU kernel ``repro.kernels.flash_attention`` (Pallas).  Same
contract as :func:`repro_torch.kernels.ref.reference_attention`, its plain
version: GQA attention on q (B,T,H,D) and k/v (B,S,KV,D) with causal,
sliding-window and ``kv_pos < 0`` masking by absolute positions, an fp32
online softmax, zeros for rows that see no key, and the output in q's
dtype.  ``window`` is a plain Python int passed to the kernel at run time.
With ``return_lse`` the fp32_tc and prefill kernels also write each row's
log-sum-exp (fp32, (B, H, T), 1e30 where a row sees no key), which the
training backward (:mod:`repro_torch.models.flash`) recomputes the
probabilities from.

The kernels' outputs are tensors autograd cannot see, so a call with grad
mode on and an input that requires grad raises: training reaches the
kernels only through :class:`repro_torch.models.flash.FlashAttention`,
whose forward runs with grad mode off.

Which kernel runs is a fixed rule on dtype and T, made by :func:`plan`
(pure Python, no device); the block sizes also follow D, which may be 16,
32, 64, 128 or 256:

- float32 (path ``"fp32_tc"``): ``csrc/flash_attention_fp32tc.cu``, the
  bf16 tensor cores (wgmma) in split precision, fed by TMA: each fp32
  operand is split into ``FP32_TERMS`` bf16 terms that sum to it exactly,
  and each product is the sum of the six term products that matter at
  fp32 rounding.  One rounding of each operand to bf16 or TF32 would miss
  the fp32 tolerance (2e-5); the split holds it.  One block per (batch, KV
  head, tile of positions) holds all G query heads of the group: 128
  (position, head) rows, 64 at D = 256.  Decode steps (T <= 16) take it
  too.
- bfloat16, T > 16 (prefill): ``csrc/flash_attention_prefill.cu``,
  tensor cores (wgmma) fed by TMA; one block per (batch, KV head, tile of
  positions) holds all G = H/KV query heads of the group: 192 (position,
  head) rows, 64 at D = 256, where its two consumer warpgroups split O's
  columns over the same rows.
- bfloat16, T <= 16 (decode): ``csrc/flash_attention_decode.cu``, the
  keys cut in splits, one block per (batch, KV head, split, chunk of at
  most 64 of the group's G x T rows, 32 at D = 256),
  and a combine pass over the splits' fp32 scratch, which is allocated
  here.  A call that asks for the log-sum-exp takes the prefill kernel
  instead, whatever its T: the decode kernel writes none.

At D = 256 (gemma3-1b) the blocks shrink because Q, the K/V tiles and the
accumulators of a D <= 128 block would not fit an SM's shared memory and
registers; each kernel's source says how.

No path reads a position back to the host.  The kernels pad T and S to
their tiles themselves, the way the reference pads them: zero rows, query
position 0 and key position -1, so padded KV slots are masked.

On fake tensors (``torch._subclasses.fake_tensor``: a step traced for its
shapes, ``launch/dryrun.py``) the wrapper runs the same checks and
:func:`plan` at :data:`H100_SMS`, returns empty outputs of the right
shapes, and appends the call's path and :func:`work` to
:data:`traced_calls` where a list is set there.  It loads and launches
nothing, and counts no launch.  A tensor with data never takes that
branch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from . import _build

#: Wrapper calls (one per attention call) since the count was last set to 0.
launches = 0
#: The same calls by the kernel they launched (decode: its split kernel and
#: its combine pass); set each to 0 with ``launches``.
launches_by_path = {"fp32_tc": 0, "prefill": 0, "decode": 0}
#: Calls on fake tensors, as (path, operations, bytes) of :func:`work`,
#: appended while a list is set here; None records none.
traced_calls: list | None = None

_HEAD_DIMS = (16, 32, 64, 128, 256)
KEY_TILE = 64          # keys per K/V tile, in every kernel
PREFILL_ROWS = 192     # (position, head) rows of a prefill block: 3 x 64
DECODE_MAX_T = 16      # bf16 calls with at most this many positions decode
DECODE_ROWS = 64       # (position, head) rows of a decode block at most
FP32_TC_ROWS = 128     # (position, head) rows of an fp32 tensor-core block
FP32_TERMS = 3         # bf16 terms of each fp32 operand in that kernel (kTerms)
# At D = 256: prefill rows 64, decode rows 32, fp32 tensor-core rows 64
# (each kernel's source says why).
D256_PREFILL_ROWS, D256_DECODE_ROWS, D256_FP32_TC_ROWS = 64, 32, 64
H100_SMS = 132

# path: (source under csrc/, C entry point, pointer and int arguments
# before the float scale and the stream)
_KERNELS = {"fp32_tc": ("flash_attention_fp32tc",
                        "repro_flash_attention_fp32tc", 7, 9),
            "prefill": ("flash_attention_prefill",
                        "repro_flash_attention_prefill", 7, 9),
            "decode": ("flash_attention_decode",
                       "repro_flash_attention_decode", 7, 10)}
_fns: dict[str, object] = {}


@dataclass(frozen=True)
class Plan:
    """How one call runs.  ``block_q``: query positions per block (fp32_tc
    and prefill: the block's rows at this D over G) or the call's T
    (decode).
    ``blocks``: thread blocks of the main kernel.  Decode only: the keys go
    in ``splits`` splits of ``tiles_per_split`` tiles of ``KEY_TILE``, the
    G x T rows of a KV group in ``row_chunks`` chunks of at most the
    decode rows at this D, and ``scratch`` is the fp32 (splits, B*T*H,
    D + 2) tensor of each (row, split)'s acc, m and l."""
    path: str
    block_q: int
    blocks: int
    splits: int = 1
    tiles_per_split: int = 0
    row_chunks: int = 1
    scratch: tuple = ()


def plan(b: int, t: int, s: int, h: int, kvh: int, d: int, dtype,
         sms: int = H100_SMS, lse: bool = False) -> Plan:
    """The kernel, tiles and splits for q (b,t,h,d), k/v (b,s,kvh,d) of
    ``dtype`` on a card with ``sms`` SMs; ``lse``: the call also wants the
    log-sum-exp, which the decode kernel does not write."""
    g = h // kvh
    d256 = d == 256
    f32 = dtype == torch.float32
    if f32 or t > DECODE_MAX_T or lse:
        path = "fp32_tc" if f32 else "prefill"
        rows = ((D256_FP32_TC_ROWS if d256 else FP32_TC_ROWS) if f32 else
                D256_PREFILL_ROWS if d256 else PREFILL_ROWS)
        if g > rows:
            raise ValueError(f"H/KV = {g} query heads per KV head; the "
                             f"{path} kernel holds at most {rows} at head "
                             f"dim {d}")
        positions = rows // g
        return Plan(path, positions, b * kvh * -(-t // positions))
    chunks = -(-g * t // (D256_DECODE_ROWS if d256 else DECODE_ROWS))
    tiles = -(-s // KEY_TILE)
    # Enough splits that about 4 blocks per SM are in flight, none empty.
    per_split = max(1, tiles * b * kvh * chunks // (4 * sms))
    splits = -(-tiles // per_split)
    return Plan("decode", t, b * kvh * splits * chunks, splits, per_split,
                chunks, (splits, b * t * h, d + 2))


_plan = functools.lru_cache(maxsize=1024)(plan)   # a call's plan, kept


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel(path: str):
    fn = _fns.get(path)
    if fn is None:
        source, entry, n_ptr, n_int = _KERNELS[path]
        fn = getattr(_build.load(source), entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[path] = fn
    return fn


def _library():
    """Builds and loads every kernel."""
    for path in _KERNELS:
        _kernel(path)


def _positions(pos, n, device, name):
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    if pos.dtype != torch.int32 or pos.shape != (n,) or pos.device != device \
            or not pos.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 vector of length "
                         f"{n} on {device}; got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    return pos


def visible(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    """The (T, S) mask of the (query, key) pairs a call sees."""
    ok = (kv_pos[None, :] >= 0).expand(len(q_pos), -1)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    return ok


def _aligned_counts(qp: np.ndarray, s: int, causal: bool,
                    window: int) -> tuple[int, int]:
    """(keys some query sees, visible pairs) for query positions ``qp``
    against keys at 0 .. s-1, without the (T, S) mask."""
    hi = np.minimum(qp, s - 1) if causal else np.full_like(qp, s - 1)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros_like(qp)
    seen = hi >= lo
    cover = np.zeros(s + 1, dtype=np.int64)
    np.add.at(cover, lo[seen], 1)
    np.add.at(cover, hi[seen] + 1, -1)
    return (int((np.cumsum(cover[:s]) > 0).sum()),
            int((hi - lo + 1)[seen].sum()))


def work(q, k, q_pos=None, kv_pos=None, *, causal: bool = True,
         window: int = 0) -> tuple[int, int]:
    """(bytes, operations) of one call: each input byte the data needs
    read once (the K/V rows some query sees), the output written once, and
    the two multiply-adds (four operations) of each visible (query, key)
    pair for each query head and head dim.  Positions with data are read;
    ``None`` is the kernel's default, 0 .. T-1 and 0 .. S-1.  Positions
    without data (fake tensors of a traced step) are taken as the keys at
    0 .. S-1 and the queries at the last T of them, the most a call of
    these shapes can see."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    known = [p is not None and not is_fake(p) for p in (q_pos, kv_pos)]
    if all(known):
        ok = visible(q_pos, kv_pos, causal, window)
        rows, pairs = int(ok.any(dim=0).sum()), int(ok.sum())
    else:
        if any(known):
            raise ValueError("work() wants both positions with data, or "
                             "neither")
        start = 0 if q_pos is None else s - t
        rows, pairs = _aligned_counts(np.arange(start, start + t), s,
                                      causal, window)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * rows * kvh * d * k.element_size() + 4 * (t + s))
    return nbytes, 4 * b * h * d * pairs


def flash_attention(q, k, v, *, q_pos=None, kv_pos=None, causal: bool = True,
                    window: int = 0, return_lse: bool = False):
    """q: (B, T, H, D); k/v: (B, S, KV, D) on the card -> (B, T, H, D),
    and with ``return_lse`` the log-sum-exp, fp32 (B, H, T), beside it."""
    global launches
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention's kernels return tensors autograd cannot see; "
            "under grad call repro_torch.models.flash.flash_attention (the "
            "autograd Function), or run under torch.no_grad()")
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
    fake = is_fake(q)
    if not fake and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if not isinstance(window, int):
        raise TypeError(f"window must be a Python int, got {type(window)}")
    p = _plan(b, t, s, h, kvh, d, q.dtype,
              H100_SMS if fake else _sms(q.device.index), return_lse)
    qp = _positions(q_pos, t, q.device, "q_pos")
    kp = _positions(kv_pos, s, q.device, "kv_pos")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if fake:
        # a traced call (fake tensors have no data): its outputs' shapes
        # and its work, nothing loaded or launched
        if traced_calls is not None:
            nbytes, ops = work(q, k, q_pos, kv_pos, causal=causal,
                               window=window)
            traced_calls.append((p.path, ops, nbytes))
        return (out, lse) if return_lse else out
    fn = _kernel(p.path)
    # the raw handle of the current stream, without building a Stream object
    # (a few microseconds a call, as much as a decode launch takes)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), out.data_ptr())
    scale = 1.0 / math.sqrt(d)
    if p.path == "decode":
        part = q.new_empty(p.scratch, dtype=torch.float32)
        err = fn(*head, part.data_ptr(), b, t, s, h, kvh, d, p.splits,
                 p.tiles_per_split, int(causal), window, scale, stream)
    else:
        err = fn(*head, None if lse is None else lse.data_ptr(), b, t, s, h,
                 kvh, d, p.block_q, int(causal), window, scale, stream)
    if err:
        raise RuntimeError(f"flash_attention {p.path} kernel launch failed: "
                           f"error {err}")
    launches += 1
    launches_by_path[p.path] += 1
    return (out, lse) if return_lse else out
