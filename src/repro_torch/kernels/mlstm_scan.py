"""Chunkwise mLSTM forward on the card: the wrapper of three CUDA kernels.

Port of the TPU kernel ``repro.kernels.mlstm_scan`` (Pallas).  Same
contract as :func:`repro_torch.kernels.ref.reference_mlstm_scan`, its plain
version: the stabilized mLSTM recurrence over q/k/v (B,T,H,D) and the gate
pre-activations log_i/log_f (B,T,H), T a multiple of ``chunk``, q scaled by
1/sqrt(D), fp32 arithmetic, h in q's dtype.  Unlike the Pallas kernel it
also takes an initial state and returns the final one, (C (B,H,D,D),
n (B,H,D), m (B,H)) in fp32, which decode continues from.

Which kernel runs is a fixed rule on dtype and chunk, made by :func:`plan`
(pure Python, no device):

- bfloat16 with ``chunk`` a multiple of 16 (path ``"tc"``):
  ``csrc/mlstm_scan_tc.cu``, two launches on the tensor cores (wgmma) fed
  by TMA: a state pass that carries C across the chunks and writes the
  state entering each chunk to scratch allocated here (C as two bf16 terms
  hi + lo; n, m and the chunk's cumulative log_f in fp32), then an output
  pass over every (chunk, 128 rows, 128 columns of h) at once.
- float32 with ``chunk`` a multiple of 16 (path ``"tc_f32"``):
  ``csrc/mlstm_scan_fp32tc.cu``, the same two passes on the bf16 tensor
  cores in split precision: each fp32 operand enters its product as three
  bf16 terms and each product is six term products (one rounding to bf16
  or TF32 would miss the fp32 tolerance h is held to, rtol 5e-4, atol
  5e-5).  The scratch holds C as three bf16 terms.  Where the plain fp32
  version is itself outside that tolerance of the float64 answer (on a few
  elements at D = 512), the kernel is held to float64 row by row instead
  (:func:`check_fp32`, ROADMAP C21).
- any other call, of either dtype (a chunk that is not a multiple of 16):
  ``csrc/mlstm_scan.cu`` (path ``"fma"``), on the fp32 FMA pipe.

The kernels are forward-only: a call with grad mode on and an input that
requires grad raises, since their outputs are tensors autograd cannot see.
Training reaches them only through :class:`repro_torch.models.xlstm.
MLSTMScan`, whose forward runs with grad mode off and whose backward
differentiates the plain version.

On fake tensors (a step traced for its shapes, ``launch/dryrun.py``) the
wrapper runs the same checks and :func:`plan`, returns empty outputs of
the right shapes, and appends the call's path and :func:`work` to
:data:`traced_calls` where a list is set there; it loads and launches
nothing, and counts no launch.  A tensor with data never takes that
branch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import is_fake

from . import _build

#: Wrapper calls (one per scan) since the count was last set to 0.
launches = 0
#: The same calls by the kernel they launched (``"tc"``, ``"tc_f32"``: its
#: state and output passes); set each to 0 with ``launches``.
launches_by_path = {"fma": 0, "tc": 0, "tc_f32": 0}
#: Calls on fake tensors, as (path, operations, bytes) of :func:`work`,
#: appended while a list is set here; None records none.
traced_calls: list | None = None

MAX_HEAD_DIM = 512     # fma: C[:, 64 columns] of fp32 fills 128 KB of shared memory
MAX_CHUNK = 1024
STATE_TILE = 128       # rows and columns of C a tc state block owns
OUT_TILE = 128         # rows of a chunk and columns of h a tc output block owns
OUT_ROWS_F32 = 64      # rows of a chunk a tc_f32 output block owns
C_PARTS = 2            # bf16 terms of each chunk state in the tc scratch (kCParts)
C_PARTS_F32 = 3        # ... in the tc_f32 scratch (kTerms)

# path: (source under csrc/, C entry point, pointer and int arguments
# before the float scale)
_KERNELS = {"fma": ("mlstm_scan", "repro_mlstm_scan_fwd", 12, 5),
            "tc": ("mlstm_scan_tc", "repro_mlstm_scan_tc", 16, 5),
            "tc_f32": ("mlstm_scan_fp32tc", "repro_mlstm_scan_fp32tc", 16, 5)}
_fns: dict[str, object] = {}


@dataclass(frozen=True)
class Plan:
    """How one call runs.  ``blocks``: thread blocks of each launch, in
    order (tc, tc_f32: the state pass, then the output pass).
    ``boundary``: tc and tc_f32 only, the shape of the bf16 scratch that
    holds C entering each chunk that needs it (every chunk but the first,
    and the first too when an initial state is given) as C_PARTS (tc) or
    C_PARTS_F32 (tc_f32) terms, () when there is none."""
    path: str
    blocks: tuple
    boundary: tuple = ()


def plan(b: int, t: int, h: int, d: int, chunk: int, dtype,
         has_state: bool = False) -> Plan:
    """The kernel and grid for q/k/v (b,t,h,d) of ``dtype`` in chunks of
    ``chunk``, from an initial state or not."""
    if chunk % 16 == 0 and d % 16 == 0 and d <= MAX_HEAD_DIM:
        path, parts = (("tc", C_PARTS) if dtype == torch.bfloat16
                       else ("tc_f32", C_PARTS_F32))
        nc = t // chunk
        tiles = -(-d // STATE_TILE)
        rows = OUT_TILE if path == "tc" else OUT_ROWS_F32
        out = -(-chunk // rows) * nc * b * h * -(-d // OUT_TILE)
        states = nc - 1 + int(has_state)
        return Plan(path, (tiles * tiles * b * h, out),
                    (states, b * h, parts, d, d) if states else ())
    dv = 64 if d % 64 == 0 else 32 if d % 32 == 0 else 16
    return Plan("fma", (d // dv * b * h,))


_plan = functools.lru_cache(maxsize=1024)(plan)   # a call's plan, kept


def work(q, chunk: int, state=None) -> tuple[int, int]:
    """(bytes, operations) of one call: each input read once and h and
    the final state written once, and two operations a multiply-add of the
    chunkwise algorithm: per (batch, head) and chunk of L rows, q k^T and
    p v over the causal L(L+1)/2 pairs, and q C0, q n0 and the k^T w v,
    k^T w state update over D x D.  The first chunk's q C0 and q n0 are
    left out when there is no initial state: they are zeros."""
    b, t, h, d = q.shape
    nc = t // chunk
    pairs = chunk * (chunk + 1) // 2
    inter = (nc if state is not None else nc - 1) * chunk * (d * d + d)
    macs = b * h * (nc * (2 * pairs * d + chunk * (d * d + d)) + inter)
    nbytes = (4 * q.numel() * q.element_size()       # q, k, v read; h written
              + 2 * b * t * h * 4                     # log_i, log_f
              + 4 * b * h * (d * d + d + 1)           # final C, n, m
              + (4 * b * h * (d * d + d + 1) if state is not None else 0))
    return nbytes, 2 * macs


#: fp32 h and final state against the plain version, element by element
#: (tests/test_kernels.py holds the Pallas kernel so).
FP32_TOL = dict(rtol=5e-4, atol=5e-5)


def outside_tol(got, want, tol=FP32_TOL) -> int:
    """Elements of ``got`` outside ``tol`` (rtol, atol) of ``want``."""
    want = want.double()
    err = (got.double() - want).abs() - tol["rtol"] * want.abs()
    return int((err > tol["atol"]).sum())


def outside_row_tol(got, exact, tol=FP32_TOL, *, rows: bool = True) -> int:
    """Elements of ``got`` further from ``exact`` than atol + rtol times
    the largest |exact| of their row, the last dimension (each element its
    own row when ``rows`` is False): the size of the rounding error an fp32
    dot product over the row makes."""
    exact = exact.double()
    scale = exact.abs().amax(-1, keepdim=True) if rows else exact.abs()
    err = (got.double() - exact).abs()
    return int((err > tol["atol"] + tol["rtol"] * scale).sum())


def check_fp32(got, plain, exact, fma=None, tol=FP32_TOL) -> dict:
    """The check an fp32 scan's output is held to (ROADMAP C21).
    ``got``, ``plain``, ``exact`` and ``fma``: dicts of ``h`` and, where
    given, the final ``C``, ``n``, ``m``, from the kernel, the plain fp32
    version, the plain version in float64 and the FMA kernel on the same
    inputs.  Where the plain version is within ``tol`` of float64 on every
    element, the kernel is held to the plain version element by element.
    Where it is not (a few elements at D = 512, in rows some 1e3 times
    larger than they are), the kernel is held to float64
    instead: row by row (:func:`outside_row_tol`), which the plain version
    must meet too, and with no more elements outside ``tol`` of float64
    than the plain version or the FMA kernel has.  Returns the readings,
    ``held_to`` ("plain" or "float64") and ``ok``."""
    def count(a, b):
        return sum(outside_tol(a[k], b[k], tol) for k in got)

    def count_rows(a):  # m is one value a (batch, head): its own row
        return sum(outside_row_tol(a[k], exact[k], tol, rows=k != "m")
                   for k in got)
    out = dict(outside_tol_vs_float64=count(got, exact),
               plain_outside_tol_vs_float64=count(plain, exact),
               row_outside_vs_float64=count_rows(got),
               plain_row_outside_vs_float64=count_rows(plain))
    if fma is not None:
        out["fma_outside_tol_vs_float64"] = count(fma, exact)
    if out["plain_outside_tol_vs_float64"] == 0:
        out.update(held_to="plain", outside_tol_vs_plain=count(got, plain))
        out["ok"] = out["outside_tol_vs_plain"] == 0
    else:
        limit = max(out["plain_outside_tol_vs_float64"],
                    out.get("fma_outside_tol_vs_float64", 0))
        out.update(held_to="float64", outside_limit=limit)
        out["ok"] = (out["row_outside_vs_float64"] == 0
                     and out["plain_row_outside_vs_float64"] == 0
                     and out["outside_tol_vs_float64"] <= limit)
    return out


def _kernel(path: str):
    fn = _fns.get(path)
    if fn is None:
        source, entry, n_ptr, n_int = _KERNELS[path]
        fn = getattr(_build.load(source), entry)
        extra = [ctypes.c_int] if path == "fma" else []   # is_bf16
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] + extra + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[path] = fn
    return fn


def _library():
    """Builds and loads every kernel."""
    for path in _KERNELS:
        _kernel(path)


def _check_state(state, b, h, d, device, fake=False):
    """The initial state's pointers, once its shapes are checked (none
    on fake tensors)."""
    if state is None:
        return None, None, None
    shapes = ((b, h, d, d), (b, h, d), (b, h))
    if len(state) != 3 or any(
            s.shape != shape or s.dtype != torch.float32 or s.device != device
            or not s.is_contiguous() for s, shape in zip(state, shapes)):
        raise ValueError(f"state must be contiguous float32 (C, n, m) of "
                         f"shapes {shapes} on {device}")
    return (None,) * 3 if fake else tuple(s.data_ptr() for s in state)


def mlstm_scan(q, k, v, log_i, log_f, state=None, *, chunk: int = 256):
    """q/k/v: (B,T,H,D); log_i/log_f: (B,T,H) float32, on the card ->
    (h (B,T,H,D) in q's dtype, (C, n, m) float32)."""
    global launches
    tensors = (q, k, v, log_i, log_f)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            "mlstm_scan's kernels are forward-only and return tensors "
            "autograd cannot see; under grad call repro_torch.models.xlstm."
            "mlstm_scan_grad (the autograd Function), or run under "
            "torch.no_grad()")
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
    fake = is_fake(q)
    c_in, n_in, m_in = _check_state(state, b, h, d, q.device, fake)
    p = _plan(b, t, h, d, chunk, q.dtype, state is not None)
    out = torch.empty_like(q)
    c = torch.empty((b, h, d, d), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    if fake:
        # a traced call (fake tensors have no data): its outputs' shapes
        # and its work, nothing loaded or launched
        if traced_calls is not None:
            nbytes, ops = work(q, chunk, state)
            traced_calls.append((p.path, ops, nbytes))
        return out, (c, n, m)
    fn = _kernel(p.path)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), c_in, n_in, m_in, out.data_ptr(), c.data_ptr(),
            n.data_ptr(), m.data_ptr())
    scale = 1.0 / math.sqrt(d)
    if p.path != "fma":
        if any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError("q, k and v must start on a 16-byte boundary")
        nc = t // chunk
        # held until the launches are queued; the allocator reuses them only
        # for work queued after these on this stream
        bound = (q.new_empty(p.boundary, dtype=torch.bfloat16) if p.boundary
                 else None)
        n_prev = q.new_empty((nc, b * h, d), dtype=torch.float32)
        m_prev = q.new_empty((nc, b * h), dtype=torch.float32)
        bcum = q.new_empty((nc, b * h, chunk), dtype=torch.float32)
        err = fn(*head, None if bound is None else bound.data_ptr(),
                 n_prev.data_ptr(), m_prev.data_ptr(), bcum.data_ptr(), b, t,
                 h, d, chunk, scale, stream)
    else:
        err = fn(*head, b, t, h, d, chunk, scale,
                 int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"mlstm_scan {p.path} kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_by_path[p.path] += 1
    return out, (c, n, m)
