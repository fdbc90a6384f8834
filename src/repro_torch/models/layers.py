"""Shared neural building blocks: norms, RoPE, GQA attention, MLPs.

Port of ``repro.models.layers``.  Plain functions on tensors and on
parameter dicts whose layouts are the JAX package's (``wq (d, h, dh)``,
``wo (h, dh, d)``, ``wi (d, f)``), so converting weights is a copy.
:class:`AxisRules` names the mesh axes as the reference's does, over a
``torch.distributed`` ``DeviceMesh``.

Tensor parallelism (the reference's ``rules.constrain(..., "tp")``, which
GSPMD turns into split products and all-reduces): a layer handed the
``tp`` slice of a leaf, as ``runtime.sharding.param_specs`` places it,
computes on that slice, and one given the whole leaf computes it whole;
each layer reads which from the leaf's shape against the config.  qkv and
the MLP's up projections are column-parallel (each rank its heads or
``d_ff`` columns), ``wo`` and the MLP's down projection row-parallel (a
partial product, then one all-reduce over ``tp``), the embedding and the
head vocab-parallel.  :func:`enter_tp` and :func:`reduce_tp` carry the
collectives and their transposes, :func:`sum_tp` a sum that each rank then
uses in work of its own (all-reduced both ways), :func:`tp_cut` this
rank's part of a whole leaf; with ``rules.tp_size == 1`` each is the
identity and posts nothing.  The SSM and the xLSTM blocks
(``models/ssm.py``, ``models/xlstm.py``) build on these.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.collectives import library_all_reduce
from repro_torch.kernels import ops as kops
from . import flash


# ---------------------------------------------------------------------------
# Mesh axes.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AxisRules:
    """Logical-to-mesh axis mapping.

    ``dp``   — batch-parallel axes (("pod","data") on the multi-pod mesh).
    ``tp``   — tensor/expert-parallel axis ("model").
    ``mesh`` — the ``torch.distributed`` ``DeviceMesh`` the axes name
               (needed by the LACIN expert-parallel MoE dispatch), or any
               object with ``mesh_dim_names`` and ``size(i)``: specs need
               no process group.
    ``global_router_stats`` — the MoE's aux and z losses from router
               statistics summed over the ``dp`` axes, the single-device
               numbers (the sharded train step's); else each shard's own,
               averaged over ``dp`` (the reference's ``shard_map``).
    Default-constructed rules mean a single device.
    """
    dp: tuple[str, ...] = ()
    tp: str | None = None
    mesh: object = None
    global_router_stats: bool = False

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(axis)))

    @property
    def tp_size(self) -> int:
        if self.tp is None or self.mesh is None:
            return 1
        return self.axis_size(self.tp)

    @property
    def dp_size(self) -> int:
        if not self.dp or self.mesh is None:
            return 1
        return math.prod(self.axis_size(a) for a in self.dp)

    @property
    def tp_rank(self) -> int:
        """This process's coordinate on the ``tp`` axis (0 without one)."""
        if self.tp_size == 1:
            return 0
        return int(self.mesh.get_local_rank(self.tp))

    @property
    def tp_group(self):
        return self.mesh.get_group(self.tp)


# ---------------------------------------------------------------------------
# Tensor-parallel collectives (the reference's constraints to "tp").
# ---------------------------------------------------------------------------

class _EnterTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the ``tp`` group backward:
    the input of a column-parallel product, whose ranks each add a part of
    its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return library_all_reduce(grad, ctx.group), None


class _ReduceTP(torch.autograd.Function):
    """Sum over the ``tp`` group forward; identity backward: the partial
    products of a row-parallel product, whose sum every rank then uses."""

    @staticmethod
    def forward(ctx, x, group):
        return library_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter_tp(x, rules: AxisRules):
    """``x`` as the input of a tensor-parallel region: the same tensor,
    whose gradient is all-reduced over ``tp``.  Also every replicated
    leaf that only part of each rank's work reads (a qk-norm scale, a
    replicated ``wk``), so each rank's gradient of it is the whole one."""
    if rules.tp_size == 1:
        return x
    return _EnterTP.apply(x, rules.tp_group)


def reduce_tp(x, rules: AxisRules):
    """The sum of every ``tp`` rank's ``x`` (one all-reduce); the gradient
    passes through unchanged."""
    if rules.tp_size == 1:
        return x
    return _ReduceTP.apply(x, rules.tp_group)


def sum_tp(x, rules: AxisRules):
    """The sum of every ``tp`` rank's ``x``, all-reduced both ways
    (``enter_tp(reduce_tp(x))``): for a sum of partial products that each
    rank then uses in work of its own, as the selective SSM's ``x_proj``
    product feeds each rank's channels and the mLSTM's sum of squares
    over ``inner`` normalises each rank's heads.  There each rank's
    gradient of the sum is only its own work's part, and every partial
    needs all of them; :func:`reduce_tp` alone (an identity backward,
    right where every rank's use of the sum is the same replicated work)
    gives each partial its own rank's part only."""
    return enter_tp(reduce_tp(x, rules), rules)


def tp_cut(w, dim: int, start: int, length: int, rules: AxisRules):
    """``length`` entries of a whole (replicated or gathered) leaf from
    ``start`` on ``dim``, the part this rank's work reads; its gradient
    summed over ``tp`` (:func:`enter_tp`), so each rank's gradient of the
    leaf is the whole one."""
    return enter_tp(w, rules).narrow(dim, start, length)


def tp_sliced(local: int, whole: int, rules: AxisRules, what: str) -> bool:
    """Whether a leaf dim of ``local`` entries is this rank's ``tp`` slice
    of ``whole`` (False where it is the whole dim); raises on anything
    else."""
    if local == whole:
        return False
    if rules.tp_size > 1 and local * rules.tp_size == whole:
        return True
    raise ValueError(f"{what} has {local} of {whole} entries: neither whole "
                     f"nor a slice over {rules.tp_size} tp ranks")


# ---------------------------------------------------------------------------
# Initializers (same distributions as the reference, from a torch.Generator).
# ---------------------------------------------------------------------------

class ShapesOnly:
    """Stands in for the generator where nothing is drawn: the ``init_*``
    functions then give tensors on the ``meta`` device, shapes and dtypes
    without data (the reference's ``jax.eval_shape``)."""
    device = torch.device("meta")


def _randn(gen, shape):
    return torch.randn(shape, device=gen.device, generator=(
        gen if isinstance(gen, torch.Generator) else None))


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (_randn(gen, shape) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    return (_randn(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def init_norm(cfg, dtype, device) -> dict:
    p = {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x, eps: float = 1e-6):
    """RMSNorm (scale stored as offset-from-1) or LayerNorm, in fp32."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"].float()) + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * (1.0 + p["scale"].float())
    return y.to(x.dtype)


def rms_norm_head(x, eps: float = 1e-6):
    """Parameter-light qk-norm over the head dim."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate-half layout; theta, angles and cos/sin in float32).
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., T) int -> cos, sin of shape (..., T, head_dim/2)."""
    half = head_dim // 2
    freq_exponents = torch.arange(half, dtype=torch.float32,
                                  device=positions.device) / half
    inv_freq = torch.tensor(theta, dtype=torch.float32,
                            device=positions.device) ** -freq_exponents
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, T, H, D). cos/sin: (B, T, D/2) or (T, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; full or sliding window via the per-layer ``window`` int).
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, dh), dtype),
        "wk": dense_init(gen, (d, kv, dh), dtype),
        "wv": dense_init(gen, (d, kv, dh), dtype),
        "wo": dense_init(gen, (h, dh, d), dtype, fan_in=h * dh),
    }
    if cfg.attn_bias:
        for name, shape in (("bq", (h, dh)), ("bk", (kv, dh)),
                            ("bv", (kv, dh)), ("bo", (d,))):
            p[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
    return p


def _project_heads(x, w):
    """x (B, T, d) @ w (d, h, k) -> (B, T, h, k)."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def local_kv_heads(cfg, rules: AxisRules = AxisRules()):
    """The KV heads that this rank's query heads read, in the order its
    K/V (and its cache) hold them: every head without tensor parallelism
    or where the query heads do not split over ``tp`` (the layer then
    computes whole); this rank's slice where the KV heads split too;
    else (a replicated ``wk``/``wv``) the heads its query heads' groups
    read, a range where each is read by equally many of them (the kernel
    sees plain GQA with its own group size), or one KV head a query head."""
    h, kv, tp = cfg.num_heads, cfg.num_kv_heads, rules.tp_size
    if tp == 1 or h % tp:
        return range(kv)
    r, h_loc = rules.tp_rank, h // tp
    if kv % tp == 0:
        return range(r * (kv // tp), (r + 1) * (kv // tp))
    read = [(r * h_loc + j) // (h // kv) for j in range(h_loc)]
    lo, hi = read[0], read[-1] + 1
    if h_loc % (hi - lo) == 0 and all(
            read.count(i) == h_loc // (hi - lo) for i in range(lo, hi)):
        return range(lo, hi)
    return read


def _kv_slice(w, heads, rules: AxisRules):
    """A replicated K/V leaf cut to ``heads`` on its dim -2; its gradient
    summed over ``tp`` (:func:`enter_tp`)."""
    if isinstance(heads, range):
        return tp_cut(w, -2, heads.start, len(heads), rules)
    return enter_tp(w, rules).index_select(
        -2, torch.tensor(heads, device=w.device))


def qkv_proj(p, x, cfg, rules: AxisRules = AxisRules()):
    """q, k, v: (B, T, heads, dh).  Column-parallel where ``wq`` holds this
    rank's heads: q of those heads, and k and v of the KV heads they read
    (:func:`local_kv_heads`), from ``wk``/``wv`` slices or cut from
    replicated ones; the biases follow their heads."""
    if not tp_sliced(p["wq"].shape[1], cfg.num_heads, rules, "wq"):
        q = _project_heads(x, p["wq"])
        k = _project_heads(x, p["wk"])
        v = _project_heads(x, p["wv"])
        if "bq" in p:
            q = q + p["bq"]
            k = k + p["bk"]
            v = v + p["bv"]
        return q, k, v
    x = enter_tp(x, rules)
    heads = local_kv_heads(cfg, rules)
    # wk/wv (d, kv, dh) and bk/bv (kv, dh): the KV heads on dim -2
    kv = {name: w if tp_sliced(w.shape[-2], cfg.num_kv_heads, rules, name)
          else _kv_slice(w, heads, rules)
          for name, w in p.items() if name in ("wk", "wv", "bk", "bv")}
    q = _project_heads(x, p["wq"])
    k = _project_heads(x, kv["wk"])
    v = _project_heads(x, kv["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    return q, k, v


def out_proj(p, o, cfg=None, rules: AxisRules = AxisRules()):
    """(B, T, heads, dh) -> (B, T, d).  Row-parallel where ``wo`` holds this
    rank's heads: the partial product all-reduced over ``tp``, then ``bo``
    added once.  Without ``cfg``, ``wo`` is taken whole."""
    h, k, d = p["wo"].shape
    y = o.flatten(-2) @ p["wo"].reshape(h * k, d)
    if cfg is not None and tp_sliced(h, cfg.num_heads, rules, "wo"):
        y = reduce_tp(y, rules)
    if "bo" in p:
        y = y + p["bo"]
    return y


def attention(q, k, v, *, q_pos, kv_pos, window: int = 0, causal=True):
    """GQA attention, prefill, decode and training alike.  q: (B,T,H,D),
    k/v: (B,S,KV,D).

    On the card this is always the flash-attention kernel, whatever
    ``cfg.attention_impl`` says; on the CPU it is the kernel's plain
    version (:mod:`repro_torch.kernels.ops`).  With grad mode on and an
    input that requires grad it goes through the autograd Function
    :func:`repro_torch.models.flash.flash_attention` (the same forward,
    with its log-sum-exp saved for the blocked backward).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                     window=window, causal=causal)
    return kops.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                window=window, causal=causal)


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, dtype, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    p = {"wi": dense_init(gen, (d, f), dtype),
         "wo": dense_init(gen, (f, d), dtype, fan_in=f)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (d, f), dtype)
    if cfg.mlp_bias:
        p["bi"] = torch.zeros((f,), dtype=dtype, device=gen.device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype):
    """sqrt(2/pi), 0.044715 and 0.5 rounded to ``dtype``, as Python floats:
    a scalar operand costs no device copy, and one that ``dtype`` holds
    exactly multiplies as the same constant in that dtype would."""
    return tuple(torch.tensor(c, dtype=dtype).item()
                 for c in (math.sqrt(2 / math.pi), 0.044715, 0.5))


def silu_op_by_op(x):
    """x * sigmoid(x) op by op in x's dtype, as ``jax.nn.silu`` computes it:
    in bfloat16 this rounds as the reference does, where ``F.silu``'s single
    rounding differs from it by an ulp in about 4 elements of 10."""
    return x * (1 / (1 + torch.exp(-x)))


def silu(x):
    """x * sigmoid(x): on the CPU :func:`silu_op_by_op`, which rounds as
    the reference does; on the card ``F.silu``, one kernel where op by op
    launches five, which made llama3.2-3b's decode step and train step
    about 8% and 6% slower on an H100 (PERF.md, ``chip_smoke.py
    --silu-ab``)."""
    return F.silu(x) if x.is_cuda else silu_op_by_op(x)


def gelu_tanh(x):
    """The tanh approximation of gelu op by op in x's dtype, with its
    constants in that dtype, as ``jax.nn.gelu(approximate=True)`` computes
    it: in bfloat16 this rounds as the reference does, where ``F.gelu``'s
    single rounding differs from it by an ulp in about 4 elements of 10."""
    c, cube, half = _gelu_constants(x.dtype)
    inner = c * (x + cube * (x * x * x))
    return x * (half * (1.0 + torch.tanh(inner)))


def apply_mlp(p: dict, x, cfg, rules: AxisRules = AxisRules()):
    """Gated kinds take ``wg`` as the gate (under silu / gelu) and ``wi``
    as the up projection.  Where ``wi`` holds this rank's ``d_ff`` columns:
    ``wi``/``wg`` (and ``bi``) column-parallel, ``wo`` row-parallel with
    one all-reduce over ``tp``, ``bo`` added after it."""
    sliced = tp_sliced(p["wi"].shape[1], cfg.d_ff, rules, "wi")
    if sliced:
        x = enter_tp(x, rules)
    h = x @ p["wi"]
    if "bi" in p:
        h = h + p["bi"]
    if cfg.mlp == "swiglu":
        h = silu(x @ p["wg"]) * h
    elif cfg.mlp == "geglu":
        h = gelu_tanh(x @ p["wg"]) * h
    elif cfg.mlp == "squared_relu":
        r = F.relu(h)
        h = r * r
    elif cfg.mlp == "gelu":
        h = gelu_tanh(h)
    else:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    y = h @ p["wo"]
    if sliced:
        y = reduce_tp(y, rules)
    if "bo" in p:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg, dtype) -> dict:
    """Embedding store padded to ``cfg.vocab_padded`` rows; pad logits are
    masked at the unembed."""
    return {"table": embed_init(gen, (cfg.vocab_padded, cfg.d_model), dtype)}


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def vocab_start(embed_params, head_params, cfg,
                rules: AxisRules = AxisRules()):
    """The first vocabulary entry of this rank's slice where the head (the
    tied ``table`` or ``lm_head``'s ``w``) holds a ``tp`` slice of the
    padded vocabulary, else None (whole)."""
    if cfg.tie_embeddings:
        local = embed_params["table"].shape[0]
    else:
        local = head_params["w"].shape[1]
    if not tp_sliced(local, cfg.vocab_padded, rules, "the head"):
        return None
    return rules.tp_rank * local


def embed_tokens(p, tokens, cfg, rules: AxisRules = AxisRules()):
    """Vocab-parallel where ``table`` holds this rank's rows: each rank
    looks up the tokens in its slice, zeros elsewhere, and the sum over
    ``tp`` (exact: one term each) is the lookup; gemma's sqrt(d) after."""
    table = p["table"]
    if tp_sliced(table.shape[0], cfg.vocab_padded, rules, "table"):
        local = tokens.long() - rules.tp_rank * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        x = reduce_tp(torch.where(
            inside[..., None], table[local.clamp(0, table.shape[0] - 1)],
            0), rules)
    else:
        x = table[tokens]
    if cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    return x.to(_dtype(cfg))


def logits_from_hidden(x, embed_params, head_params, cfg,
                       rules: AxisRules = AxisRules()):
    """Logits over the padded vocabulary, the padding columns at -1e30; where
    the head holds a ``tp`` slice (:func:`vocab_start`), this rank's columns
    of them, softcapped and masked by their global index (the input's
    gradient summed over ``tp``).  :func:`gather_vocab` gives the whole."""
    start = vocab_start(embed_params, head_params, cfg, rules)
    if start is not None:
        x = enter_tp(x, rules)
    if cfg.tie_embeddings:
        logits = x @ embed_params["table"].to(_dtype(cfg)).T
    else:
        logits = x @ head_params["w"].to(_dtype(cfg))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    pad = cfg.vocab_size - (start or 0)
    if pad < logits.shape[-1]:  # mask padding rows to -inf
        logits[..., max(pad, 0):] = -1e30
    return logits


def gather_vocab(logits, cfg, rules: AxisRules = AxisRules()):
    """The whole (..., Vp) logits from every ``tp`` rank's slice: each writes
    its columns into zeros and the sum over ``tp`` (one all-reduce, exact)
    assembles them.  Whole logits are returned as they are."""
    local = logits.shape[-1]
    if not tp_sliced(local, cfg.vocab_padded, rules, "the logits"):
        return logits
    whole = logits.new_zeros(logits.shape[:-1] + (cfg.vocab_padded,))
    whole[..., rules.tp_rank * local:(rules.tp_rank + 1) * local] = logits
    return reduce_tp(whole, rules)


def vocab_parallel_ce_parts(logits, labels, start: int,
                            rules: AxisRules):
    """(lse, picked logit) of fp32 ``logits``, this rank's vocabulary slice
    from ``start``, as one device computes them on the whole row: the max
    over ``tp`` (all-reduce max; the lse does not depend on it), then the
    sum of exponentials and the picked logit (one all-reduce of both)."""
    local = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=rules.tp_group)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    idx = labels.long() - start
    inside = (idx >= 0) & (idx < local)
    picked = logits.gather(-1, idx.clamp(0, local - 1)[..., None])[..., 0]
    sumexp, picked = reduce_tp(torch.stack(
        [sumexp, torch.where(inside, picked, 0.0)]), rules).unbind(0)
    return torch.log(sumexp) + m, picked
