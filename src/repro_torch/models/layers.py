"""Shared neural building blocks: norms, RoPE, GQA attention, MLPs.

Port of ``repro.models.layers``.  Plain functions on tensors and on
parameter dicts whose layouts are the JAX package's (``wq (d, h, dh)``,
``wo (h, dh, d)``, ``wi (d, f)``), so converting weights is a copy.
:class:`AxisRules` names the mesh axes as the reference's does, over a
``torch.distributed`` ``DeviceMesh``; only the expert-parallel MoE reads
it (the reference's sharding constraints have no counterpart on one card).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

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


def qkv_proj(p, x, cfg):
    q = _project_heads(x, p["wq"])
    k = _project_heads(x, p["wk"])
    v = _project_heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def out_proj(p, o):
    h, k, d = p["wo"].shape
    y = o.flatten(-2) @ p["wo"].reshape(h * k, d)
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


def apply_mlp(p: dict, x, cfg):
    """Gated kinds take ``wg`` as the gate (under silu / gelu) and ``wi``
    as the up projection."""
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


def embed_tokens(p, tokens, cfg):
    x = p["table"][tokens]
    if cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    return x.to(_dtype(cfg))


def logits_from_hidden(x, embed_params, head_params, cfg):
    if cfg.tie_embeddings:
        logits = x @ embed_params["table"].to(_dtype(cfg)).T
    else:
        logits = x @ head_params["w"].to(_dtype(cfg))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.vocab_padded != cfg.vocab_size:  # mask padding rows to -inf
        logits[..., cfg.vocab_size:] = -1e30
    return logits
