"""Model assembly: block bodies, the layer loop, LM / enc-dec / VLM wiring:
init, prefill, decode and the teacher-forced training forward.

Port of ``repro.models.transformer`` for every block kind: ``ATTN`` (with
a dense MLP or a MoE, :mod:`.moe`), ``ATTN_CROSS`` (a decoder block with
cross-attention over an encoder's output), ``HYMBA`` (attention and the
selective SSM of :mod:`.ssm` side by side), ``MLSTM`` and ``SLSTM``; the
whisper-style encoder over frame embeddings, and the prefixes a prompt
gets: patch embeddings, then learnable meta tokens in front of them.  The
reference scans stacked per-run parameters with ``lax.scan``;
here the layers are a Python loop over one parameter dict per layer, in
layer order, dispatching on each layer's kind.  Each attention layer's
window and RoPE theta come from :func:`build_runs` as plain Python numbers,
so the attention kernel gets ``window`` as a run-time int.

Parameter trees (layouts as in the reference)::

    {"embed": {"table": (Vp, d)},
     "layers": [{"ln1": {"scale"}, "attn": {"wq", "wk", "wv", "wo"},
                 "ln2": {"scale"}, "mlp": {"wi", "wg", "wo"}}   # ATTN
                 # (MoE configs: "moe": {"router", "wi", "wg", "wo"})
                | {"up", "conv_w", "wq", ..., "down"}           # MLSTM
                | {"w_gates", "r_gates", ..., "ffn_wo"}, ...],  # SLSTM
                # ATTN_CROSS: ATTN's and "lnx", "xattn" {"wq", ..., "wo"};
                # HYMBA: "ln1", "attn", "ssm" {"in_proj", ..., "A_log",
                # "D", "out_proj"}, "ln2", "mlp", "attn_out_scale",
                # "ssm_out_scale"
     "final_norm": {"scale"}, "lm_head": {"w": (d, Vp)},  # untied only
     "encoder": [ATTN block, ...], "enc_norm": {...},     # enc-dec only
     "meta_tokens": (M, d)}                               # meta tokens only

Caches are one dict per layer: ``{"k", "v"}`` of (B, seq_len, KV, dh)
tensors for attention, with ``{"ck", "cv"}`` of (B, encoder_seq_len, KV,
dh) for cross-attention and ``{"conv", "state"}`` for the hymba block's
SSM, ``{"conv", "C", "n", "m"}`` for mLSTM and ``{"h", "c", "n", "m"}``
for sLSTM.  Positions count the prefix: a prompt of T tokens behind P
prefix positions (:func:`prefix_len`) fills the caches to P + T, and the
first decode step writes position P + T.  Entry points take a ``device`` that
defaults to ``"cuda"`` and raise when CUDA is absent unless the caller asks
for ``"cpu"``.  ``rules`` (:class:`~.layers.AxisRules`, keyword-only, a
single device by default) reaches the expert-parallel MoE and the
tensor-parallel layers: on a mesh with a ``tp`` axis, every block's
attention (self- and cross-attention, where its query heads split over
``tp``) and MLP, the encoder's layers, the hymba block's selective SSM
(channel-parallel), the mLSTM block (head-parallel, where its heads split),
the embedding, the head and the loss compute on the ``tp`` slices of the
leaves they are given (:func:`tp_slice_dim` says which dim), with
all-reduces over ``tp``.  The ``SLSTM`` block computes whole leaves: its
recurrence mixes every head's h into each gate at every step.  Under
``tp`` each attention cache holds this rank's KV heads only, a cross cache
its heads' K/V, an SSM cache its channels and an mLSTM cache its heads'
``C``, ``n``, ``m`` (:func:`init_caches`); prefill and decode return the
whole logits.

:func:`forward_train` takes the parameters as stored (``param_dtype``,
fp32) and casts each layer's to ``cfg.dtype`` inside the layer,
differentiably, as the reference's ``_cast`` does; ``cfg.remat`` picks
what the backward recomputes, layer by layer, as the reference's
``jax.checkpoint`` does each run's body.  It trains every block kind
(the mLSTM scan through its autograd Function, :class:`.xlstm.MLSTMScan`;
the hymba block's SSM through :mod:`.ssm`'s chunked, checkpointed scan),
the encoder (its layers under ``cfg.remat`` too, the cross-attention's
K/V gradients reaching it) and the prefixes, whose positions the loss
skips.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .config import ATTN, ATTN_CROSS, HYMBA, MLSTM, SLSTM, ModelConfig
from . import layers as L
from .layers import AxisRules
from .moe import apply_moe, init_moe
from .ssm import apply_ssm, init_ssm, init_ssm_cache
from .xlstm import (apply_mlstm_block, apply_slstm_block, init_mlstm_block,
                    init_mlstm_cache, init_slstm_block, init_slstm_cache)

def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


# ---------------------------------------------------------------------------
# Run grouping.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RunSpec:
    kind: str
    count: int
    windows: tuple[int, ...]
    thetas: tuple[float, ...]


def build_runs(cfg: ModelConfig) -> tuple[RunSpec, ...]:
    """Group consecutive layers of one block kind into runs, with each
    layer's window and RoPE theta (``rope_theta_global`` for full-attention
    layers where the config sets one)."""
    runs = []
    pat, wins = cfg.block_pattern, cfg.windows
    i = 0
    while i < len(pat):
        j = i
        while j < len(pat) and pat[j] == pat[i]:
            j += 1
        windows = wins[i:j]
        thetas = tuple(
            (cfg.rope_theta_global if (w == 0 and cfg.rope_theta_global)
             else cfg.rope_theta) for w in windows)
        runs.append(RunSpec(pat[i], j - i, windows, thetas))
        i = j
    return tuple(runs)


def _layer_specs(cfg: ModelConfig) -> list[tuple[str, int, float]]:
    """(kind, window, theta) per layer."""
    return [(run.kind, w, th) for run in build_runs(cfg)
            for w, th in zip(run.windows, run.thetas)]


#: Leaves that keep their dtype in the compute copy, as the reference's
#: ``_cast`` keeps them (the selective SSM's).
_KEEP_DTYPE = ("A_log", "D", "dt_bias")
#: Top-level norms the reference applies uncast (each casts its scale to
#: float32 inside ``apply_norm``).
_UNCAST = ("final_norm", "enc_norm")


def cast_params(params, cfg: ModelConfig, device=None):
    """The parameters as :func:`prefill` and :func:`decode_step` take them:
    on ``device`` if given, with every float leaf that the reference casts
    at use (the layers', the embedding's and the untied head's) in the
    compute dtype ``cfg.dtype``, except the leaves whose dtype the reference
    keeps (``A_log``, ``D``, ``dt_bias``).  The final and the encoder's
    norms keep their dtype, as in the reference.  Made once where the parameters enter, the
    copies give the numbers of the reference's per-layer cast."""
    dtype = getattr(torch, cfg.dtype)

    def go(a, to):
        if isinstance(a, dict):
            return {k: go(x, None if k in _KEEP_DTYPE else to)
                    for k, x in a.items()}
        if isinstance(a, list):
            return [go(x, to) for x in a]
        return a.to(device=device, dtype=to if a.is_floating_point()
                    else a.dtype)
    return {k: go(v, None if k in _UNCAST else dtype)
            for k, v in params.items()}


def _cast(p: dict, dtype) -> dict:
    """One layer's float leaves in ``dtype``, differentiably, but for the
    leaves the reference's ``_cast`` keeps (``_KEEP_DTYPE``)."""
    return {k: _cast(a, dtype) if isinstance(a, dict)
            else a if k in _KEEP_DTYPE or not a.is_floating_point()
            else a.to(dtype) for k, a in p.items()}


def _check_cast(params, cfg: ModelConfig):
    got = params["embed"]["table"].dtype
    if got != getattr(torch, cfg.dtype):
        raise TypeError(f"parameters are {got}, not the compute dtype "
                        f"{cfg.dtype}; pass them through cast_params once")


#: The dim of each attention and MLP leaf that the tensor-parallel layers
#: read as this rank's ``tp`` slice: heads of q, k, v and their biases and
#: of ``wo``'s rows, the MLP's ``d_ff`` columns and ``wo``'s rows.
_TP_DIMS = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
            ("attn", "bq"): 0, ("attn", "bk"): 0, ("attn", "bv"): 0,
            ("attn", "wo"): 0, ("mlp", "wi"): 1, ("mlp", "wg"): 1,
            ("mlp", "bi"): 0, ("mlp", "wo"): 0}
#: Cross-attention's (no biases): heads of q, k, v, and ``wo``'s rows.
_XATTN_DIMS = {("xattn", "wq"): 1, ("xattn", "wk"): 1, ("xattn", "wv"): 1,
               ("xattn", "wo"): 0}
#: The selective SSM's channel leaves (``in_proj``, whose ``tp`` slices
#: would cut ``[xs | z]`` into one half a rank, is taken whole).
_SSM_DIMS = {("ssm", "conv_w"): 1, ("ssm", "x_proj"): 0,
             ("ssm", "dt_proj"): 1, ("ssm", "dt_bias"): 0,
             ("ssm", "A_log"): 0, ("ssm", "D"): 0, ("ssm", "out_proj"): 0}
#: The mLSTM block's head leaves: q, k, v columns, ``down``'s rows.
_MLSTM_DIMS = {"wq": 1, "wk": 1, "wv": 1, "down": 0}
#: Each block kind's sliced leaves below ``("layers", i)``.
_KIND_DIMS = {ATTN: _TP_DIMS, ATTN_CROSS: {**_TP_DIMS, **_XATTN_DIMS},
              HYMBA: {**_TP_DIMS, **_SSM_DIMS}}


def tp_slice_dim(path: tuple, cfg: ModelConfig,
                 rules: AxisRules = AxisRules()) -> int | None:
    """The dim on which the layers compute the leaf at ``path`` (dict keys
    and list indices, as ``optim.adamw.tree_map`` gives them) on its ``tp``
    slice, or None where they compute it whole: the embedding's rows, the
    head's columns, the attention and MLP leaves of every block kind but
    the sLSTM and of the encoder, cross-attention's, the SSM's channel
    leaves, and the mLSTM's head leaves where its heads split over
    ``rules``' ``tp`` (a slice that cuts a head is never computed on).  The
    sLSTM's leaves, the norms and the experts (expert-parallel,
    ``models/moe.py``) are None."""
    if path == ("embed", "table"):
        return 0
    if path == ("lm_head", "w"):
        return 1
    if len(path) == 4 and path[0] == "encoder":
        return _TP_DIMS.get(path[2:])
    if path[0] != "layers" or len(path) not in (3, 4):
        return None
    kind = _layer_specs(cfg)[path[1]][0]
    if kind == MLSTM and len(path) == 3:
        if cfg.num_heads % rules.tp_size:
            return None
        return _MLSTM_DIMS.get(path[2])
    return _KIND_DIMS.get(kind, {}).get(path[2:]) if len(path) == 4 else None


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def init_block(kind: str, gen: torch.Generator, cfg: ModelConfig,
               dtype) -> dict:
    dev = gen.device
    if kind == MLSTM:
        return init_mlstm_block(gen, cfg, dtype)
    if kind == SLSTM:
        return init_slstm_block(gen, cfg, dtype)
    if kind == HYMBA:
        return {
            "ln1": L.init_norm(cfg, dtype, dev),
            "attn": L.init_attention(gen, cfg, dtype),
            "ssm": init_ssm(gen, cfg, dtype),
            "ln2": L.init_norm(cfg, dtype, dev),
            "mlp": L.init_mlp(gen, cfg, dtype),
            "attn_out_scale": torch.zeros((cfg.d_model,), dtype=dtype,
                                          device=dev),
            "ssm_out_scale": torch.zeros((cfg.d_model,), dtype=dtype,
                                         device=dev),
        }
    if kind not in (ATTN, ATTN_CROSS):
        raise ValueError(f"unknown block kind {kind!r}")
    p = {
        "ln1": L.init_norm(cfg, dtype, dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "ln2": L.init_norm(cfg, dtype, dev),
    }
    if kind == ATTN_CROSS:
        p["lnx"] = L.init_norm(cfg, dtype, dev)
        p["xattn"] = L.init_attention(gen, cfg, dtype)
    if cfg.is_moe:
        p["moe"] = init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype)
    if cfg.qk_norm:
        p["q_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=gen.device)
        p["k_scale"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=gen.device)
    return p


def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random parameters in ``cfg.param_dtype``, with the reference's
    distributions, drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device="meta"`` draws nothing: shapes and dtypes alone
    (:func:`param_shapes`)."""
    device = resolve_device(device)
    specs = _layer_specs(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    gen = (L.ShapesOnly() if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    params: dict = {"embed": L.init_embed(gen, cfg, dtype),
                    "layers": [init_block(kind, gen, cfg, dtype)
                               for kind, _, _ in specs],
                    "final_norm": L.init_norm(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.dense_init(
            gen, (cfg.d_model, cfg.vocab_padded), dtype)}
    if cfg.is_encdec:
        params["encoder"] = [init_block(ATTN, gen, cfg, dtype)
                             for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = L.init_norm(cfg, dtype, device)
    if cfg.num_meta_tokens:
        params["meta_tokens"] = L.embed_init(
            gen, (cfg.num_meta_tokens, cfg.d_model), dtype)
    return params


def param_shapes(cfg: ModelConfig) -> dict:
    """:func:`init_params`' tree as tensors on the ``meta`` device: no data,
    so a 30 B-parameter config costs nothing (the reference's
    ``jax.eval_shape`` of ``init_params``)."""
    return init_params(0, cfg, device="meta")


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
                device="cuda", rules: AxisRules = AxisRules()):
    """One zeroed cache per layer: ``{"k", "v"}`` of (batch, seq_len, KV,
    dh) in ``dtype`` (default the compute dtype) for attention, with
    ``{"ck", "cv"}`` of (batch, encoder_seq_len, KV, dh) for
    cross-attention, and the float32 recurrent state of the SSM and xLSTM
    blocks, as the reference has them.  Under ``rules`` with a ``tp`` axis
    each attention layer's k and v hold this rank's KV heads only
    (:func:`~.layers.local_kv_heads`), and so do a cross layer's ck and cv;
    an SSM cache holds this rank's channels, an mLSTM cache its heads'
    ``C``, ``n`` and ``m`` (its ``conv`` whole).  Head-local, where the
    reference's ``cache_specs`` shards k and v on the sequence, ``C`` and
    ``n`` on ``dh`` and replicates ck and cv (ROADMAP C26, C27)."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)
    local = len(L.local_kv_heads(cfg, rules))

    def zeros(length, heads):
        return torch.zeros((batch, length, heads, cfg.head_dim),
                           dtype=dtype, device=device)
    caches = []
    for kind, _, _ in _layer_specs(cfg):
        if kind == MLSTM:
            caches.append(init_mlstm_cache(cfg, batch, device=device,
                                           rules=rules))
        elif kind == SLSTM:
            caches.append(init_slstm_cache(cfg, batch, device=device))
        else:
            c = {"k": zeros(seq_len, local), "v": zeros(seq_len, local)}
            if kind == ATTN_CROSS:
                c.update(ck=zeros(cfg.encoder_seq_len, local),
                         cv=zeros(cfg.encoder_seq_len, local))
            elif kind == HYMBA:
                c.update(init_ssm_cache(cfg, batch, device=device,
                                        rules=rules))
            caches.append(c)
    return caches


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def _self_attention(p, y, cfg, *, window: int, theta: float, q_pos, kv_pos,
                    cache=None, pos: int | None = None, causal: bool = True,
                    rules: AxisRules = AxisRules()):
    """qkv + qk-norm + rope + (cache update) + attend + out-proj.

    Prefill (``cache`` None): ``q_pos`` = ``kv_pos`` = (T,) positions, and
    the returned cache is this block's post-RoPE k and v.  Decode: writes
    k and v into ``cache`` in place at ``pos`` and attends over the whole
    cache.  With this rank's heads of ``p["attn"]`` (tensor-parallel), q,
    k, v and the cache hold those heads, and the kernel runs at them.
    """
    q, k, v = L.qkv_proj(p["attn"], y, cfg, rules)
    if cfg.qk_norm:
        # each rank's heads read the whole scales: their gradients summed
        sliced = q.shape[2] != cfg.num_heads
        q_scale, k_scale = ((L.enter_tp(p["q_scale"], rules),
                             L.enter_tp(p["k_scale"], rules)) if sliced
                            else (p["q_scale"], p["k_scale"]))
        q = L.rms_norm_head(q) * (1 + q_scale)
        k = L.rms_norm_head(k) * (1 + k_scale)
    cos, sin = L.rope_cos_sin(q_pos, cfg.head_dim, theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if cache is None:
        new_cache = {"k": k, "v": v}
        k_all, v_all = k, v
    else:
        t, seq_len = q.shape[1], cache["k"].shape[1]
        # The reference's dynamic_update_slice clamps a start index past the
        # cache; here that raises.  ServingEngine never gets here: it retires
        # every request by pos = max_seq - 1 and stops stepping once every
        # slot is empty.
        if not 0 <= pos <= seq_len - t:
            raise IndexError(f"decode position {pos} is past the "
                             f"{seq_len}-slot cache")
        cache["k"][:, pos:pos + t] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + t] = v.to(cache["v"].dtype)
        new_cache = cache
        k_all, v_all = cache["k"], cache["v"]
    o = L.attention(q, k_all, v_all, q_pos=q_pos, kv_pos=kv_pos,
                    window=window, causal=causal)
    return L.out_proj(p["attn"], o, cfg, rules), new_cache


def _cross_attention(p, x, cross_src, cache, cfg,
                     rules: AxisRules = AxisRules()):
    """Cross-attention against the cross K/V in ``cache`` where it holds
    them (``"ck"``: decode after prefill), else against the encoder's output
    ``cross_src`` (B, S, d), taken in x's dtype (prefill, training, and
    decode with a cross source).  As in the reference: no bias, no RoPE,
    every key visible (non-causal, the queries at position 0).  Where
    ``wq`` holds this rank's heads: q column-parallel, ck and cv of the KV
    heads they read (sliced, or cut from a replicated ``wk``/``wv``),
    ``cross_src`` through :func:`~.layers.enter_tp` (so the encoder gets
    every rank's heads' gradient), ``wo`` row-parallel.  Returns (out,
    {"ck", "cv"})."""
    y = L.apply_norm(p["lnx"], x)
    w = p["xattn"]
    sliced = L.tp_sliced(w["wq"].shape[1], cfg.num_heads, rules, "xattn wq")
    q = L._project_heads(L.enter_tp(y, rules) if sliced else y, w["wq"])
    if cache is not None and "ck" in cache:
        ck, cv = cache["ck"], cache["cv"]
    else:
        src = cross_src.to(x.dtype)
        wk, wv = w["wk"], w["wv"]
        if sliced:
            src = L.enter_tp(src, rules)
            heads = L.local_kv_heads(cfg, rules)
            wk, wv = (
                a if L.tp_sliced(a.shape[1], cfg.num_kv_heads, rules, n)
                else L._kv_slice(a, heads, rules)
                for n, a in (("xattn wk", wk), ("xattn wv", wv)))
        ck = L._project_heads(src, wk)
        cv = L._project_heads(src, wv)
    dev = x.device
    o = L.attention(q, ck, cv,
                    q_pos=torch.zeros((q.shape[1],), dtype=torch.int32,
                                      device=dev),
                    kv_pos=torch.arange(ck.shape[1], dtype=torch.int32,
                                        device=dev),
                    window=0, causal=False)
    return L.out_proj({"wo": w["wo"]}, o, cfg, rules), {"ck": ck, "cv": cv}


def apply_attn_block(p, x, cfg, *, window: int, theta: float, q_pos, kv_pos,
                     cache=None, pos: int | None = None,
                     rules: AxisRules = AxisRules(), losses: bool = True,
                     causal: bool = True, cross_src=None):
    """An ``ATTN`` block, or with ``p["xattn"]`` an ``ATTN_CROSS`` one
    (cross-attention over the cache's ``ck``/``cv`` where it holds them,
    else over ``cross_src``).  Returns (x, cache, metrics):
    ``{"moe_aux", "moe_z"}`` for a MoE block when ``losses``, else empty."""
    metrics = {}
    y = L.apply_norm(p["ln1"], x)
    attn_out, new_cache = _self_attention(
        p, y, cfg, window=window, theta=theta, q_pos=q_pos, kv_pos=kv_pos,
        cache=cache, pos=pos, causal=causal, rules=rules)
    x = x + attn_out
    if "xattn" in p:
        xo, xcache = _cross_attention(p, x, cross_src, cache, cfg, rules)
        x = x + xo
        new_cache = {**new_cache, **xcache}
    y = L.apply_norm(p["ln2"], x)
    if cfg.is_moe:
        m, metrics = apply_moe(p["moe"], y, cfg, rules, losses=losses)
    else:
        m = L.apply_mlp(p["mlp"], y, cfg, rules)
    return x + m, new_cache, metrics


def apply_hymba_block(p, x, cfg, *, window: int, theta: float, q_pos,
                      kv_pos, cache=None, pos: int | None = None,
                      rules: AxisRules = AxisRules()):
    """Attention and the selective SSM side by side over one norm, fused by
    their normalised mean [Hymba], then the MLP.  Under ``tp`` each part
    computes on the slices it is given and returns its output all-reduced,
    so the fusion reads replicated outputs.  Returns (x, cache): the
    attention's ``{"k", "v"}`` with the SSM's ``{"conv", "state"}``."""
    y = L.apply_norm(p["ln1"], x)
    attn_out, attn_cache = _self_attention(
        p, y, cfg, window=window, theta=theta, q_pos=q_pos, kv_pos=kv_pos,
        cache=cache, pos=pos, rules=rules)
    ssm_out, ssm_cache = apply_ssm(p["ssm"], y, cfg, cache=cache, rules=rules)
    fused = 0.5 * (L.rms_norm_head(attn_out) * (1 + p["attn_out_scale"])
                   + L.rms_norm_head(ssm_out) * (1 + p["ssm_out_scale"]))
    x = x + fused.to(x.dtype)
    y = L.apply_norm(p["ln2"], x)
    x = x + L.apply_mlp(p["mlp"], y, cfg, rules)
    return x, {"k": attn_cache["k"], "v": attn_cache["v"], **ssm_cache}


#: What ``cfg.remat = "dots"`` keeps for the backward: the outputs of the
#: matrix products without batch dimensions (the weight products), as the
#: reference's ``dots_with_no_batch_dims_saveable`` policy keeps them.
#: Everything else in a layer is recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _train_layer(p, x, cfg, *, kind: str, window: int, theta: float,
                 q_pos, rules, causal: bool = True, cross_src=None):
    """One layer of the training forward, of block ``kind``, under
    ``cfg.remat``: "full" recomputes the whole layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), "dots" keeps the weight
    products' outputs and recomputes the rest, "none" keeps everything.
    Recurrent layers (and the hymba block's SSM) start from a zero state
    and drop the final one.  ``cross_src``, the encoder's output, is an
    input of the checkpointed body, so a cross-attention layer's K/V
    gradients reach the encoder.  Returns (x, ``[moe_aux, moe_z]`` or
    zeros)."""
    def body(x, cross_src):
        lp = _cast(p, getattr(torch, cfg.dtype))
        metrics = {}
        if kind == MLSTM:
            x, _ = apply_mlstm_block(lp, x, cfg, rules=rules)
        elif kind == SLSTM:
            x, _ = apply_slstm_block(lp, x, cfg)
        elif kind == HYMBA:
            x, _ = apply_hymba_block(lp, x, cfg, window=window, theta=theta,
                                     q_pos=q_pos, kv_pos=q_pos, rules=rules)
        else:
            x, _, metrics = apply_attn_block(
                lp, x, cfg, window=window, theta=theta, q_pos=q_pos,
                kv_pos=q_pos, rules=rules, causal=causal,
                cross_src=cross_src)
        aux = (torch.stack([metrics["moe_aux"], metrics["moe_z"]])
               if metrics else torch.zeros((2,), dtype=torch.float32,
                                           device=x.device))
        return x, aux
    if cfg.remat == "none":
        return body(x, cross_src)
    if cfg.remat == "full":
        return _ckpt.checkpoint(body, x, cross_src, use_reentrant=False,
                                preserve_rng_state=False)
    if cfg.remat == "dots":
        return _ckpt.checkpoint(
            body, x, cross_src, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: _ckpt.create_selective_checkpoint_contexts(
                list(_SAVED_DOTS)))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def apply_stack(params, x, cfg, *, q_pos, kv_pos, caches=None, pos=None,
                rules: AxisRules = AxisRules(), losses: bool = True,
                train: bool = False, cross_src=None):
    """All layers in order; returns (x, caches, aux (2,)): ``aux`` sums
    every MoE layer's ``[moe_aux, moe_z]`` in float32, as the reference's
    stack does (zeros without MoE).  ``losses=False`` computes no MoE loss
    and returns ``aux`` None: prefill and decode drop it, and the
    reference's jit drops its work as dead code.  Prefill (``caches``
    None) passes no state into the recurrent blocks, as the reference
    does; decode passes each layer its cache.  ``cross_src``: the
    encoder's output, which prefill's cross-attention layers read.

    ``train``: the reference's mode "train": ``params`` as stored, cast
    inside each layer, each layer under ``cfg.remat``, aligned positions
    (``kv_pos`` is ``q_pos``), no caches (returned as None)."""
    if train:
        return _train_stack(params["layers"], x, cfg, q_pos=q_pos,
                            rules=rules, cross_src=cross_src)
    new_caches = []
    aux = (torch.zeros((2,), dtype=torch.float32, device=x.device)
           if losses else None)
    for i, (kind, window, theta) in enumerate(_layer_specs(cfg)):
        p = params["layers"][i]
        cache = None if caches is None else caches[i]
        if kind == MLSTM:
            x, c = apply_mlstm_block(p, x, cfg, cache=cache, rules=rules)
        elif kind == SLSTM:
            x, c = apply_slstm_block(p, x, cfg, cache=cache)
        elif kind == HYMBA:
            x, c = apply_hymba_block(p, x, cfg, window=window, theta=theta,
                                     q_pos=q_pos, kv_pos=kv_pos, cache=cache,
                                     pos=pos, rules=rules)
        else:
            x, c, metrics = apply_attn_block(
                p, x, cfg, window=window, theta=theta, q_pos=q_pos,
                kv_pos=kv_pos, cache=cache, pos=pos, rules=rules,
                losses=losses, cross_src=cross_src)
            if metrics:
                aux = aux + torch.stack([metrics["moe_aux"],
                                         metrics["moe_z"]])
        new_caches.append(c)
    return x, new_caches, aux


def _train_stack(layers, x, cfg, *, q_pos, rules, specs=None, causal=True,
                 cross_src=None):
    """``layers`` (stored parameters) through :func:`_train_layer`, of the
    kinds, windows and thetas of ``specs`` (default the decoder's)."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    for p, (kind, window, theta) in zip(layers, specs or _layer_specs(cfg)):
        x, layer_aux = _train_layer(p, x, cfg, kind=kind, window=window,
                                    theta=theta, q_pos=q_pos, rules=rules,
                                    causal=causal, cross_src=cross_src)
        aux = aux + layer_aux
    return x, None, aux


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def _check_batch(batch, known):
    extra = sorted(set(batch) - set(known))
    if extra:
        raise ValueError(f"unknown batch entries {extra}; known: {known}")


def _check_frames(batch, cfg):
    if cfg.is_encdec and "frames" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its batch needs "
                         f"'frames' (B, {cfg.encoder_seq_len}, {cfg.d_model})")


def prefix_len(cfg: ModelConfig, batch) -> int:
    """Positions :func:`prefill` puts in front of ``batch["tokens"]``: the
    patch embeddings (a VLM's, where the batch carries them), then the meta
    tokens in front of those.  A prompt of T tokens fills the caches to
    ``prefix_len + T``."""
    patches = (batch["patch_embeds"].shape[1]
               if cfg.num_patch_tokens and "patch_embeds" in batch else 0)
    return patches + cfg.num_meta_tokens


def _prepare_prefix(params, batch, cfg, rules: AxisRules = AxisRules()):
    """Embed the tokens and put the prefix streams in front: the patch
    embeddings, then the meta tokens (port of ``_prepare_prefix``)."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg, rules)
    if cfg.num_patch_tokens and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    if cfg.num_meta_tokens:
        mt = params["meta_tokens"].to(x.dtype)
        x = torch.cat([mt.expand(x.shape[0], -1, -1), x], dim=1)
    return x


def sinusoidal_positions(seq_len: int, d: int, device=None):
    """(seq_len, d) float32: sines then cosines, as the reference's."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(angle), np.cos(angle)], -1)
    return torch.from_numpy(table).to(device=device, dtype=torch.float32)


def encode_frames(params, frames, cfg: ModelConfig, *, train: bool = False,
                  rules: AxisRules = AxisRules()):
    """The whisper-style encoder over (stub) frame embeddings (B, S, d):
    sinusoidal positions added, the ``ATTN`` layers of ``params["encoder"]``
    non-causal at the config's RoPE theta (on their ``tp`` slices under
    ``rules``), then ``enc_norm``.  ``train``: ``params`` as stored, each
    layer through :func:`_train_layer` under ``cfg.remat`` (the reference's
    ``apply_stack(mode="train")``); the layers' MoE losses are dropped, as
    there."""
    dtype = getattr(torch, cfg.dtype)
    s = frames.shape[1]
    x = frames.to(dtype) + sinusoidal_positions(
        s, cfg.d_model, frames.device).to(dtype)
    pos = torch.arange(s, dtype=torch.int32, device=frames.device)
    if train:
        specs = [(ATTN, 0, cfg.rope_theta)] * len(params["encoder"])
        x, _, _ = _train_stack(params["encoder"], x, cfg, q_pos=pos,
                               rules=rules, specs=specs, causal=False)
        return L.apply_norm(params["enc_norm"], x)
    for p in params["encoder"]:
        x, _, _ = apply_attn_block(p, x, cfg, window=0, theta=cfg.rope_theta,
                                   q_pos=pos, kv_pos=pos, causal=False,
                                   losses=False, rules=rules)
    return L.apply_norm(params["enc_norm"], x)


def forward_train(params, batch, cfg: ModelConfig, *,
                  rules: AxisRules = AxisRules()):
    """Teacher-forced forward: returns (loss, metrics).

    ``params``: as stored (``init_params``, fp32), not cast.
    ``batch``: on the parameters' device, ``{"tokens", "labels"}``, (B, T)
    integer tensors, labels < 0 ignored; ``"frames"`` (B, S, d) for an
    encoder-decoder config; ``"patch_embeds"`` (B, P, d), optional, for a
    config with patch tokens.  The stack runs over the prefix positions
    (:func:`prefix_len`: patches, meta tokens in front) and the T tokens;
    the loss reads the T tokens' positions only.  ``loss`` is the mean
    cross entropy plus ``0.01 * aux + 0.001 * z`` of the MoE layers;
    ``metrics`` holds ``ce_loss``, ``aux_loss`` and ``tokens`` (the labels
    counted).  Port of ``repro.models.transformer.forward_train``.
    """
    _check_batch(batch, ("tokens", "labels", "frames", "patch_embeds"))
    _check_frames(batch, cfg)
    x = _prepare_prefix(params, batch, cfg, rules)
    prefix = prefix_len(cfg, batch)
    cross_src = (encode_frames(params, batch["frames"], cfg, train=True,
                               rules=rules) if cfg.is_encdec else None)
    t = x.shape[1]
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    x, _, aux = apply_stack(params, x, cfg, q_pos=pos, kv_pos=pos,
                            rules=rules, train=True, cross_src=cross_src)
    x = L.apply_norm(params["final_norm"], x)
    if prefix:
        x = x[:, prefix:]
    head = params.get("lm_head")
    logits = L.logits_from_hidden(x, params["embed"], head, cfg, rules)
    loss, n_tok = cross_entropy(
        logits, batch["labels"], rules,
        vocab_start=L.vocab_start(params["embed"], head, cfg, rules))
    aux_loss = 0.01 * aux[0] + 0.001 * aux[1]
    metrics = {"ce_loss": loss, "aux_loss": aux_loss, "tokens": n_tok}
    return loss + aux_loss, metrics


def cross_entropy(logits, labels, rules: AxisRules = AxisRules(),
                  vocab_start: int | None = None):
    """Masked mean cross entropy in fp32; labels < 0 are ignored.  Returns
    (loss, tokens counted).  The vocabulary's padding columns arrive at
    -1e30 (``logits_from_hidden``), so they add nothing to the log-sum-exp.
    ``vocab_start``: ``logits`` are this rank's ``tp`` slice of the
    vocabulary from that entry, and the loss, the same on every ``tp``
    rank, is the whole row's (:func:`~.layers.vocab_parallel_ce_parts`).
    Port of ``repro.models.transformer.cross_entropy``."""
    mask = labels >= 0
    logits = logits.float()
    if vocab_start is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.clamp_min(0).long()[..., None])[
            ..., 0]
    else:
        lse, picked = L.vocab_parallel_ce_parts(logits, labels, vocab_start,
                                                rules)
    ce = (lse - picked) * mask
    n = mask.sum().clamp_min(1)
    return ce.sum() / n, n


def prefill(params, batch, cfg: ModelConfig, seq_len: int, *,
            rules: AxisRules = AxisRules()):
    """Prefill caches of length ``seq_len``; returns (last_logits, caches).

    ``params``: as :func:`cast_params` returns them.
    ``batch``: on the parameters' device, ``"tokens"`` (B, T) integers;
    ``"frames"`` (B, encoder_seq_len, d) for an encoder-decoder config (the
    encoder's input); ``"patch_embeds"`` (B, P, d), optional, for a config
    with patch tokens.  The prompt is the P + M prefix positions
    (:func:`prefix_len`: patches, meta tokens in front) and the T tokens.
    Logits are (B, 1, Vp) at the last token; each attention cache holds
    positions 0..P+M+T-1 and zeros after them (a cross-attention cache also
    the encoder output's K/V); each recurrent cache holds the state there.
    """
    _check_batch(batch, ("tokens", "frames", "patch_embeds"))
    _check_cast(params, cfg)
    _check_frames(batch, cfg)
    x = _prepare_prefix(params, batch, cfg, rules)
    cross_src = (encode_frames(params, batch["frames"], cfg, rules=rules)
                 if cfg.is_encdec else None)
    t = x.shape[1]
    if t > seq_len:
        raise ValueError(f"{t} prompt positions do not fit a {seq_len}-slot "
                         f"cache")
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    x, states, _ = apply_stack(params, x, cfg, q_pos=pos, kv_pos=pos,
                               rules=rules, losses=False,
                               cross_src=cross_src)
    # k, v: (B, T, KV, dh) -> (B, seq_len, KV, dh), zeros after T
    caches = [{n: F.pad(a, (0, 0, 0, 0, 0, seq_len - t)) if n in ("k", "v")
               else a for n, a in c.items()} for c in states]
    x = L.apply_norm(params["final_norm"], x[:, -1:])
    logits = L.gather_vocab(L.logits_from_hidden(
        x, params["embed"], params.get("lm_head"), cfg, rules), cfg, rules)
    return logits, caches


def decode_step(params, tokens, caches, pos: int, cfg: ModelConfig,
                seq_len: int, *, rules: AxisRules = AxisRules(),
                cross_src=None):
    """One decode step.  tokens: (B, 1); pos: Python int cache fill level
    (after a prefill: its prefix and tokens, ``prefix_len + T``).

    ``params``: as :func:`cast_params` returns them.  Writes the new k and
    v into the attention caches in place, replaces each recurrent cache by
    the next state, and returns (logits (B, 1, Vp), caches).
    Cross-attention reads the K/V that prefill left in the cache; a cache
    without them (no ``"ck"``) reads ``cross_src`` (B, S, d), the
    encoder's output, and the returned cache holds its K/V, as the
    reference's does.
    """
    _check_cast(params, cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg, rules)
    kv_pos = torch.arange(seq_len, dtype=torch.int32, device=x.device)
    q_pos = torch.tensor([pos], dtype=torch.int32, device=x.device)
    x, caches, _ = apply_stack(params, x, cfg, q_pos=q_pos, kv_pos=kv_pos,
                               caches=caches, pos=pos, rules=rules,
                               losses=False, cross_src=cross_src)
    x = L.apply_norm(params["final_norm"], x)
    logits = L.gather_vocab(L.logits_from_hidden(
        x, params["embed"], params.get("lm_head"), cfg, rules), cfg, rules)
    return logits, caches
