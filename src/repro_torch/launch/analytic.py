"""Analytic executed-FLOPs and HBM-traffic model for every (arch x shape).

A copy of ``repro.launch.analytic`` on the port's config
(:mod:`repro_torch.models.config`): the same arithmetic, number for number.
It derives a step's executed FLOPs and first-order HBM traffic from the
config the model is built from, every matmul of the model included, with
the baseline's deliberate inefficiencies (full-rectangle causal attention
in the chunked path, capacity-factor padding in MoE dispatch).  It counts
what the reference's sharded step executes (HBM traffic per device of a
``chips``-device mesh), not the work a single-device torch step does.

Conventions:
* matmul (m, k) @ (k, n) = 2 m k n FLOPs;
* backward = 2x forward matmul FLOPs; ``remat='full'`` adds one forward
  recompute (total 4x fwd for train);
* MODEL_FLOPS (the "useful" yardstick) = 6 N D for training and 2 N D for
  single-token decode, N = active params (sans embeddings), D = tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import (ATTN, ATTN_CROSS, HYMBA, MLSTM,
                                       SLSTM, ModelConfig, ShapeConfig)


@dataclass(frozen=True)
class CellCost:
    exec_flops_total: float      # executed FLOPs, whole step, all devices
    model_flops_total: float     # 6*N*D (train) / 2*N*D (decode)
    hbm_bytes_per_dev: float     # first-order HBM traffic per device
    notes: str = ""


# ---------------------------------------------------------------------------
# Per-layer forward FLOPs per token.
# ---------------------------------------------------------------------------

def _attn_proj_flops(cfg) -> float:
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return 2 * d * dh * (h + 2 * kv) + 2 * h * dh * d


def _attn_score_flops(cfg, s_eff: float) -> float:
    """QK^T + PV per token against s_eff keys."""
    return 2 * 2 * cfg.num_heads * cfg.head_dim * s_eff


def _mlp_flops(cfg, d_ff=None) -> float:
    f = cfg.d_ff if d_ff is None else d_ff
    n_mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    return 2 * n_mats * cfg.d_model * f


def _moe_flops(cfg) -> float:
    """Executed expert FLOPs per token: top_k paths inflated by the
    capacity factor and expert-dim padding (empty padded buckets)."""
    n_mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    e_pad = -(-cfg.num_experts // 16) * 16  # 16-way EP in production
    waste = cfg.capacity_factor * (e_pad / cfg.num_experts)
    router = 2 * cfg.d_model * cfg.num_experts
    expert = 2 * n_mats * cfg.d_model * cfg.d_ff * cfg.top_k
    return router + expert * waste


def _ssm_flops(cfg) -> float:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    s = cfg.ssm_state
    dtr = max(d // 16, 8)
    return (2 * d * 2 * inner              # in_proj
            + 2 * cfg.conv_kernel * inner  # conv
            + 2 * inner * (dtr + 2 * s)    # x_proj
            + 2 * dtr * inner              # dt_proj
            + 8 * inner * s                # scan update + readout
            + 2 * inner * d)               # out_proj


def _mlstm_flops(cfg, chunk: int = 256) -> float:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    h = cfg.num_heads
    dh = inner // h
    return (2 * d * 2 * inner              # up
            + 2 * cfg.conv_kernel * inner
            + 3 * 2 * inner * inner        # q, k, v
            + 2 * inner * 2 * h            # gates
            + 2 * 2 * inner * chunk        # intra-chunk scores + PV
            + 2 * 2 * inner * dh           # inter-chunk state read + update
            + 2 * inner * d)               # down


def _slstm_flops(cfg) -> float:
    d = cfg.d_model
    dh = d // cfg.num_heads
    ff = int(d * 4 / 3)
    return (2 * d * 4 * d                  # input gates
            + 2 * d * 4 * dh               # block-diag recurrence
            + 2 * 3 * d * ff)              # gated FFN


def _layer_forward_flops(cfg, kind: str, s_eff: float) -> float:
    if kind in (ATTN, ATTN_CROSS):
        fl = _attn_proj_flops(cfg) + _attn_score_flops(cfg, s_eff)
        if kind == ATTN_CROSS:
            fl += _attn_proj_flops(cfg) + _attn_score_flops(
                cfg, cfg.encoder_seq_len)
        fl += _moe_flops(cfg) if cfg.is_moe else _mlp_flops(cfg)
        return fl
    if kind == HYMBA:
        return (_attn_proj_flops(cfg) + _attn_score_flops(cfg, s_eff)
                + _ssm_flops(cfg) + _mlp_flops(cfg))
    if kind == MLSTM:
        return _mlstm_flops(cfg)
    if kind == SLSTM:
        return _slstm_flops(cfg)
    raise ValueError(kind)


def _active_params_sans_embed(cfg) -> float:
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return cfg.active_param_count() - emb


def _s_eff(cfg, kind: str, window: int, t: int, *, mode: str = "full",
           decode_cache: int | None = None) -> float:
    """Effective keys per query.

    mode='full'  : baseline executed rectangle (no block skipping);
    mode='diag'  : diagonal skipping only -> causal average (t+1)/2;
    mode='banded': static window banding -> ~window + block granularity;
    mode='useful': the MODEL_FLOPS yardstick (min(window, causal avg)).
    """
    if decode_cache is not None:
        if window and window < decode_cache:
            return float(window)
        return float(decode_cache)
    if mode == "full":
        return float(t)
    if mode == "diag":
        return (t + 1) / 2.0
    if mode == "banded":
        if window and window < t:
            return float(window) + 512.0   # half-block granularity overhead
        return (t + 1) / 2.0
    # useful
    if window and window < t:
        return float(window)
    return (t + 1) / 2.0


# ---------------------------------------------------------------------------
# Cell-level totals.
# ---------------------------------------------------------------------------

def _exec_mode(cfg, skip_above_diagonal: bool) -> str:
    if cfg.attn_banded and cfg.sliding_window:
        return "banded"
    if skip_above_diagonal or cfg.attn_skip_diagonal:
        return "diag"
    return "full"


def train_cost(cfg: ModelConfig, shape: ShapeConfig, chips: int,
               remat: str = "full",
               skip_above_diagonal: bool = False) -> CellCost:
    b, t = shape.global_batch, shape.seq_len
    tokens = b * t
    mode = _exec_mode(cfg, skip_above_diagonal)
    fwd = 0.0
    useful_fwd = 0.0
    for kind, window in zip(cfg.block_pattern, cfg.windows):
        s_exec = _s_eff(cfg, kind, window, t, mode=mode)
        fwd += _layer_forward_flops(cfg, kind, s_exec)
        useful_fwd += _layer_forward_flops(
            cfg, kind, _s_eff(cfg, kind, window, t, mode="useful"))
    if cfg.is_encdec:
        enc_fl = cfg.encoder_layers * (
            _attn_proj_flops(cfg)
            + _attn_score_flops(cfg, cfg.encoder_seq_len)
            + _mlp_flops(cfg))
        # encoder tokens differ from decoder tokens
        fwd_enc = enc_fl * b * cfg.encoder_seq_len
    else:
        fwd_enc = 0.0
    logits = 2 * cfg.d_model * cfg.vocab_padded
    mult = 4.0 if remat == "full" else 3.0
    # logits/loss live OUTSIDE the scanned+checkpointed stack: never
    # recomputed by remat -> always 3x (fwd + 2x bwd).
    exec_total = fwd * mult * tokens + logits * 3.0 * tokens + fwd_enc * mult

    n_active = _active_params_sans_embed(cfg)
    model_total = 6.0 * n_active * tokens

    # --- HBM traffic per device (first order) ---------------------------
    # master/moments/grads are ZeRO-sharded over the whole mesh for large
    # leaves (runtime/sharding.py); the bf16 working copy is read from a
    # TP-sharded (1/16) layout on every pass (fwd, bwd, remat-recompute).
    p_total = cfg.param_count()
    opt_traffic = p_total * 28 / chips          # m r/w + v r/w + p r/w + g w
    weight_reads = (p_total * 2 / min(chips, 16)) \
        * (3 if remat == "full" else 2)
    d_bytes = 2
    acts = (cfg.num_layers * (tokens / chips) * cfg.d_model * d_bytes
            * (4 if remat == "full" else 8))
    logits_traffic = 3 * (tokens / chips) * (cfg.vocab_padded / min(chips, 16)) \
        * d_bytes * 4
    hbm = opt_traffic + weight_reads + acts + logits_traffic
    return CellCost(exec_total, model_total, hbm,
                    notes=f"mult={mult}x fwd (logits 3x); "
                          f"{'banded/diag-skip' if skip_above_diagonal else 'full-rectangle'}"
                          " attention")


def _tp_sharded(cfg) -> bool:
    return True  # all archs shard something over the model axis


def decode_cost(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                swa_cache: str = "full") -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    fwd = 0.0
    cache_bytes = 0.0
    d_bytes = 2
    for kind, window in zip(cfg.block_pattern, cfg.windows):
        if kind in (ATTN, ATTN_CROSS, HYMBA):
            s_att = _s_eff(cfg, kind, window, 1,
                           decode_cache=(s if (swa_cache == "full" or
                                               not window) else window))
            fwd += _layer_forward_flops(cfg, kind, s_att)
            kv_len = s if (swa_cache == "full" or not window) else window
            cache_bytes += (2 * kv_len * cfg.num_kv_heads * cfg.head_dim
                            * d_bytes)
            if kind == HYMBA:
                inner = cfg.ssm_expand * cfg.d_model
                cache_bytes += inner * cfg.ssm_state * 4
        elif kind == MLSTM:
            fwd += _mlstm_flops(cfg, chunk=1)
            inner = cfg.ssm_expand * cfg.d_model
            dh = inner // cfg.num_heads
            cache_bytes += cfg.num_heads * dh * dh * 4 * 2  # C r/w
        elif kind == SLSTM:
            fwd += _slstm_flops(cfg)
            cache_bytes += cfg.d_model * 4 * 8
    logits = 2 * cfg.d_model * cfg.vocab_size
    exec_total = (fwd + logits) * b          # one token per sequence
    n_active = _active_params_sans_embed(cfg)
    model_total = 2.0 * n_active * b
    # HBM per device: active weights once + this device's cache slice
    p_active_dev = cfg.active_param_count() / min(chips, 16)
    cache_dev = cache_bytes * b / chips
    hbm = p_active_dev * 4 + cache_dev
    return CellCost(exec_total, model_total, hbm,
                    notes=f"swa_cache={swa_cache}")


def prefill_cost(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                 skip_above_diagonal: bool = False) -> CellCost:
    b, t = shape.global_batch, shape.seq_len
    tokens = b * t
    mode = _exec_mode(cfg, skip_above_diagonal)
    fwd = 0.0
    useful = 0.0
    for kind, window in zip(cfg.block_pattern, cfg.windows):
        s_exec = _s_eff(cfg, kind, window, t, mode=mode)
        fwd += _layer_forward_flops(cfg, kind, s_exec)
        useful += _layer_forward_flops(
            cfg, kind, _s_eff(cfg, kind, window, t, mode="useful"))
    logits = 2 * cfg.d_model * cfg.vocab_padded  # last position only
    exec_total = fwd * tokens + logits * b
    n_active = _active_params_sans_embed(cfg)
    model_total = 2.0 * n_active * tokens
    p_dev = cfg.param_count() * 2 / min(chips, 16)   # bf16 weights, once
    acts = cfg.num_layers * (tokens / chips) * cfg.d_model * 2 * 4
    hbm = p_dev + acts
    return CellCost(exec_total, model_total, hbm,
                    notes="prefill"
                          + ("; banded/diag-skip" if skip_above_diagonal
                             else "; full-rectangle"))


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, chips: int,
              **kw) -> CellCost:
    if shape.kind in ("train", "prefill"):
        kw.setdefault("skip_above_diagonal",
                      cfg.attn_skip_diagonal or cfg.attn_banded)
    if shape.kind == "train":
        return train_cost(cfg, shape, chips, remat=cfg.remat, **kw)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape, chips, **kw)
    return decode_cost(cfg, shape, chips, swa_cache=cfg.swa_cache, **kw)
