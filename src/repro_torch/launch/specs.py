"""``input_specs()``: every model input as a tensor on the ``meta`` device,
which holds a shape and a dtype and allocates nothing.  It stands in for
the reference's ``jax.ShapeDtypeStruct``.

Port of ``repro.launch.specs``.  A training batch lays out its prefix: the
text is ``seq_len`` less the patch embeddings (a VLM's) and the meta
tokens; an encoder-decoder's batch also carries its ``frames``.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import init_caches


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    text = s
    out = {}
    if cfg.num_patch_tokens:
        text = s - cfg.num_patch_tokens
        out["patch_embeds"] = _meta((b, cfg.num_patch_tokens, cfg.d_model),
                                    torch.float32)
    if cfg.num_meta_tokens:
        text = text - cfg.num_meta_tokens
    if cfg.is_encdec:
        out["frames"] = _meta((b, cfg.encoder_seq_len, cfg.d_model),
                              torch.float32)
    out["tokens"] = _meta((b, text), torch.int32)
    out["labels"] = _meta((b, text), torch.int32)
    return out


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    out = train_input_specs(cfg, shape)
    out.pop("labels")
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One new token against caches of ``shape.seq_len`` (one dict per
    layer, :func:`~repro_torch.models.transformer.init_caches`)."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, 1), torch.int32),
           "pos": _meta((), torch.int32),
           "caches": init_caches(cfg, b, s, device="meta")}
    if cfg.is_encdec:
        out["cross_src"] = None     # the cross K/V live in the caches
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    raise ValueError(shape.kind)
