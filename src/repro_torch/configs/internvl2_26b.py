"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821].

Assignment specifies the TRANSFORMER BACKBONE only; the InternViT frontend
is a stub — ``input_specs()`` provides 256 precomputed patch embeddings at
d_model, prepended to the token stream (loss masked over the prefix).
"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    num_patch_tokens=256,
))
