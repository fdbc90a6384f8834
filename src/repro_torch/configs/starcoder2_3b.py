"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE [arXiv:2402.19173]; LayerNorm + gelu with biases."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp="gelu",
    norm="layernorm",
    attn_bias=True,
    mlp_bias=True,
    rope_theta=100_000.0,
))
