"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global [hf:google/gemma-3-1b-pt].

Sliding-window 512 on local layers, full attention every 6th layer
(indices 5, 11, 17, 23) with RoPE theta 1M; locals use theta 10k.
head_dim=256 (decoupled from d_model/num_heads), qk-norm, geglu, tied
embeddings.
"""
from repro_torch.models.config import ModelConfig, register

WINDOWS = tuple(0 if i % 6 == 5 else 512 for i in range(26))

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    windows=WINDOWS,
    sliding_window=512,
    mlp="geglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
))
