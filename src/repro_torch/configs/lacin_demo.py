"""lacin-demo: the paper's own 'architecture' — a small dense LM whose
every communicating axis is driven by LACIN-scheduled collectives
(DP all-reduce and, in the MoE variant, EP all-to-all).  Used by the
examples and collective benchmarks; not part of the assigned 40 cells.
"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="lacin-demo",
    family="dense",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
))
