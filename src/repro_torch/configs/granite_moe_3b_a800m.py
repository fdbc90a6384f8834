"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite].

NOTE: the assignment line reads "MoE 40e top-8 — 32 experts top-8"; we
follow the config field literally (40 experts) and record the discrepancy
here and in DESIGN.md §6.  40 experts over a 16-way model axis do not
divide evenly, so the EP path pads the expert dim to 48 (3 per shard);
``num_experts`` below stays 40 (router never selects padding experts).
"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    num_experts=40,
    top_k=8,
    capacity_factor=1.25,
    moe_impl="lacin_ep",
    tie_embeddings=True,
))
