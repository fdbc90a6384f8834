"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

Every layer is MoE (no shared expert); qk-norm per Qwen3.  Expert
parallelism over the "model" mesh axis uses the paper's XOR 1-factor
all-to-all schedule (``moe_impl='lacin_ep'``).
"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    mlp="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    top_k=8,
    capacity_factor=1.25,
    moe_impl="lacin_ep",
))
