"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].

Full (global) attention at layers {0, 15, 31}; sliding-window 1024
elsewhere (Hymba's 3-global pattern).  128 learnable meta tokens prepended.
"""
from repro_torch.models.config import HYMBA, ModelConfig, register

_GLOBAL_AT = {0, 15, 31}
WINDOWS = tuple(0 if i in _GLOBAL_AT else 1024 for i in range(32))

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    block_pattern=(HYMBA,) * 32,
    windows=WINDOWS,
    sliding_window=1024,
    mlp="swiglu",
    norm="rmsnorm",
    ssm_state=16,
    ssm_expand=2,
    conv_kernel=4,
    num_meta_tokens=128,
))
