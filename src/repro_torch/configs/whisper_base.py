"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048
vocab=51865 — enc-dec, conv frontend STUB [arXiv:2212.04356].

``input_specs()`` provides precomputed frame embeddings (1500, d_model) —
the two-conv frontend is stubbed per the assignment.  Decoder blocks carry
cross-attention over the encoder output; decode shapes run with a 32k
self-attention KV cache (beyond Whisper's trained 448 positions — noted in
DESIGN.md as a systems exercise).  RoPE replaces learned positions so the
decoder is length-agnostic.
"""
from repro_torch.models.config import ATTN_CROSS, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    block_pattern=(ATTN_CROSS,) * 6,
    mlp="gelu",
    norm="layernorm",
    attn_bias=True,
    mlp_bias=True,
    encoder_layers=6,
    encoder_seq_len=1500,
))
