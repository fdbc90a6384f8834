"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517]; xLSTM[7:1]-style ratio — one sLSTM
per 8 layers (positions 4, 12, 20), mLSTM elsewhere.  d_ff=0: no separate
transformer FFN; mLSTM blocks carry a 2x up-projection, sLSTM blocks a 4/3
gated post-FFN (paper's block design).
"""
from repro_torch.models.config import MLSTM, SLSTM, ModelConfig, register

_SLSTM_AT = {4, 12, 20}
PATTERN = tuple(SLSTM if i in _SLSTM_AT else MLSTM for i in range(24))

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    block_pattern=PATTERN,
    mlp="swiglu",
    norm="rmsnorm",
    ssm_expand=2,
    conv_kernel=4,
    tie_embeddings=True,
))
