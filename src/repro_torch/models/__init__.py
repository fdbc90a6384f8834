"""Model zoo of the port: configs, layers, and the assembled models."""
from .config import (ATTN, ATTN_CROSS, HYMBA, MLSTM, SLSTM, ModelConfig,
                     get_config, list_archs, register)
from .convert import expert_shard, params_from_numpy
from .layers import AxisRules
from .transformer import (build_runs, cast_params, decode_step, init_caches,
                          init_params, prefill)
