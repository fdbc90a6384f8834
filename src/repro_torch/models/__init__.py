"""Model zoo of the port: configs, layers, and the assembled models."""
from .config import (ATTN, ATTN_CROSS, HYMBA, MLSTM, SLSTM, ModelConfig,
                     get_config, list_archs, register)
from .convert import (expert_shard, numpy_from_params, params_from_numpy,
                      train_state_from_numpy, train_state_to_numpy)
from .layers import AxisRules
from .transformer import (build_runs, cast_params, cross_entropy, decode_step,
                          forward_train, init_caches, init_params, prefill)
