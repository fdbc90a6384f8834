"""Ported architecture configs.  Importing this package registers each one
in :mod:`repro_torch.models.config`'s registry: the JAX package's eleven.
"""
from . import (gemma3_1b, granite_moe_3b_a800m, hymba_1p5b, internvl2_26b,
               llama32_3b, lacin_demo, nemotron4_15b, qwen3_moe_30b_a3b,
               starcoder2_3b, whisper_base, xlstm_350m)

__all__ = ["gemma3_1b", "granite_moe_3b_a800m", "hymba_1p5b",
           "internvl2_26b", "llama32_3b", "lacin_demo", "nemotron4_15b",
           "qwen3_moe_30b_a3b", "starcoder2_3b", "whisper_base",
           "xlstm_350m"]
