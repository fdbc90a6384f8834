"""Ported architecture configs.  Importing this package registers each one
in :mod:`repro_torch.models.config`'s registry.

Only the architectures the port serves are here; the JAX package's other
configs come with the model kinds they need (ROADMAP, queue A item 10).
"""
from . import (gemma3_1b, granite_moe_3b_a800m, llama32_3b, lacin_demo,
               starcoder2_3b, xlstm_350m)

__all__ = ["gemma3_1b", "granite_moe_3b_a800m", "llama32_3b", "lacin_demo",
           "starcoder2_3b", "xlstm_350m"]
