"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their wrappers,
and the plain PyTorch versions they are held against (:mod:`.ref`).

Sources are compiled by :mod:`._build` at first use, never at import.
"""
