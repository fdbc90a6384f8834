"""Atomic, async, self-validating checkpoints (port of
``repro.checkpoint``)."""
from .manager import CheckpointManager
