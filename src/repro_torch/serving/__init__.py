"""Serving on the card: the batched prefill + decode engine."""
from .engine import Request, ServingEngine
