"""Deterministic synthetic token data (port of ``repro.data``)."""
from .pipeline import DataConfig, Prefetcher, host_batch
