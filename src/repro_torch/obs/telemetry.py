"""Run telemetry of the torch cycle engine: the canonical timing record.

The reference's ``repro.obs.telemetry`` times JAX programs through an
in-memory and an on-disk AOT compile cache.  A CUDA graph cannot be kept
across processes, and the port keeps none within one either, so every
run captures its graph anew: ``compile_cached`` is always ``False`` here.
``compile_s`` is the graph's warm-up and capture; ``execute_s`` is its
replay, timed to completion on the device (:func:`device_clock`).
:func:`provenance` is the environment block stored with every study
result, with torch's and CUDA's versions and the card's name where the
reference records JAX's version.
"""
from __future__ import annotations

import os
import platform
import time

import numpy as np
import torch


def timing_dict(backend: str, *, compile_s: float = 0.0,
                execute_s: float = 0.0, compile_cached=False,
                grid_points: int = 1) -> dict:
    """The canonical timing record (reference ``obs/telemetry.py:139``).
    A batched program's dict is shared by every grid point it produced —
    ``grid_points`` says how many, so consumers can amortize.
    ``compile_cached`` is ``False`` for a fresh compile, else the cache
    layer that served the program."""
    return {
        "backend": backend,
        "compile_s": round(float(compile_s), 6),
        "execute_s": round(float(execute_s), 6),
        "total_s": round(float(compile_s) + float(execute_s), 6),
        "compile_cached": (compile_cached if compile_cached else False),
        "grid_points": int(grid_points),
    }


def device_clock(device: torch.device) -> float:
    """``time.perf_counter()`` once ``device`` has finished its queued
    work, so intervals between two calls are device time, not enqueue
    time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def provenance(timing: dict | None = None, *, backend: str | None = None,
               spec_digest: str | None = None) -> dict:
    """The environment/provenance block persisted with results: where and
    with what a number was produced (reference ``obs/telemetry.py:371``:
    the same keys, with ``torch``, ``cuda`` and ``device`` in place of
    ``jax``; ``device`` is ``None`` where CUDA is not visible)."""
    out = {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "numpy": np.__version__,
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else None),
    }
    if backend is not None:
        out["backend"] = backend
    if spec_digest:
        out["spec_digest"] = spec_digest
    if timing is not None:
        out["timings"] = dict(timing)
    return out
