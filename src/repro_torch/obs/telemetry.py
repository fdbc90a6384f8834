"""Run telemetry of the torch cycle engine: the timing record, the graph
cache and its counters, and the provenance block.

The reference's ``repro.obs.telemetry`` times JAX programs through an
in-memory and an on-disk AOT compile cache.  Here the program is a CUDA
graph of the cycle step, and :func:`timed_graph` is the counterpart of
the reference's ``timed_compiled``: it keeps each captured graph, with
the buffers it replays onto, in an in-process LRU of
:data:`_CACHE_LIMIT` entries keyed by the step's static spec, shapes,
device and block of copies.  A hit refills those buffers in place and replays
(``compile_cached="memory"``, ``compile_s`` 0.0); a miss captures
(``compile_cached`` ``False``, ``compile_s`` the warm-up and capture).  A
CUDA graph cannot outlive its process, so there is no disk layer:
:func:`cache_dir` is ``None`` and :func:`disk_cache_entries` empty, and
the disk counters stay 0.  ``execute_s`` is the refill and the replay,
timed to completion on the device (:func:`device_clock`).
:func:`provenance` is the environment block stored with every study
result, with torch's and CUDA's versions and the card's name where the
reference records JAX's version.
"""
from __future__ import annotations

import os
import platform
import time
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

__all__ = ["timed_graph", "provenance", "timing_dict", "device_clock",
           "cache_dir", "cache_stats", "reset_cache_stats", "clear_caches",
           "disk_cache_entries"]

#: Kept graphs, keyed by what the caller's graph depends on, in LRU order
#: (oldest first).  Bounded like the reference's program cache: each
#: entry pins its graph's memory pool and buffers on the device.
_CACHE: OrderedDict = OrderedDict()
_CACHE_LIMIT = 64

#: The reference's cache counters, under its keys: ``memory_hits`` and
#: ``misses`` partition graph acquisitions, ``evictions`` counts LRU
#: drops; ``disk_hits``, ``disk_writes`` and ``disk_errors`` stay 0 (no
#: disk layer).
_STATS = {"memory_hits": 0, "disk_hits": 0, "misses": 0, "evictions": 0,
          "disk_writes": 0, "disk_errors": 0}


def cache_stats() -> dict:
    """A snapshot copy of the cache counters (see :data:`_STATS`)."""
    return dict(_STATS)


def reset_cache_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def cache_dir() -> None:
    """``None``: a CUDA graph cannot outlive its process, so nothing is
    kept on disk."""
    return None


def disk_cache_entries() -> list:
    """``[]``: there is no disk layer (see :func:`cache_dir`)."""
    return []


def clear_caches(*, memory: bool = True, disk: bool = False) -> None:
    """Drop the kept graphs (``memory``); ``disk`` has nothing to drop."""
    if memory:
        _CACHE.clear()


def timed_graph(entries, execute: Callable, *, devices,
                grid_points: int = 1) -> tuple:
    """``execute(graphs)`` on one kept or freshly captured graph for each
    entry ``(key, capture, refill)`` (a sweep's blocks of copies, one a
    device), returning ``(output, timing)`` (:func:`timing_dict`, backend
    ``"torch"``).

    With ``key`` in the cache, the entry is ``refill``-ed in place and
    reused; otherwise ``capture()`` builds it and it is kept under
    ``key``, evicting the least recently used past :data:`_CACHE_LIMIT`.
    ``key=None`` keeps nothing and counts nothing (the CPU's eager runs).
    Where every graph was a hit the record says ``compile_cached="memory"``
    and ``compile_s`` 0.0, and ``execute_s`` runs from the first
    acquisition, so the refills are in it; otherwise ``compile_s`` is the
    acquisitions' time and ``execute_s`` runs from after them to the
    completion of every device in ``devices``."""
    t0 = max(device_clock(d) for d in devices)
    graphs, fresh = [], False
    for key, capture, refill in entries:
        entry = _CACHE.get(key) if key is not None else None
        if entry is not None:
            _CACHE.move_to_end(key)
            _STATS["memory_hits"] += 1
            refill(entry)
        else:
            entry, fresh = capture(), True
            if key is not None:
                _STATS["misses"] += 1
                while len(_CACHE) >= _CACHE_LIMIT:
                    _CACHE.popitem(last=False)
                    _STATS["evictions"] += 1
                _CACHE[key] = entry
        graphs.append(entry)
    t1 = max(device_clock(d) for d in devices)
    out = execute(graphs)
    t2 = max(device_clock(d) for d in devices)
    compile_s, cached, start = ((t1 - t0, False, t1) if fresh
                                else (0.0, "memory", t0))
    return out, timing_dict("torch", compile_s=compile_s,
                            execute_s=t2 - start, compile_cached=cached,
                            grid_points=grid_points)


def timing_dict(backend: str, *, compile_s: float = 0.0,
                execute_s: float = 0.0, compile_cached=False,
                grid_points: int = 1) -> dict:
    """The canonical timing record (reference ``obs/telemetry.py:139``).
    A batched program's dict is shared by every grid point it produced —
    ``grid_points`` says how many, so consumers can amortize.
    ``compile_cached`` is ``False`` for a fresh capture, else the cache
    layer that served the graph (``"memory"``)."""
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
