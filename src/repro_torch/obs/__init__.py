"""``repro_torch.obs`` — observability for the simulation stack.

Ported so far: the time-series :class:`Trace` / :class:`TraceConfig` the
numpy engine records (:mod:`.trace`), and the timing and provenance
records of runs (:mod:`.telemetry`).  The reference's Chrome-trace
spans, Perfetto export and compile caches are not ported yet (ROADMAP
queue A, item 7).
"""
from .trace import Trace, TraceConfig, derive_backlog
from .telemetry import device_clock, provenance, timing_dict

__all__ = ["Trace", "TraceConfig", "derive_backlog", "device_clock",
           "provenance", "timing_dict"]
