"""``repro_torch.obs`` — observability for the simulation stack.

==================  =======================================================
:mod:`.trace`       :class:`TraceConfig` / :class:`Trace` — the sampled
                    time-series channels both engines record (link loads,
                    queue occupancy, injections, deliveries) and the
                    derived series (utilization, backlog, in-flight)
:mod:`.spans`       Chrome trace-event builders: phase spans, per-packet
                    hop spans, counter tracks, schema validation
:mod:`.telemetry`   the timing record of runs and the environment
                    :func:`provenance` block study records persist
:mod:`.export`      one-call composition: a traced replay ->
                    Perfetto-loadable JSON with one lane per switch and
                    one span per phase
==================  =======================================================

Capture is engine-native: the numpy :class:`~repro_torch.sim.engine.Engine`
samples at the end of each cycle, and the torch cycle engine
(:mod:`repro_torch.sim.xengine`) carries statically shaped ring buffers
in its captured step, one row write per sampled cycle.  On drained
deterministic workloads the two engines' traces agree exactly.  The
reference's compile cache becomes :mod:`.telemetry`'s graph cache: the
cycle engine's captured CUDA graphs, kept in memory across calls.
"""
from .trace import Trace, TraceConfig, derive_backlog
from .spans import (counter_events, export_perfetto, packet_events,
                    phase_events, request_events, validate_trace_events)
from .telemetry import (cache_stats, clear_caches, device_clock, provenance,
                        reset_cache_stats, timing_dict)
from .export import link_classes, replay_trace_events

__all__ = ["Trace", "TraceConfig", "derive_backlog",
           "counter_events", "export_perfetto", "packet_events",
           "phase_events", "request_events", "validate_trace_events",
           "cache_stats", "clear_caches", "device_clock", "provenance",
           "reset_cache_stats", "timing_dict",
           "link_classes", "replay_trace_events"]
