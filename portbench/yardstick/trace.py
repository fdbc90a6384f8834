"""The reduction of a ``torch.profiler`` trace to device intervals, busy
time, time by device operation and idle gaps by what the host was doing.

The device records are summed by name from the profiler's raw records,
with no event tree, as ``chip_smoke.py`` ``device_ops`` (commit 6086916)
sums them: a device record has no children, so its duration is its self
time, and ``key_averages()`` builds a tree first, which took tens of
seconds at hundreds of thousands of records.
"""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

#: Gaps shorter than this are counted together, unnamed.
SMALL_GAP_NS = 5_000
SMALL_GAP_LABEL = "(gaps under 5 us)"


@dataclass
class Trace:
    """One traced window on one clock (ns): ``device`` holds (start, end,
    name) of every kernel, copy and set on the device; ``host`` (start,
    end, name) of every host operation, of every thread (the backward runs
    on autograd's own); ``window`` the (start, end) of the window's
    annotation."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0, 0)


def from_profile(prof, annotation: str) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    window ran under ``record_function(annotation)``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    marks = [e for e in events if e.name() == annotation
             and e.device_type() != cuda]
    if not marks:
        raise RuntimeError(f"the trace has no {annotation!r} annotation")
    mark = marks[0]
    out = Trace(window=(mark.start_ns(), mark.start_ns() + mark.duration_ns()))
    for e in events:
        if e.name() == annotation or e.is_user_annotation():
            continue
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            out.device.append((start, start + dur, e.name()))
        else:
            out.host.append((start, start + dur, e.name()))
    out.device.sort()
    out.host.sort()
    return out


def merged(intervals, lo: int, hi: int) -> list:
    """The union of ``intervals`` ((start, end, ...), sorted by start)
    clipped to [lo, hi], as sorted disjoint (start, end) pairs."""
    out = []
    for iv in intervals:
        s, e = max(iv[0], lo), min(iv[1], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(trace: Trace, lo: int | None = None, hi: int | None = None):
    """Nanoseconds in [lo, hi] (default: the window) in which some
    operation ran on the device."""
    lo = trace.window[0] if lo is None else lo
    hi = trace.window[1] if hi is None else hi
    return sum(e - s for s, e in merged(trace.device, lo, hi))


def device_span(trace: Trace):
    """(start, end) ns of the window's steady part: from the start of the
    first device operation inside the window to the end of the last; None
    where no device operation ran inside it."""
    lo, hi = trace.window
    inside = [d for d in trace.device if d[0] >= lo and d[1] <= hi]
    if not inside:
        return None
    return inside[0][0], max(d[1] for d in inside)


def device_ops(trace: Trace) -> dict:
    """{name: (seconds, calls)} of the device records in the window."""
    lo, hi = trace.window
    rows = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in trace.device:
        if s >= lo and e <= hi:
            rows[name][0] += (e - s) / 1e9
            rows[name][1] += 1
    return {k: (t, c) for k, (t, c) in rows.items()}


def _innermost(host, starts, t: int, max_walk: int = 20000) -> str:
    """The name of the host operation running at ``t`` that started last:
    the innermost of the thread that was busy."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - max_walk, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(host outside any operation)"


def idle_gaps(trace: Trace) -> dict:
    """{label: seconds} of the device's idle time between its first and
    last operation in the window, each gap named by the innermost host
    operation that ran at its middle (gaps under 5 us counted together)."""
    lo, hi = trace.window
    busy = merged(trace.device, lo, hi)
    starts = [h[0] for h in trace.host]
    out = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        label = (SMALL_GAP_LABEL if gap < SMALL_GAP_NS
                 else _innermost(trace.host, starts, (e0 + s1) // 2))
        out[label] += gap / 1e9
    return dict(out)


def top(rows: dict, n: int = 10) -> list:
    """The ``n`` largest of {name: seconds} as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(rows.items(), key=lambda kv: -kv[1])[:n]]
