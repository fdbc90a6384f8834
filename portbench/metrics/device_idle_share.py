"""``device_idle_share`` (%): the share of the traced window's steady part,
from the device's first operation in it to its last
(``yardstick.trace.device_span``), in which no kernel, copy or set ran on
the device (torch.profiler's CUDA records)."""
from portbench.yardstick import trace as T


def read(rec):
    span = T.device_span(rec.trace) if rec.trace is not None else None
    if span is None:
        return None
    first, last = span
    return 100.0 * (1.0 - T.busy_ns(rec.trace, first, last) / (last - first))
