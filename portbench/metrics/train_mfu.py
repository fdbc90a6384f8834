"""``train_mfu`` (%): the model FLOPs of the traced window's steps
(``yardstick.work.model_flops``: no recomputation counted) over the
device's span of those steps in the trace (``yardstick.trace.device_span``:
the first device operation of the window to its last, on the device's
clock), as a share of the H100's bf16 peak."""
from portbench.yardstick import peaks, work
from portbench.yardstick import trace as T


def read(rec):
    span = T.device_span(rec.trace) if rec.trace is not None else None
    if span is None:
        return None
    flops = work.model_flops(rec.sizes, rec.batch, rec.seq) * rec.steps
    return 100.0 * flops / ((span[1] - span[0]) / 1e9) / peaks.BF16_FLOPS
