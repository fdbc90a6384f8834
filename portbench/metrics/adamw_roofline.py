"""``adamw_roofline`` (%): AdamW's 28 bytes a stored parameter over the
HBM rate, over the mean CUDA-event time of the step's calls of
``adamw_update`` in the traced window."""
from portbench.yardstick import peaks, work


def read(rec):
    calls = rec.spans.get("adamw_update") if rec.trace is not None else None
    if not calls or not rec.trace.device:
        return None
    bound = work.ADAMW_BYTES_PER_PARAM * rec.n_params / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (sum(calls) / len(calls))
