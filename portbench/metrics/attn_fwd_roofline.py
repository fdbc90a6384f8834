"""``attn_fwd_roofline`` (%): the least time of one attention forward call
at the cell's shapes (the larger of its bytes over the HBM rate and its
operations over the bf16 peak, ``yardstick.work.attention_call_work``)
over the mean device time of the calls of the port's bf16 attention
kernel (``flash_attention_prefill_kernel``) in the traced window."""
from portbench.yardstick import peaks, work
from portbench.yardstick import trace as T

KERNEL = "flash_attention_prefill_kernel"


def read(rec):
    if rec.trace is None:
        return None
    calls = [(t, c) for name, (t, c) in T.device_ops(rec.trace).items()
             if KERNEL in name]
    n = sum(c for _, c in calls)
    if not n:
        return None
    s = rec.sizes
    nbytes, ops = work.attention_call_work(
        rec.batch, rec.seq, s["num_heads"], s["head_dim"], rec.seq,
        s["num_kv_heads"], 2, causal=True, window=s["windows"][0])
    bound = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.BF16_FLOPS)
    return 100.0 * bound / (sum(t for t, _ in calls) / n)
