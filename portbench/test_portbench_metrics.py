"""The per-layer readers and the trace's reduction on a synthetic trace,
and the frozen yardstick against the arithmetic it was copied from."""
import math
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.yardstick import peaks, work
from portbench.yardstick import trace as T

MS = 1_000_000  # ns


def _synthetic():
    """A window of 100 ms: two attention calls of 4 ms, a GEMM of 50 ms,
    gaps of 10 ms (host in aten::mul), 2 us (small) and 20 ms (host in
    aten::index_add_ inside an autograd op)."""
    lo = 1_000 * MS
    dev = [(lo + 10 * MS, lo + 14 * MS, "flash_attention_prefill_kernel<128>"),
           (lo + 14 * MS, lo + 18 * MS, "flash_attention_prefill_kernel<128>"),
           (lo + 28 * MS, lo + 78 * MS, "sm90_gemm"),
           (lo + 78 * MS + 2_000, lo + 80 * MS, "elementwise"),
           (lo + 100 * MS, lo + 120 * MS, "after the window")]
    host = [(lo, lo + 100 * MS, "autograd::engine"),
            (lo + 17 * MS, lo + 29 * MS, "aten::mul"),
            (lo + 70 * MS, lo + 99 * MS, "aten::index_add_")]
    return T.Trace(device=dev, host=sorted(host),
                   window=(lo, lo + 100 * MS))


def _recorded(trace, spans=None, steps=2, window_s=0.1):
    sizes = harness.model_sizes(harness.load_json("configs", "starcoder2-3b"),
                                2048)
    return harness.Recorded(cell="c", sizes=sizes, batch=4, seq=2048,
                            steps=steps, window_s=window_s, trace=trace,
                            spans=spans or {}, n_params=3_000_000_000)


def test_trace_reduction():
    tr = _synthetic()
    assert T.busy_ns(tr) == (8 + 50 + 2) * MS - 2_000
    ops = T.device_ops(tr)
    assert ops["flash_attention_prefill_kernel<128>"] == (0.008, 2)
    assert "after the window" not in ops
    gaps = T.idle_gaps(tr)
    assert gaps == pytest.approx({"aten::mul": 0.010,
                                  T.SMALL_GAP_LABEL: 2e-6})
    assert T.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                        ["c", 2.0]]


def test_readers_on_a_synthetic_trace():
    tr = _synthetic()
    rec = _recorded(tr, spans={"adamw_update": [0.2, 0.3],
                               "loss_and_grads": [1.0, 3.0]})
    read = {m: harness.load_module("metrics", m).read for m in (
        "device_idle_share", "train_mfu", "attn_fwd_roofline",
        "adamw_roofline", "loss_and_grads_ms")}
    # steady part: 10 ms .. 80 ms, busy 60 ms less 2 us
    assert read["device_idle_share"](rec) == pytest.approx(
        100 * (1 - (60 * MS - 2_000) / (70 * MS)))
    s = rec.sizes
    # over the device's span, 10 ms .. 80 ms, not the window's 100 ms
    assert T.device_span(tr) == (tr.window[0] + 10 * MS, tr.window[0] + 80 * MS)
    assert read["train_mfu"](rec) == pytest.approx(
        100 * 2 * work.model_flops(s, 4, 2048) / 0.07 / peaks.BF16_FLOPS)
    nbytes, ops = work.attention_call_work(4, 2048, 24, 128, 2048, 2, 2)
    assert read["attn_fwd_roofline"](rec) == pytest.approx(
        100 * max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.BF16_FLOPS)
        / 0.004)
    assert read["adamw_roofline"](rec) == pytest.approx(
        100 * 28 * 3e9 / peaks.HBM_BYTES_PER_S / 0.25)
    assert read["loss_and_grads_ms"](rec) == pytest.approx(2000.0)


def test_readers_find_nothing_without_a_device_trace():
    empty = T.Trace(window=(0, 10))
    for rec in (_recorded(None, spans={"adamw_update": [0.1]}),
                _recorded(empty, spans={"adamw_update": [0.1],
                                        "loss_and_grads": [1.0]})):
        for m in ("device_idle_share", "train_mfu", "attn_fwd_roofline",
                  "adamw_roofline", "loss_and_grads_ms"):
            assert harness.load_module("metrics", m).read(rec) is None, m


@pytest.mark.parametrize("t,s,window", [(2048, 2048, 0), (512, 512, 0),
                                        (64, 64, 16), (16, 80, 0),
                                        (16, 80, 7)])
def test_attention_work_is_the_ports(t, s, window):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(2, t, 6, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, s, 3, 8, dtype=torch.bfloat16)
    qp = torch.arange(s - t, s, dtype=torch.int32)
    kp = torch.arange(s, dtype=torch.int32)
    assert work.attention_call_work(2, t, 6, 8, s, 3, 2, window=window) \
        == fa.work(q, k, qp, kp, causal=True, window=window)


def test_train_step_work_is_chip_smokes():
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    config = harness.load_json("configs", "starcoder2-3b")
    cfg = harness.port_config(config)
    sizes = harness.model_sizes(config, 1024)
    n = 3_000_000_000
    assert work.train_step_work(sizes, 2, 1024, n) == tuple(
        int(x) for x in chip_smoke.train_step_work(cfg, 2, 1024, n))
    assert work.visible_pairs(1024, 512) == chip_smoke.visible_pairs(1024,
                                                                     512)


def test_model_flops_of_the_cells():
    """1.58e14 model FLOP a step for starcoder2-3b at B4 T2048, 4.83e13 for
    granite-moe-3b-a800m's 32 layers."""
    sc = harness.model_sizes(harness.load_json("configs", "starcoder2-3b"))
    gr = harness.model_sizes(harness.load_json("configs",
                                               "granite-moe-3b-a800m"))
    assert math.isclose(work.model_flops(sc, 4, 2048), 1.58e14, rel_tol=0.01)
    assert math.isclose(work.model_flops(gr, 4, 2048), 4.83e13, rel_tol=0.01)
