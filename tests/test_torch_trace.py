"""Traces of the port's torch cycle engine (``trace=``: ring buffers in
the captured step) and the Chrome trace-event export
(``repro_torch.obs.{spans,export}``), against the reference: traced torch
sweeps on the CPU equal ``repro.sim.xengine``'s traces exactly on the
drained deterministic cases of ``tests/test_obs.py:142-197`` (a CIN-16
all-to-all replay, a one-shot permutation, two batched copies); stride k
equals stride 1 downsampled and ``max_samples`` caps rows the same way;
tracing leaves every RunStats field unchanged; ``replay_trace_events``
gives the reference's JSON and passes ``validate_trace_events``; and
``python -m repro_torch.studies trace export`` runs both engines and
writes that JSON.  ``Trace.meta["backend"]`` is the engine's name
(``"torch"`` against ``"jax"``); every other meta field is compared.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as RO
from repro.fabric import make_fabric as r_make_fabric
from repro.sim import xengine as RX
from repro.sim.policies import make_policy as r_policy
from repro.sim.traffic import one_shot_permutation as r_permutation
from repro.sim import simulate as r_simulate

from repro_torch import obs as TO
from repro_torch import sim as T
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.sim import xengine as TX
from repro_torch.sim.workloads import collective_workload as t_workload
from repro_torch.studies.__main__ import main as cli


def ref_replay(**kw):
    return r_make_fabric("xor", 16).replay("all_to_all", message_size=2,
                                           backend="jax", **kw)


def port_replay(**kw):
    return t_make_fabric("xor", 16).replay("all_to_all", message_size=2,
                                           device="cpu", **kw)


def assert_same_trace(port, ref):
    """Every channel and derived series, and every meta field but the
    engine's name."""
    assert port.equals(ref), port.diff_summary(ref)
    assert port.to_dict().keys() == ref.to_dict().keys()
    assert np.array_equal(port.in_flight, ref.in_flight)
    assert np.array_equal(port.link_util(), ref.link_util())
    assert port.meta.pop("backend") == "torch"
    assert port.meta == {k: v for k, v in ref.meta.items() if k != "backend"}
    assert port.events == []


def assert_same_stats(a, b):
    for f in dataclasses.fields(a):
        if f.name in ("timing", "trace"):
            continue
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f.name


def test_replay_trace_equals_xengine_and_changes_no_stat():
    """tests/test_obs.py:128-147: the CIN-16 all-to-all replay, traced and
    untraced, on both engines."""
    ref = ref_replay(trace=True)
    port = port_replay(trace=True)
    assert_same_trace(port.trace, ref.trace)
    assert_same_stats(ref, port)
    untraced = port_replay()
    assert untraced.trace is None
    assert_same_stats(untraced, port)


def test_drained_permutation_trace_equals_xengine():
    """tests/test_obs.py:149-158: a one-shot permutation, drained."""
    partners = (np.arange(16) + 5) % 16
    a = r_simulate(r_make_fabric("xor", 16).sim_topology(),
                   r_policy("minimal"), r_permutation(partners),
                   backend="jax", trace=True)
    b = T.simulate(T.cin_topology("xor", 16), T.make_policy("minimal"),
                   T.one_shot_permutation(partners), trace=True,
                   device="cpu")
    assert_same_trace(b.trace, a.trace)
    assert_same_stats(a, b)


@pytest.mark.parametrize("stride", [2, 3])
def test_stride_k_is_stride_1_downsampled(stride):
    """tests/test_obs.py:161-168 on the torch engine, against the
    reference's stride-k trace too."""
    fine = port_replay(trace=TO.TraceConfig(stride=1)).trace
    coarse = port_replay(trace=TO.TraceConfig(stride=stride)).trace
    assert coarse.stride == stride
    assert coarse.equals(fine.downsample(stride)), \
        coarse.diff_summary(fine.downsample(stride))
    assert coarse.equals(ref_replay(trace=RO.TraceConfig(
        stride=stride)).trace)


def test_max_samples_caps_rows_as_xengine_does():
    """tests/test_obs.py:170-175: 7 rows, the reference's 7 rows."""
    a = ref_replay(trace=RO.TraceConfig(max_samples=7)).trace
    b = port_replay(trace=TO.TraceConfig(max_samples=7)).trace
    assert a.num_samples == b.num_samples == 7
    assert b.equals(a), b.diff_summary(a)


def test_batched_sweep_traces_slice_per_copy():
    """tests/test_obs.py:178-196: two copies of the replay in one sweep
    each carry the single replay's trace; an open-loop batched sweep's
    traces equal xengine's per copy (drain and open loop, two loads x two
    seeds)."""
    single = port_replay(trace=True).trace
    w = t_workload(t_make_fabric("xor", 16), "all_to_all", message_size=2)
    grid = T.sweep(T.cin_topology("xor", 16), "minimal",
                   lambda _l, _s: w.traffic(), [0.0], seeds=(0, 1),
                   warmup=0, trace=True, device="cpu")
    for stats in grid[0]:
        assert stats.trace.equals(single), stats.trace.diff_summary(single)
        assert stats.timing["grid_points"] == 2

    def tf(mod):
        return lambda load, seed: mod.uniform(8, offered=load, cycles=40,
                                              terminals=2, seed=seed)
    from repro import sim as R
    for drain in (False, True):
        kw = dict(seeds=(1, 2), cycles=40, warmup=10, drain=drain,
                  trace={"stride": 3})
        a = RX.sweep(R.cin_topology("xor", 8), "valiant", tf(R), [0.3, 0.6],
                     bucket=False, **kw)
        b = TX.sweep(T.cin_topology("xor", 8), "valiant", tf(T), [0.3, 0.6],
                     device="cpu", **kw)
        for ra, rb in zip(a, b):
            for x, y in zip(ra, rb):
                assert_same_trace(y.trace, x.trace)
                assert_same_stats(x, y)


def test_trace_row_written_only_by_cycles_that_run():
    """A 16-cycle block whose tail is gated off (horizon 20) and a
    max_samples cap below the horizon: the last row is the last sampled
    cycle that ran, not a gated-off one."""
    tr = T.uniform(8, offered=0.5, cycles=20, terminals=2, seed=3)
    st = T.simulate_torch(T.cin_topology("xor", 8), "minimal", tr,
                          cycles=20, trace={"stride": 1, "max_samples": 5},
                          device="cpu")
    assert list(st.trace.cycles) == [0, 1, 2, 3, 4]
    st = T.simulate_torch(T.cin_topology("xor", 8), "minimal", tr,
                          cycles=20, trace={"stride": 6}, device="cpu")
    assert list(st.trace.cycles) == [0, 6, 12, 18]
    assert st.trace.delivered[-1] <= st.packets_delivered


def test_trace_events_equal_the_reference_json(tmp_path):
    """repro.obs.replay_trace_events (with the topology's link classes:
    CIN, Dragonfly with its global class, a degraded CIN with its rerouted
    class) and export_perfetto: the same JSON, valid."""
    from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
    from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
    cases = [
        (r_make_fabric("xor", 16), t_make_fabric("xor", 16), {}),
        (r_make_fabric(R_Dragonfly(4, 2, 2, 5)),
         t_make_fabric(T_Dragonfly(4, 2, 2, 5)), {}),
        (r_make_fabric("xor", 16), t_make_fabric("xor", 16),
         {"failures": {"link_fraction": 0.08, "seed": 3}})]
    for ra, tb, kw in cases:
        a = ra.replay("all_to_all", backend="jax", trace=True, **kw)
        b = tb.replay("all_to_all", device="cpu", trace=True, **kw)
        topo_a, topo_b = ra.sim_topology(), tb.sim_topology()
        if kw:
            topo_a = topo_a.degrade(kw["failures"])
            topo_b = topo_b.degrade(kw["failures"])
        ea = RO.replay_trace_events(a, topo=topo_a)
        eb = TO.replay_trace_events(b, topo=topo_b)
        assert json.dumps(eb, sort_keys=True) == json.dumps(ea,
                                                            sort_keys=True)
        assert TO.validate_trace_events(eb) is eb
        path = tmp_path / "replay.json"
        payload = TO.export_perfetto(str(path), eb)
        assert json.loads(path.read_text()) == payload
    # packet spans come from the numpy engine, as in the reference
    a = r_make_fabric("xor", 16).replay(
        "all_to_all", backend="numpy", trace=RO.TraceConfig(packets=4))
    b = t_make_fabric("xor", 16).replay(
        "all_to_all", backend="numpy", trace=TO.TraceConfig(packets=4))
    assert TO.packet_events(b.trace) == RO.packet_events(a.trace)
    assert TO.phase_events(b) == RO.phase_events(a)
    assert TO.counter_events("u", [0, 2], [0.123456789, 1.0]) == \
        RO.counter_events("u", [0, 2], [0.123456789, 1.0])
    for bad, msg in [([{"name": "a", "ph": "Z", "ts": 0}], "unknown phase"),
                     ([{"name": "a", "ph": "X", "ts": 0}], "dur"),
                     ("nope", "list")]:
        with pytest.raises(ValueError, match=msg):
            TO.validate_trace_events(bad)


def test_cli_trace_export_both_engines(tmp_path, capsys):
    """python -m repro_torch.studies trace export --backend both: the
    numpy oracle and the torch engine (CPU) agree exactly, and the JSON
    written is the reference CLI's."""
    from repro.studies.__main__ import main as r_cli
    out_p, out_r = tmp_path / "port.json", tmp_path / "ref.json"
    args = ["trace", "export", "collective_replay", "--experiment",
            "cin-xor-16/replay-all_to_all/minimal", "--backend", "both",
            "--packets", "4"]
    assert cli(args + ["--device", "cpu", "--out", str(out_p)]) == 0
    text = capsys.readouterr().out
    assert "cross-engine traces agree exactly" in text
    assert "ratio=1.000" in text
    assert r_cli(args + ["--out", str(out_r)]) == 0
    assert json.loads(out_p.read_text()) == json.loads(out_r.read_text())
    TO.validate_trace_events(json.loads(out_p.read_text())["traceEvents"])
    with pytest.raises(SystemExit, match="no experiment named"):
        cli(["trace", "export", "collective_replay", "--experiment", "nope",
             "--device", "cpu", "--out", str(tmp_path / "t.json")])


def test_traced_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_fabric("xor", 8).replay(trace=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["trace", "export", "collective_replay", "--experiment",
             "cin-xor-16/replay-all_to_all/minimal",
             "--out", str(tmp_path / "t.json")])
