"""The port's serving workloads (``repro_torch.workload``: arrival
processes, serving traffic and demands, the CLI), the torch cycle
engine's request metrics (ROADMAP A3e), serving studies, the flow tier's
``serving_stats`` and ``Study.slo_capacity``, against the reference's
(``repro.workload``, ``repro.sim.xengine``, ``repro.studies``).

Arrays and JSON are held bit for bit.  The torch engine on the CPU is
held to ``repro.sim.xengine.simulate_jax`` on every RunStats field but
``timing``/``trace``; against the numpy oracle only request count and
SLO attainment, since the reference's own two engines disagree on
serving p99 (ROADMAP C2).  The graph cache's counters and the ``cache``
CLI close the file.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro import sim as R
from repro import studies as RS
from repro import workload as RW
from repro.sim import xengine as RX
from repro.sim.engine import simulate as r_simulate
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly

from repro_torch import sim as T
from repro_torch import studies as TS
from repro_torch import workload as TW
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.obs import telemetry
from repro_torch.studies.__main__ import main as studies_cli
from repro_torch.workload.__main__ import main as workload_cli

SERVING_FIELDS = ("request_count", "request_latency_p50",
                  "request_latency_p95", "request_latency_p99",
                  "slo_target", "slo_attainment")

ARRIVALS = {
    "poisson": dict(kind="poisson", rate=0.04),
    "mmpp": dict(kind="mmpp", rate=0.03, burst=6.0, p_on=0.05, p_off=0.2),
    "poisson_pinned": dict(kind="poisson", rate=0.02, seed=11),
    "trace": dict(kind="trace", times=(9, 1, 5, 5, 30), sources=(1, 2, 0, 3,
                                                                  1)),
    "trace_unsourced": dict(kind="trace", times=(4, 0, 17, 3)),
}


def assert_same_stats(a, b, skip=("timing", "trace")):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
        else:
            assert x == y, (f.name, x, y)


def record(result, drop=("backend", "provenance")):
    return {k: v for k, v in result.record().items() if k not in drop}


# ---------------------------------------------------------------------------
# (1) Arrivals, serving traffic and demands: the reference's, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.5, 1.0, 2.5])
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kind", sorted(ARRIVALS))
def test_arrivals_and_serving_traffic_equal_the_reference(kind, seed, scale):
    """repro.workload.ArrivalSpec.arrivals, serving_traffic and
    serving_demands: every array, name, offered rate and SLO."""
    a, b = RW.ArrivalSpec(**ARRIVALS[kind]), TW.ArrivalSpec(**ARRIVALS[kind])
    assert b.to_json() == a.to_json() and b.label == a.label
    assert TW.ArrivalSpec.from_json(a.to_json()) == b
    if kind.startswith("trace") and scale != 1.0:
        for spec in (a, b):
            with pytest.raises(ValueError, match="rate-scaled"):
                spec.arrivals(n=8, horizon=64, seed=seed, scale=scale)
        return
    for x, y in zip(a.arrivals(n=8, horizon=64, seed=seed, scale=scale),
                    b.arrivals(n=8, horizon=64, seed=seed, scale=scale)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    kw = dict(cycles=64, load=scale, terminals=2, packets_per_request=3,
              slo=25.0, seed=seed)
    ra, tb = RW.serving_traffic(a, 8, **kw), TW.serving_traffic(b, 8, **kw)
    for f in ("src", "dst", "gen", "request"):
        x, y = getattr(ra, f), getattr(tb, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (tb.name, tb.offered, tb.horizon, tb.terminals, tb.slo) == \
        (ra.name, ra.offered, ra.horizon, ra.terminals, ra.slo)
    for x, y in zip(RW.serving_demands(ra, 8), TW.serving_demands(tb, 8)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if not kind.startswith("trace"):
        assert b.mean_rate == a.mean_rate


@pytest.mark.parametrize("kwargs,match", [
    (dict(kind="bursty"), "unknown arrival kind"),
    (dict(rate=-0.1), "rate must be"),
    (dict(burst=0.5), "burst"),
    (dict(kind="mmpp", p_on=0.0), "transition probabilities"),
    (dict(kind="trace"), "at least one"),
    (dict(kind="trace", times=(1, -2)), "times must be"),
    (dict(kind="trace", times=(1, 2), sources=(0,)), "match"),
    (dict(kind="trace", times=(1,), sources=(-1,)), "sources must be"),
])
def test_arrival_validation_raises_as_the_reference(kwargs, match):
    msgs = []
    for mod in (RW, TW):
        with pytest.raises(ValueError, match=match) as err:
            mod.ArrivalSpec(**kwargs)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_arrival_sampling_and_traffic_errors_equal_the_reference():
    for mod in (RW, TW):
        spec = mod.ArrivalSpec(kind="trace", times=(0,), sources=(9,))
        with pytest.raises(ValueError, match="outside"):
            spec.arrivals(n=4, horizon=10)
        with pytest.raises(ValueError, match="n >= 1"):
            mod.ArrivalSpec().arrivals(n=0, horizon=10)
        with pytest.raises(ValueError, match="scale must be"):
            mod.ArrivalSpec().arrivals(n=4, horizon=10, scale=-1)
        with pytest.raises(ValueError, match="needs an ArrivalSpec"):
            mod.serving_traffic(None, 4, cycles=10)
        with pytest.raises(ValueError, match="packets_per_request"):
            mod.serving_traffic(mod.ArrivalSpec(), 4, cycles=10,
                                packets_per_request=0)
        with pytest.raises(TypeError, match="ArrivalSpec"):
            mod.ArrivalSpec.coerce(3)
        with pytest.raises(ValueError, match="no intrinsic mean rate"):
            mod.ArrivalSpec(kind="trace", times=(1,)).mean_rate
    assert TW.ArrivalSpec.coerce({"kind": "mmpp"}) == TW.ArrivalSpec("mmpp")
    assert TW.ArrivalSpec.coerce(None) is None
    assert sorted(TW.KINDS) == sorted(RW.KINDS)


# ---------------------------------------------------------------------------
# (2) A3(e): the torch engine's request metrics against xengine.
# ---------------------------------------------------------------------------

def _c2_traffic(mod):
    """The C2 scenario (tests/test_workload.py): xor-8, Poisson 0.04,
    seed 5, 150 cycles, drained."""
    return mod.serving_traffic(mod.ArrivalSpec(rate=0.04), 8, cycles=150,
                               packets_per_request=4, slo=30.0, seed=5)


def test_c2_serving_metrics_equal_xengine_and_the_oracle_count():
    """repro.sim.xengine.simulate_jax on the C2 scenario, every field; the
    numpy oracle on request count and attainment only (C2)."""
    kw = dict(cycles=150, warmup=0, drain=True)
    a = RX.simulate_jax(R.cin_topology("xor", 8), "minimal",
                        _c2_traffic(RW), **kw)
    b = T.simulate_torch(T.cin_topology("xor", 8), "minimal",
                         _c2_traffic(TW), device="cpu", **kw)
    assert_same_stats(a, b)
    assert b.request_count > 0 and b.slo_target == 30.0
    assert b.request_latency_p50 <= b.request_latency_p95 \
        <= b.request_latency_p99
    o = r_simulate(R.cin_topology("xor", 8), R.MinimalPolicy(),
                   _c2_traffic(RW), backend="numpy", **kw)
    assert (o.request_count, o.slo_attainment) == \
        (b.request_count, b.slo_attainment)


@pytest.mark.parametrize("drain", [True, False])
def test_dragonfly_serving_sweep_equals_xengine(drain):
    """A small Dragonfly with 3 terminals, MMPP arrivals, two loads x two
    seeds in one sweep: every RunStats field, serving included; undrained
    runs count their open requests as misses."""
    def tf(mod):
        spec = mod.ArrivalSpec(kind="mmpp", rate=0.02, burst=6.0)
        return lambda load, seed: mod.serving_traffic(
            spec, 20, cycles=60, load=load, terminals=3,
            packets_per_request=4, slo=20.0, seed=seed)
    kw = dict(seeds=(1, 2), terminals=3, cycles=60, warmup=0, drain=drain)
    ref = RX.sweep(R.dragonfly_topology(R_Dragonfly(4, 3, 2, 5)), "minimal",
                   tf(RW), [0.5, 1.5], bucket=False, **kw)
    port = T.sweep(T.dragonfly_topology(T_Dragonfly(4, 3, 2, 5)), "minimal",
                   tf(TW), [0.5, 1.5], device="cpu", **kw)
    for ra, rb in zip(ref, port):
        for a, b in zip(ra, rb):
            assert_same_stats(a, b)
            assert b.request_count > 0
            assert b.slo_attainment is not None


def test_unsorted_serving_traffic_recovers_the_request_order():
    """Traffic not already (src, gen)-sorted: _pack_traffic's lexsort and
    the request ids follow the same permutation, as in xengine."""
    def shuffled(mod, simmod):
        tr = _c2_traffic(mod)
        perm = np.random.default_rng(3).permutation(tr.num_packets)
        return simmod.Traffic(
            tr.name, tr.src[perm], tr.dst[perm], tr.gen[perm],
            offered=tr.offered, horizon=tr.horizon, terminals=tr.terminals,
            request=tr.request[perm], slo=tr.slo)
    kw = dict(cycles=150, warmup=0, drain=True)
    a = RX.simulate_jax(R.cin_topology("xor", 8), "minimal",
                        shuffled(RW, R), **kw)
    b = T.simulate_torch(T.cin_topology("xor", 8), "minimal",
                         shuffled(TW, T), device="cpu", **kw)
    assert_same_stats(a, b)
    c = T.simulate_torch(T.cin_topology("xor", 8), "minimal",
                         _c2_traffic(TW), device="cpu", **kw)
    assert [getattr(b, f) for f in SERVING_FIELDS] == \
        [getattr(c, f) for f in SERVING_FIELDS]


# ---------------------------------------------------------------------------
# (3) Serving specs and studies.
# ---------------------------------------------------------------------------

def _serving_spec(mod, slo=40.0, rate=0.05, cycles=150, **sweep):
    """tests/test_workload.py's _serving_spec, built with ``mod``."""
    return mod.ExperimentSpec(
        fabric=mod.FabricSpec(kind="cin", params={"instance": "xor", "n": 8}),
        traffic=mod.TrafficSpec(pattern="serving",
                                params={"arrival": {"kind": "poisson",
                                                    "rate": rate},
                                        "packets_per_request": 2,
                                        "slo": slo}),
        routing=mod.RoutingSpec(policy="minimal"),
        sweep=mod.SweepSpec(**{"loads": (1.0,), "seeds": (3,),
                               "cycles": cycles, "warmup": 0, **sweep}),
        terminals=1, engine={"drain": True})


def test_serving_specs_json_names_and_digests_equal_the_reference():
    specs = [(_serving_spec(RS), _serving_spec(TS))] + list(zip(
        RS.load_specs(RS.bundled_spec_path("serving_slo")),
        TS.load_specs(TS.bundled_spec_path("serving_slo"))))
    assert len(specs) == 4
    for a, b in specs:
        assert b.to_json() == a.to_json()
        assert (b.name, b.digest()) == (a.name, a.digest())
        assert TS.ExperimentSpec.from_json(b.to_json()) == b
        assert b.traffic.label == a.traffic.label
        assert [b.key(*p) for p in b.points()] == \
            [a.key(*p) for p in a.points()]
    assert "serving-poisson" in specs[0][1].name
    bad = TS.TrafficSpec("serving", {"arrival": {"kind": "poisson"},
                                     "burstiness": 2})
    topo = T.cin_topology("xor", 8)
    with pytest.raises(ValueError, match="unknown serving traffic params"):
        bad.factory(topo, cycles=10, terminals=1)
    with pytest.raises(ValueError, match="params\\['arrival'\\]"):
        TS.TrafficSpec("serving").factory(topo, cycles=10, terminals=1)
    with pytest.raises(ValueError, match="sweep.cycles"):
        TS.TrafficSpec("serving", {"arrival": {}}).factory(
            topo, cycles=None, terminals=1)
    assert TS.TrafficSpec("serving", {"arrival": {"kind": "x"}}).label \
        == "serving"


def test_numpy_serving_study_equals_the_reference():
    """Study(backend="numpy") on a CIN-8 serving grid, record for record,
    with the serving summary."""
    ref = RS.Study(_serving_spec(RS, loads=(0.5, 1.0)), backend="numpy").run()
    port = TS.Study(_serving_spec(TS, loads=(0.5, 1.0)),
                    backend="numpy").run()
    assert [record(r) for r in port.results] == \
        [record(r) for r in ref.results]
    assert port.serving_points() == ref.serving_points()
    assert port.results[0].request_count > 0


def test_torch_serving_study_equals_the_jax_study():
    """Study(backend="torch", device="cpu") against the reference's
    Study(backend="jax") on serving_slo's CIN-16 MMPP experiment, cycles
    cut to 200: every record field."""
    exp = RS.load_specs(RS.bundled_spec_path("serving_slo"))[1]
    exp = exp.with_sweep(cycles=200)
    ref = RS.Study(exp, backend="jax").run()
    port = TS.Study(TS.ExperimentSpec.from_dict(exp.to_dict()),
                    backend="torch", device="cpu").run()
    assert [record(r) for r in port.results] == \
        [record(r) for r in ref.results]
    assert {r.backend for r in port.results} == {"torch"}
    assert port.serving_points() == ref.serving_points()


def test_serving_study_numpy_vs_flow():
    """tests/test_workload.py::test_serving_study_numpy_vs_flow on the
    port (the flow solver on the CPU), and the flow records against the
    reference's flow study."""
    cyc = TS.Study(_serving_spec(TS), backend="numpy").run()
    flow = TS.Study(_serving_spec(TS), backend="flow", device="cpu").run()
    rc = [r for r in cyc.results if r.request_count is not None]
    rf = [r for r in flow.results if r.request_count is not None]
    assert len(rc) == len(rf) == 1
    assert rc[0].request_count == rf[0].request_count > 0
    assert rf[0].request_latency_p99 <= rc[0].request_latency_p99
    assert rc[0].slo_attainment is not None
    assert rc[0].fidelity == "cycle" and rf[0].fidelity == "flow"
    ref = RS.Study(_serving_spec(RS), backend="flow").run()
    a, b = record(ref.results[0]), record(flow.results[0])
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float):
            assert b[k] == pytest.approx(a[k], rel=1e-12, abs=1e-12), k
        else:
            assert b[k] == a[k], k


def test_flow_serving_stats_on_a_degraded_fabric_equals_the_reference():
    """flow.serving_stats directly, on a CIN-8 with a dead switch: pairs
    the failures dropped count as misses, as in repro.flow."""
    from repro import flow as RFl
    from repro import faults as RF
    from repro_torch import flow as TFl
    from repro_torch import faults as TF
    fs = dict(switch_fraction=0.15, seed=2, policy="drop")
    rt = RF.degrade(R.cin_topology("xor", 8), RF.FailureSpec(**fs))
    tt = TF.degrade(T.cin_topology("xor", 8), TF.FailureSpec(**fs))
    kw = dict(terminals=1, cycles=150, warmup=0)
    a = RFl.serving_stats(rt, "minimal", _c2_traffic(RW), **kw)
    b = TFl.serving_stats(tt, "minimal", _c2_traffic(TW), device="cpu", **kw)
    for f in SERVING_FIELDS + ("packets_generated", "offered"):
        assert getattr(b, f) == getattr(a, f), f
    assert b.accepted == pytest.approx(a.accepted, rel=1e-12)


# ---------------------------------------------------------------------------
# (4) Study.slo_capacity.
# ---------------------------------------------------------------------------

SLO_ARGS = dict(percentile=99.0, lo=0.1, hi=1.0, tol=0.2)


def test_numpy_slo_capacity_equals_the_reference():
    """Study(backend="numpy").slo_capacity: probes and capacity exactly
    the reference's (whose probes always run the numpy oracle)."""
    caps = []
    for slo in (40.0, 6.0, 2.0):
        ref = RS.Study(_serving_spec(RS, slo=slo),
                       backend="numpy").slo_capacity(**SLO_ARGS)
        port = TS.Study(_serving_spec(TS, slo=slo),
                        backend="numpy").slo_capacity(**SLO_ARGS)
        assert port == ref
        caps.append((port["capacity"], len(port["probes"])))
    # never saturated, bisected, missed even at lo
    assert caps[0] == (1.0, 2) and caps[1][1] > 2 and caps[2] == (0.0, 1)


def _bisect(attain, lo, hi, tol, target):
    """The reference's bisection rules over given attainments."""
    if attain(lo) < target:
        return 0.0
    if attain(hi) >= target:
        return float(hi)
    good, bad = float(lo), float(hi)
    while bad - good > tol:
        mid = (good + bad) / 2.0
        if attain(mid) >= target:
            good = mid
        else:
            bad = mid
    return round(good, 6)


def test_torch_slo_capacity_probes_equal_simulate_jax():
    """The torch engine's probes (device="cpu"): each attainment equals
    repro.sim.xengine.simulate_jax's at that load and seed, and the
    capacity follows the reference's bisection rules over them."""
    exp = RS.load_specs(RS.bundled_spec_path("serving_slo"))[0]
    exp = exp.with_sweep(cycles=120)
    args = dict(percentile=99.9, lo=0.5, hi=8.0, tol=1.0)
    port = TS.Study(TS.ExperimentSpec.from_dict(exp.to_dict()),
                    device="cpu").slo_capacity(**args)
    topo = R.cin_topology("xor", 16)
    tf = exp.traffic.factory(topo, cycles=120, terminals=1)

    def jax_attain(load):
        st = RX.simulate_jax(topo, "minimal", tf(load, 0), terminals=1,
                             cycles=120, warmup=0, seed=0, drain=True)
        return float(st.slo_attainment or 0.0)
    for load, att in port["probes"]:
        assert att == jax_attain(load), load
    assert len(port["probes"]) >= 3        # the search bisected
    seen = dict(port["probes"])
    assert port["capacity"] == _bisect(lambda x: seen[round(x, 6)],
                                       args["lo"], args["hi"], args["tol"],
                                       args["percentile"] / 100)
    assert 0.5 < port["capacity"] < 8.0


def test_slo_capacity_raises_as_the_reference():
    study = TS.Study(TS.bundled_spec_path("studies_smoke"), backend="numpy")
    with pytest.raises(ValueError, match="pass one of"):
        study.slo_capacity()
    with pytest.raises(ValueError, match="'serving' traffic pattern"):
        study.slo_capacity(study.experiments[0].name)
    serving = TS.Study(_serving_spec(TS), backend="numpy")
    with pytest.raises(ValueError, match="lo <= hi"):
        serving.slo_capacity(lo=2.0, hi=1.0)
    no_slo = dataclasses.replace(_serving_spec(TS), traffic=TS.TrafficSpec(
        "serving", {"arrival": {"kind": "poisson"}}), name="x")
    with pytest.raises(ValueError, match="no params\\['slo'\\]"):
        TS.Study(no_slo).slo_capacity()


# ---------------------------------------------------------------------------
# (5) python -m repro_torch.workload.
# ---------------------------------------------------------------------------

def test_workload_cli_slo_on_the_cpu(capsys):
    exp = TS.load_specs(TS.bundled_spec_path("serving_slo"))[0]
    ref = RS.Study(RS.load_specs(RS.bundled_spec_path("serving_slo"))[0],
                   backend="numpy").slo_capacity(hi=1.0, tol=0.5)
    assert workload_cli(["slo", "serving_slo", "--experiment", exp.name,
                         "--backend", "numpy", "--hi", "1.0", "--tol",
                         "0.5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"experiment: {exp.name}"
    assert out[1] == "slo: p99 <= 30.0 cycles"
    assert out[2:-2] == [f"  probe load={load}: attainment={att}"
                         for load, att in ref["probes"]]
    assert out[-2] == f"capacity: {ref['capacity']}"
    assert out[-1].startswith("graph cache: captures=")


def test_workload_cli_replay_both_engines_on_the_cpu(tmp_path, capsys):
    """replay --backend both on a workload JSON the port's sim/workloads.py
    writes: numpy and torch agree, at the contention-free bound; extract
    --device cpu writes the reference's MoE workload (BENCH
    workload.extract: 14 phases, 896 packets)."""
    w = T.collective_workload(t_make_fabric("xor", 8), "all_to_all",
                              message_size=2)
    path = tmp_path / "a2a8.workload.json"
    path.write_text(json.dumps(w.to_dict()))
    assert workload_cli(["replay", str(path), "--backend", "both",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["numpy: completion=14 ideal=14 ratio=1.000",
                   "torch: completion=14 ideal=14 ratio=1.000",
                   "cross-engine replay agrees exactly"]
    moe8 = tmp_path / "moe8.json"
    assert workload_cli(["extract", "--step", "moe", "--devices", "8",
                         "--bytes-per-packet", "256", "-o", str(moe8),
                         "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"wrote {moe8}: workload 'cin-xor-8-ops', 8 switches, 14 phases, "
        f"896 packets"]
    assert workload_cli(["replay", str(moe8), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "numpy: completion=112 ideal=112 ratio=1.000",
        "torch: completion=112 ideal=112 ratio=1.000",
        "cross-engine replay agrees exactly"]


def test_workload_cli_runs_on_cuda_by_default(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workload_cli(["slo", "serving_slo", "--experiment",
                      "cin-xor-16/serving-poisson-r0.05/minimal"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.Study(_serving_spec(TS), backend="flow").slo_capacity()
    w = T.collective_workload(t_make_fabric("xor", 8), "all_to_all")
    path = tmp_path / "w.json"
    path.write_text(json.dumps(w.to_dict()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workload_cli(["replay", str(path), "--backend", "torch"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workload_cli(["extract", "--step", "moe", "--devices", "8", "-o",
                      str(tmp_path / "never.json")])


# ---------------------------------------------------------------------------
# (7) The graph cache's counters and the cache CLI.
# ---------------------------------------------------------------------------

def test_cache_stats_keys_reset_and_cli(capsys):
    from repro.obs import telemetry as r_telemetry
    assert set(telemetry.cache_stats()) == set(r_telemetry.cache_stats())
    telemetry._STATS["misses"] += 2
    assert telemetry.cache_stats()["misses"] >= 2
    snap = telemetry.cache_stats()
    snap["misses"] = -1                       # a copy, not the counters
    assert telemetry.cache_stats()["misses"] >= 2
    telemetry.reset_cache_stats()
    assert set(telemetry.cache_stats().values()) == {0}
    assert telemetry.cache_dir() is None
    assert telemetry.disk_cache_entries() == []
    assert studies_cli(["cache"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dir:     none") and out[1] == "entries: 0"
    assert out[2] == ("this-process counters: disk_errors=0 disk_hits=0 "
                      "disk_writes=0 evictions=0 memory_hits=0 misses=0")
    telemetry._CACHE["k"] = object()
    assert studies_cli(["cache", "--clear"]) == 0
    assert "cleared" in capsys.readouterr().out
    assert len(telemetry._CACHE) == 0
