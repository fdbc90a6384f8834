"""The port's flow tier (``repro_torch.flow``) against the reference's
(``repro.flow``): the torch core of the max-min solver (on the CPU) within
``rtol=1e-12`` of ``maxmin_rates_numpy`` (the reference's JAX twin is dead
on jax 0.9.0, ROADMAP C1, so the numpy core is the oracle), route tracing
exactly, the flow knees of ``tests/test_flow.py`` equal to the reference's
flow knees, replay estimates, ``simulate``/``Fabric.replay``/``Study`` with
``backend="flow"`` record for record (every field but ``provenance``; both
packages write ``backend="flow"``), ``"auto"`` escalating to the flow tier
at 1024 switches, the CLI's ``--backend flow``, and the card as every
entry point's default.
"""
import os

import numpy as np
import pytest
import torch

from repro import flow as RFl
from repro import sim as R
from repro import studies as RS
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
from repro.fabric import make_fabric as r_make_fabric

from repro_torch import flow as TFl
from repro_torch import sim as T
from repro_torch import studies as TS
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.flow import solver as TSolver
from repro_torch.studies.__main__ import main as cli
from repro_torch.studies.runner import _select_backend

RTOL = 1e-12

#: The solver cases of the reference's tests/test_flow.py:41-74:
#: (demand, link_idx, flow_ptr, capacity, expected rates).
SOLVER_CASES = {
    "single_bottleneck": ([1.0, 1.0], [0, 0], [0, 1, 2], [1.0], [0.5, 0.5]),
    "demand_frozen": ([0.2, 1.0], [0, 0], [0, 1, 2], [1.0], [0.2, 0.8]),
    "classic_chain": ([1.0, 1.0, 1.0], [0, 1, 0, 1], [0, 2, 3, 4],
                      [1.0, 1.0], [0.5, 0.5, 0.5]),
    "per_link_capacity": ([1.0], [0], [0, 1], [0.55], [0.55]),
}

CIN16 = (lambda: R.cin_topology("xor", 16), lambda: T.cin_topology("xor", 16))
DF72 = (lambda: R.dragonfly_topology(R_Dragonfly(6, 3, 2, 12)),
        lambda: T.dragonfly_topology(T_Dragonfly(6, 3, 2, 12)))


def fields(result, drop=("provenance",)):
    return {k: v for k, v in result.record().items() if k not in drop}


def assert_same_records(ref, port):
    assert [r.key for r in port] == [r.key for r in ref]
    for a, b in zip(ref, port):
        assert fields(b) == fields(a), a.key


def to_record(stats):
    return T.to_record(stats) | {"timing": None}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_torch_core_on_the_reference_solver_cases(case):
    """maxmin_rates_torch(device="cpu") against repro.flow's
    maxmin_rates_numpy and the closed-form rates."""
    demand, idx, ptr, cap, want = (np.asarray(a) for a in SOLVER_CASES[case])
    ref = RFl.maxmin_rates_numpy(demand, idx, ptr, cap)
    got = TFl.maxmin_rates(demand, idx, ptr, cap, solver="torch",
                           device="cpu")
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(TFl.maxmin_rates_numpy(demand, idx, ptr, cap), ref)


@pytest.mark.parametrize("routing", ["minimal", "valiant", "adaptive"])
def test_torch_core_on_a_real_problem(routing):
    """The reference's real problem (CIN-16 hotspot 0.9, load 0.4, 12
    terminals): repro.flow.maxmin_rates_numpy on the port's problem and
    the reference's solve_flows rates, within rtol 1e-12."""
    topo = T.cin_topology("xor", 16)
    params = TFl.FlowParams()
    src, dst, rate = TFl.pattern_demands(topo, "hotspot", 0.4, 12, params,
                                         {"hot_fraction": 0.9})
    sol = TFl.solve_flows(topo, routing, src, dst, rate, params=params,
                          device="cpu")
    p = sol.problem
    oracle = RFl.maxmin_rates_numpy(p.demand, p.link_ids, p.flow_ptr,
                                    sol.capacity)
    np.testing.assert_allclose(sol.rates, oracle, rtol=RTOL, atol=0)
    ref = RFl.solve_flows(R.cin_topology("xor", 16), routing, src, dst,
                          rate, params=RFl.FlowParams())
    assert np.array_equal(p.link_ids, ref.problem.link_ids)
    assert np.array_equal(sol.capacity, ref.capacity)
    np.testing.assert_allclose(sol.rates, ref.rates, rtol=RTOL, atol=0)
    rates, iters = TSolver._torch_core(
        *TSolver.upload_problem(p.demand, p.link_ids, p.flow_ptr,
                                sol.capacity, "cpu"), 256)
    assert 0 < iters < 256
    assert sol.bottleneck_links() == ref.bottleneck_links()


@pytest.mark.parametrize("topo", [
    (lambda: R.cin_topology("xor", 16), lambda: T.cin_topology("xor", 16)),
    (lambda: R.hyperx_topology(R_HyperX(dims=(4, 4), terminals=2)),
     lambda: T.hyperx_topology(T_HyperX(dims=(4, 4), terminals=2))),
    (lambda: R.dragonfly_topology(R_Dragonfly(4, 2, 2, 8)),
     lambda: T.dragonfly_topology(T_Dragonfly(4, 2, 2, 8)))],
    ids=["cin16", "hyperx4x4", "dragonfly32"])
def test_trace_routes_equal_the_reference(topo):
    """repro.flow.trace_routes on all pairs, and trace_routes_via on
    random mids."""
    ra, tb = topo[0](), topo[1]()
    n = ra.num_switches
    src = np.repeat(np.arange(n), n - 1)
    k = np.tile(np.arange(n - 1), n)
    dst = k + (k >= src)
    for x, y in zip(TFl.trace_routes(tb, src, dst),
                    RFl.trace_routes(ra, src, dst)):
        assert np.array_equal(x, y)
    mid = np.random.default_rng(1).integers(0, n, src.size)
    for x, y in zip(TFl.trace_routes_via(tb, src, mid, dst),
                    RFl.trace_routes_via(ra, src, mid, dst)):
        assert np.array_equal(x, y)


def _flow_knee(flow, topo, routing, pattern, terminals, loads, tp=None,
               **kw):
    """tests/test_flow.py's knee: the first load whose delivered rate falls
    below 95% of offered."""
    params = flow.FlowParams()
    for load in loads:
        src, dst, rate = flow.pattern_demands(topo, pattern, load, terminals,
                                              params, tp)
        sol = flow.solve_flows(topo, routing, src, dst, rate, params=params,
                               **kw)
        if sol.delivered_rate / (topo.num_switches * terminals) \
                < 0.95 * load:
            return load
    return None


@pytest.mark.parametrize("case", [
    (CIN16, "minimal", "uniform", 12, (0.3, 0.5, 0.7, 0.9), None, 0.9),
    (CIN16, "valiant", "uniform", 12, (0.3, 0.5, 0.7, 0.9), None, 0.5),
    (CIN16, "adaptive", "uniform", 12, (0.3, 0.5, 0.7, 0.9), None, 0.9),
    (CIN16, "minimal", "hotspot", 12, (0.05, 0.2, 0.4, 0.6),
     {"hot_fraction": 0.9}, 0.2),
    (CIN16, "valiant", "hotspot", 12, (0.05, 0.2, 0.4, 0.6),
     {"hot_fraction": 0.9}, 0.6),
    (CIN16, "adaptive", "hotspot", 12, (0.05, 0.2, 0.4, 0.6),
     {"hot_fraction": 0.9}, 0.6),
    (DF72, "minimal", "uniform", 3, (0.1, 0.2, 0.3, 0.4), None, None),
    (DF72, "valiant", "uniform", 3, (0.1, 0.2, 0.3, 0.4), None, 0.4)],
    ids=lambda c: f"{c[1]}-{c[2]}-{c[3]}")
def test_knees_equal_the_reference_flow_knees(case):
    """tests/test_flow.py:156-175's CIN-16 and Dragonfly-72 knees: the
    port's (torch core, CPU) equal the reference's and the oracle's."""
    topo, routing, pattern, terms, loads, tp, oracle = case
    ref = _flow_knee(RFl, topo[0](), routing, pattern, terms, loads, tp)
    port = _flow_knee(TFl, topo[1](), routing, pattern, terms, loads, tp,
                      device="cpu")
    assert port == ref == oracle


def test_saturation_load_and_replay_estimates_equal_the_reference():
    """repro.flow.saturation_load by bisection, and replay_estimate /
    Fabric.replay(backend="flow") on the CIN-16 and Dragonfly-72
    all-to-all schedules (30 = 30, 142 against 32)."""
    kw = dict(routing="minimal", pattern="uniform", terminals=12, tol=0.01)
    assert TFl.saturation_load(CIN16[1](), device="cpu", **kw) == \
        RFl.saturation_load(CIN16[0](), **kw)
    for cfg, want in (("xor", (30, 30)),
                      ((6, 3, 2, 12), (142, 32))):
        ra = r_make_fabric(cfg if isinstance(cfg, str) else
                           R_Dragonfly(*cfg), 16 if cfg == "xor" else None)
        tb = t_make_fabric(cfg if isinstance(cfg, str) else
                           T_Dragonfly(*cfg), 16 if cfg == "xor" else None)
        a = ra.replay("all_to_all", message_size=2, backend="flow")
        b = tb.replay("all_to_all", message_size=2, backend="flow",
                      device="cpu")
        assert to_record(b) == R.to_record(a) | {"timing": None}
        assert (b.completion_cycles, b.ideal_cycles) == want


def test_simulate_flow_equals_the_reference():
    """simulate(backend="flow") on generated traffic (the empirical demand
    matrix) and on a degraded fabric (demands filtered)."""
    for failures in (None, {"link_fraction": 0.05, "seed": 3}):
        kw = dict(offered=0.9, cycles=400, terminals=12, seed=1)
        a = R.simulate(CIN16[0](), R.MinimalPolicy(), R.uniform(16, **kw),
                       backend="flow", failures=failures)
        b = T.simulate(CIN16[1](), T.MinimalPolicy(), T.uniform(16, **kw),
                       backend="flow", failures=failures, device="cpu")
        assert to_record(b) == R.to_record(a) | {"timing": None}
        assert b.saturated


def _flow_spec(**kw):
    return {"fabric": {"kind": "cin", "params": {"instance": "xor",
                                                 "n": 16}},
            "traffic": {"pattern": kw.pop("pattern", "uniform"),
                        "params": kw.pop("traffic_params", {})},
            "routing": {"policy": kw.pop("policy", "minimal")},
            "sweep": {"loads": list(kw.pop("loads", (0.3, 0.9))),
                      "seeds": [0], "cycles": 200, "warmup": 50},
            "terminals": 12, **kw}


def test_flow_study_records_equal_the_reference(tmp_path):
    """Study(backend="flow", device="cpu") against the reference's: the
    uniform and hotspot CIN-16 grids (minimal, valiant), a degraded one,
    and the CIN-16 replay; records carry fidelity="flow" and resume in
    either package."""
    specs = [_flow_spec(name="uniform/minimal"),
             _flow_spec(name="uniform/valiant", policy="valiant"),
             _flow_spec(name="hotspot/adaptive", pattern="hotspot",
                        policy="adaptive",
                        traffic_params={"hot_fraction": 0.9}),
             _flow_spec(name="degraded",
                        failures={"link_fraction": 0.05, "seed": 3}),
             {"fabric": {"kind": "cin", "params": {"instance": "xor",
                                                   "n": 16}},
              "traffic": {"pattern": "workload",
                          "params": {"collective": "all_to_all",
                                     "message_size": 2}},
              "routing": {"policy": "minimal"},
              "sweep": {"loads": [0.0], "seeds": [0]}, "name": "replay"}]
    store = str(tmp_path / "flow.jsonl")
    ref = RS.Study([RS.ExperimentSpec.from_dict(s) for s in specs],
                   backend="flow").run()
    port = TS.Study([TS.ExperimentSpec.from_dict(s) for s in specs],
                    store=store, backend="flow", device="cpu").run()
    assert_same_records(ref.results, port.results)
    assert port.backend == "flow"
    assert {r.fidelity for r in port.results} == {"flow"}
    assert {r.provenance["timings"]["backend"] for r in port.results} == \
        {"flow"}
    assert port.saturation_points(fidelity="flow") == \
        ref.saturation_points(fidelity="flow")
    back = RS.Study([RS.ExperimentSpec.from_dict(s) for s in specs],
                    store=store, backend="flow").run()
    assert (back.executed, back.restored) == (0, len(port.results))


def test_auto_escalates_to_flow_at_1024_switches():
    """_select_backend: "auto" is the torch engine below FLOW_AUTO_SWITCHES
    and the flow model at and above it, as the reference's is; the bundled
    flow_scale_smoke (HyperX 64x64, 4096 switches) runs there with records
    equal to the reference's "auto"."""
    assert TS.FLOW_AUTO_SWITCHES == RS.FLOW_AUTO_SWITCHES == 1024
    assert _select_backend("auto", num_switches=1023) == "torch"
    assert _select_backend("auto", num_switches=1024) == "flow"
    assert _select_backend(None, num_switches=4096) == "flow"
    assert _select_backend("flow", num_switches=4) == "flow"
    ref = RS.Study(RS.bundled_spec_path("flow_scale_smoke"),
                   backend="auto").run()
    port = TS.Study(TS.bundled_spec_path("flow_scale_smoke"),
                    backend="auto", device="cpu").run()
    assert port.backend == ref.backend == "flow"
    assert_same_records(ref.results, port.results)


def test_cli_run_backend_flow(tmp_path, capsys):
    spec_path = os.fspath(tmp_path / "spec.json")
    TS.dump_specs([TS.ExperimentSpec.from_dict(_flow_spec())], spec_path)
    store = os.fspath(tmp_path / "out.jsonl")
    assert cli(["run", spec_path, "--backend", "flow", "--device", "cpu",
                "--store", store]) == 0
    out = capsys.readouterr().out
    assert "backend=flow" in out and "saturation points:" in out
    records = TS.JsonlStore(store).load()
    assert len(records) == 2
    assert all(r.fidelity == "flow" for r in records.values())


def test_flow_entry_points_default_to_the_card(monkeypatch):
    """maxmin_rates(solver="auto"), solve_flows, simulate(backend="flow"),
    Fabric.replay(backend="flow"), Study(backend="flow") and
    serving_stats run on cuda by
    default and raise without it; nothing falls back to the numpy core,
    which runs only as solver="numpy"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    demand, idx, ptr, cap, want = SOLVER_CASES["classic_chain"]
    for solver in ("auto", "torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TFl.maxmin_rates(demand, idx, ptr, cap, solver=solver)
    np.testing.assert_allclose(
        TFl.maxmin_rates(demand, idx, ptr, cap, solver="numpy"), want)
    with pytest.raises(ValueError, match="unknown flow solver"):
        TFl.maxmin_rates(demand, idx, ptr, cap, solver="jax")
    topo = T.cin_topology("xor", 8)
    tr = T.uniform(8, offered=0.5, cycles=20, terminals=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.simulate(topo, T.MinimalPolicy(), tr, backend="flow")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_fabric("xor", 8).replay(backend="flow")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.Study([TS.ExperimentSpec.from_dict(_flow_spec())],
                 backend="flow").run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TFl.serving_stats(topo, "minimal", tr, terminals=2, cycles=20)
