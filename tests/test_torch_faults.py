"""The port's fault layer (``repro_torch.faults``) and degraded fabrics on
the torch cycle engine, against the reference (``repro.faults``,
``repro.sim.xengine``): ``FailureSpec`` JSON and digests, the residual
graph (``bfs_distances``, ``residual_report``), the fallback next-hop
tables (``build_fallback_table``, ``degrade``), the masks
(``packet_keep``, ``filter_pairs``, ``mask_traffic``, ``mask_workload``),
degraded sweeps of the torch engine on the CPU bit for bit against
``repro.sim.xengine.sweep(bucket=False)`` under minimal, Valiant and
adaptive routing, and ``Study`` with failures record for record.  Tables
and integer outputs are held exactly; records on every field but
``backend`` (``"jax"`` against ``"torch"``) and ``provenance``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.faults as RF
from repro import sim as R
from repro import studies as RS
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
from repro.fabric import make_fabric as r_make_fabric
from repro.obs.export import link_classes as r_link_classes
from repro.sim import xengine as RX
from repro.sim.workloads import collective_workload as r_workload

import repro_torch.faults as TF
from repro_torch import sim as T
from repro_torch import studies as TS
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX
from repro_torch.fabric import make_fabric as t_make_fabric
from repro_torch.obs.export import link_classes as t_link_classes
from repro_torch.sim.workloads import collective_workload as t_workload
from repro_torch.studies.runner import _select_backend

#: The three bundled families at the sizes ``failure_sweep`` degrades.
FABRICS = {
    "cin16": (lambda: R.cin_topology("xor", 16),
              lambda: T.cin_topology("xor", 16)),
    "hyperx256": (
        lambda: R.hyperx_topology(R_HyperX(dims=(16, 16), terminals=8)),
        lambda: T.hyperx_topology(T_HyperX(dims=(16, 16), terminals=8))),
    "dragonfly72": (
        lambda: R.dragonfly_topology(R_Dragonfly(6, 3, 2, 12)),
        lambda: T.dragonfly_topology(T_Dragonfly(6, 3, 2, 12))),
}
FAILURES = {
    "links5": {"link_fraction": 0.05, "seed": 3},
    "links10": {"link_fraction": 0.1, "seed": 3},
    "switch": {"dead_switches": [5], "policy": "drop"},
}
ISOLATE_0 = [[0, j] for j in range(1, 16)]


def fields(result, drop=("backend", "provenance")):
    return {k: v for k, v in result.record().items() if k not in drop}


def assert_same_records(ref, port):
    assert [r.key for r in port] == [r.key for r in ref]
    for a, b in zip(ref, port):
        assert fields(b) == fields(a), a.key


def assert_same_stats(a, b):
    for f in dataclasses.fields(a):
        if f.name in ("timing", "trace"):
            continue
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f.name


@pytest.mark.parametrize("failures", [
    FAILURES["links5"], FAILURES["switch"],
    {"link_fraction": 0.05, "switch_fraction": 0.02, "seed": 4,
     "dead_links": [[2, 1], [1, 2], [0, 3]], "dead_switches": [9, 4],
     "policy": "drop"},
    {"link_fraction": 0.0}])
def test_failure_spec_json_label_and_digest_equal_the_reference(failures):
    """repro.faults.FailureSpec: canonical JSON, label, is_null; an
    ExperimentSpec carrying it has the reference's JSON and digest (a
    null spec the pristine experiment's)."""
    a, b = RF.FailureSpec.from_dict(failures), TF.FailureSpec.from_dict(
        failures)
    assert b.to_json() == a.to_json()
    assert (b.label, b.is_null) == (a.label, a.is_null)
    assert TF.FailureSpec.from_json(b.to_json()) == b
    exp = {"fabric": {"kind": "cin", "params": {"instance": "xor", "n": 16}},
           "traffic": {"pattern": "uniform", "params": {"seed": 21}},
           "routing": {"policy": "minimal"},
           "sweep": {"loads": [0.3], "seeds": [23], "cycles": 160,
                     "warmup": 40},
           "terminals": 2, "name": "deg", "failures": failures}
    ea, eb = (RS.ExperimentSpec.from_dict(exp),
              TS.ExperimentSpec.from_dict(exp))
    assert eb.to_json() == ea.to_json() and eb.digest() == ea.digest()
    assert eb.describe() == ea.describe()
    assert TS.ExperimentSpec.from_json(eb.to_json()) == eb
    with pytest.raises(ValueError, match="policy"):
        TF.FailureSpec(policy="ignore")


@pytest.mark.parametrize("failures", sorted(FAILURES))
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_residual_graph_and_fallback_tables_equal(fabric, failures):
    """repro.faults: residual_report, bfs_distances over the masked graph,
    build_fallback_table and degrade (the fallback table, the masked
    wiring, the re-derived diameter and the meta["faults"] block)."""
    ref_topo, port_topo = (make() for make in FABRICS[fabric])
    spec = FAILURES[failures]
    ra, rb = (RF.residual_report(ref_topo, spec),
              TF.residual_report(port_topo, spec))
    assert rb.keys() == ra.keys()
    for k in ra:
        assert np.array_equal(rb[k], ra[k]), k
    a, b = RF.degrade(ref_topo, spec), TF.degrade(port_topo, spec)
    assert (b.name, b.diameter) == (a.name, a.diameter)
    for k in ("neighbor", "rev_port"):
        assert np.array_equal(getattr(b, k), getattr(a, k)), k
    assert np.array_equal(b.minimal_port_table(), a.minimal_port_table())
    # the degraded copy carries its own table, never the pristine one
    assert b.minimal_port_table() is not port_topo.minimal_port_table()
    fa, fb = a.meta["faults"], b.meta["faults"]
    assert fb.keys() == fa.keys()
    for k in fa:
        if k == "spec":
            assert fb[k].to_json() == fa[k].to_json()
        else:
            assert np.array_equal(fb[k], fa[k]), k
    assert np.array_equal(TF.bfs_distances(b.neighbor),
                          RF.bfs_distances(a.neighbor))
    dead = fa["dead_links"]
    assert np.array_equal(TF.build_fallback_table(port_topo, dead=dead),
                          RF.build_fallback_table(ref_topo, dead=dead))
    assert TF.degrade(port_topo, spec) is b           # memoized
    assert port_topo.degrade(None) is port_topo
    for cls, mask in r_link_classes(a).items():
        assert np.array_equal(t_link_classes(b)[cls], mask), cls


def test_strict_disconnection_and_degraded_twice_raise():
    topo = T.cin_topology("xor", 16)
    with pytest.raises(TF.FabricDisconnectedError, match="2 components"):
        topo.degrade({"dead_links": ISOLATE_0})
    topo2 = topo.degrade({"link_fraction": 0.05, "seed": 3})
    with pytest.raises(ValueError, match="already degraded"):
        topo2.degrade({"link_fraction": 0.01})


@pytest.mark.parametrize("policy", ["minimal", "valiant", "adaptive"])
def test_degraded_sweep_is_bit_identical_to_xengine(policy):
    """repro.sim.xengine.sweep(bucket=False) on CIN-16 at 10% link failure
    (the pairs whose wire died reroute over the fallback table), 2 loads
    x 2 seeds: every RunStats field."""
    spec = FAILURES["links10"]
    ref_topo = RF.degrade(R.cin_topology("xor", 16), spec)
    port_topo = TF.degrade(T.cin_topology("xor", 16), spec)

    def tf(mod):
        return lambda load, seed: mod.uniform(16, offered=load, cycles=60,
                                              terminals=2, seed=seed)
    a = RX.sweep(ref_topo, policy, tf(R), [0.4, 0.8], seeds=(1, 2),
                 cycles=60, warmup=15, bucket=False)
    b = T.sweep(port_topo, policy, tf(T), [0.4, 0.8], seeds=(1, 2),
                cycles=60, warmup=15, device="cpu")
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert_same_stats(x, y)
    assert b[0][0].topology == "cin-xor-16+L0.1-s3"


def test_dead_switch_collapses_valiant_mids_as_xengine_does():
    """repro.sim.xengine.sweep on a Dragonfly-72 whose switch 5 is dead
    (comp -1): Valiant mids that land on it collapse to the destination,
    and the drained run delivers every surviving packet."""
    spec = FAILURES["switch"]
    ref_topo = RF.degrade(R.dragonfly_topology(R_Dragonfly(6, 3, 2, 12)),
                          spec)
    port_topo = TF.degrade(T.dragonfly_topology(T_Dragonfly(6, 3, 2, 12)),
                           spec)

    def tf(mod, topo, faults):
        return lambda load, seed: faults.mask_traffic(mod.uniform(
            72, offered=load, cycles=40, terminals=3, seed=seed), topo)
    a = RX.sweep(ref_topo, "valiant", tf(R, ref_topo, RF), [0.3],
                 seeds=(4,), cycles=40, warmup=10, drain=True, bucket=False)
    b = T.sweep(port_topo, "valiant", tf(T, port_topo, TF), [0.3],
                seeds=(4,), cycles=40, warmup=10, drain=True, device="cpu")
    assert_same_stats(a[0][0], b[0][0])
    assert b[0][0].packets_delivered == b[0][0].packets_generated > 0


def test_masks_equal_the_reference():
    """packet_keep, filter_pairs, mask_traffic (open loop and replays) and
    mask_workload on a CIN-16 with a dead switch and a cut-off switch."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 16, 200), rng.integers(0, 16, 200)
    rate = rng.random(200)
    ra_fab, tb_fab = r_make_fabric("xor", 16), t_make_fabric("xor", 16)
    for spec in (FAILURES["switch"], {"dead_links": ISOLATE_0,
                                      "policy": "drop"}):
        a = RF.degrade(ra_fab.sim_topology(), spec)
        b = TF.degrade(tb_fab.sim_topology(), spec)
        assert np.array_equal(TF.packet_keep(b, src, dst),
                              RF.packet_keep(a, src, dst))
        for x, y in zip(TF.filter_pairs(b, src, dst, rate),
                        RF.filter_pairs(a, src, dst, rate)):
            assert np.array_equal(x, y)
        tr_a = RF.mask_traffic(R.uniform(16, offered=0.3, cycles=50,
                                         terminals=2, seed=1), a)
        tr_b = TF.mask_traffic(T.uniform(16, offered=0.3, cycles=50,
                                         terminals=2, seed=1), b)
        for k in ("src", "dst", "gen"):
            assert np.array_equal(getattr(tr_b, k), getattr(tr_a, k)), k
        wa = RF.mask_workload(r_workload(ra_fab, "all_to_all"), a)
        wb = TF.mask_workload(t_workload(tb_fab, "all_to_all"), b)
        assert wb.to_dict() == wa.to_dict()
        assert wb.ideal_cycles == wa.ideal_cycles
        assert np.array_equal(TF.mask_traffic(
            t_workload(tb_fab, "all_to_all").traffic(), b).src,
            RF.mask_traffic(r_workload(ra_fab, "all_to_all").traffic(),
                            a).src)
    pristine = tb_fab.sim_topology()
    w = t_workload(tb_fab, "all_to_all")
    assert TF.mask_workload(w, pristine) is w


def test_degraded_replay_and_simulate_equal_the_reference():
    """Fabric.replay(failures=) and simulate(failures=) on the torch engine
    (CPU) against the reference's jax engine: the replay reroutes and
    misses its bound, no packet crosses a dead link, and a dead switch's
    traffic is dropped."""
    spec = {"link_fraction": 0.08, "seed": 3}
    a = r_make_fabric("xor", 16).replay("all_to_all", failures=spec,
                                        backend="jax")
    b = t_make_fabric("xor", 16).replay("all_to_all", failures=spec,
                                        device="cpu")
    assert_same_stats(a, b)
    assert b.completion_cycles > b.ideal_cycles
    dead = TF.degrade(T.cin_topology("xor", 16), spec).meta["faults"][
        "dead_links"].reshape(-1)
    assert np.asarray(b.link_loads)[dead].sum() == 0
    kw = dict(offered=0.2, cycles=120, terminals=2, seed=5)
    failures = {"dead_switches": [3], "policy": "drop"}
    sa = R.simulate(R.cin_topology("xor", 16), R.MinimalPolicy(),
                    R.uniform(16, **kw), cycles=120, warmup=0,
                    failures=failures, backend="jax")
    sb = T.simulate(T.cin_topology("xor", 16), T.MinimalPolicy(),
                    T.uniform(16, **kw), cycles=120, warmup=0,
                    failures=failures, device="cpu")
    assert_same_stats(sa, sb)
    assert sb.topology == "cin-xor-16+ds1-drop"


def test_failure_grid_equals_the_reference():
    base = {"fabric": {"kind": "cin", "params": {"instance": "xor", "n": 8}},
            "traffic": {"pattern": "uniform"}, "routing": {"policy":
                                                           "minimal"},
            "sweep": {"loads": [0.3]}, "name": "base"}
    a = RF.failure_grid(RS.ExperimentSpec.from_dict(base), [0.0, 0.05],
                        seeds=(0, 1))
    b = TF.failure_grid(TS.ExperimentSpec.from_dict(base), [0.0, 0.05],
                        seeds=(0, 1))
    assert [e.to_json() for e in b] == [e.to_json() for e in a]
    assert [e.name for e in b] == ["base/f0", "base/L0.05-s0",
                                   "base/L0.05-s1"]


def _deg_spec(**kw):
    return {"fabric": {"kind": "cin", "params": {"instance": "xor", "n": 8}},
            "traffic": {"pattern": "uniform", "params": {"seed": 21}},
            "routing": {"policy": kw.pop("policy", "minimal")},
            "sweep": {"loads": [0.3, 0.6], "seeds": [23], "cycles": 80,
                      "warmup": 20},
            "terminals": 2, **kw}


def test_study_with_failures_equals_the_reference_and_resumes(tmp_path):
    """Study(backend="torch", device="cpu") against Study(backend="jax")
    on CIN-8 at 10% link failure (minimal and adaptive) and on its f0
    point: every record; f0 records equal the pristine experiment's; a
    store the port writes resumes in the reference and back."""
    specs = [_deg_spec(name="f0", failures={"link_fraction": 0.0}),
             _deg_spec(name="minimal/f0.1", failures=FAILURES["links10"]),
             _deg_spec(name="adaptive/f0.1", policy="adaptive",
                       failures=FAILURES["links10"])]
    ref = RS.Study([RS.ExperimentSpec.from_dict(s) for s in specs],
                   backend="jax").run()
    port = TS.Study([TS.ExperimentSpec.from_dict(s) for s in specs],
                    backend="torch", device="cpu").run()
    assert_same_records(ref.results, port.results)
    assert port.saturation_points() == ref.saturation_points()
    pristine = TS.Study([TS.ExperimentSpec.from_dict(_deg_spec(name="f0"))],
                        backend="torch", device="cpu").run()
    assert_same_records(pristine.results, port.results[:2])

    store = str(tmp_path / "deg.jsonl")
    exp = [TS.ExperimentSpec.from_dict(specs[1])]
    first = TS.Study(exp, store=store, backend="numpy").run()
    assert first.executed == 2
    back = RS.Study([RS.ExperimentSpec.from_dict(specs[1])], store=store,
                    backend="numpy").run()
    assert (back.executed, back.restored) == (0, 2)
    again = TS.Study(exp, store=store, backend="numpy").run()
    assert (again.executed, again.restored) == (0, 2)
    edited = [TS.ExperimentSpec.from_dict(
        _deg_spec(name="minimal/f0.1",
                  failures={"link_fraction": 0.1, "seed": 4}))]
    with pytest.raises(ValueError, match="different version"):
        TS.Study(edited, store=store, backend="numpy").run()


def test_study_names_the_experiment_a_disconnection_breaks():
    """The strict policy's error names the experiment, on a cycle backend
    at degrade time and on the flow backend before it traces a replay."""
    rep = TS.ExperimentSpec.from_dict({
        "fabric": {"kind": "cin", "params": {"instance": "xor", "n": 16}},
        "traffic": {"pattern": "workload",
                    "params": {"collective": "all_to_all"}},
        "routing": {"policy": "minimal"}, "name": "replay-strict",
        "failures": {"dead_links": ISOLATE_0}})
    with pytest.raises(ValueError, match="replay-strict.*drop"):
        _select_backend("flow", experiment=rep)
    assert _select_backend("flow", experiment=dataclasses.replace(
        rep, failures=TF.FailureSpec(dead_links=ISOLATE_0,
                                     policy="drop"))) == "flow"
    with pytest.raises(TF.FabricDisconnectedError, match="replay-strict"):
        TS.Study([rep], backend="numpy").run()


def test_degraded_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fab = t_make_fabric("xor", 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fab.replay(failures={"link_fraction": 0.1, "seed": 1})
    spec = TS.ExperimentSpec.from_dict(_deg_spec(
        failures=FAILURES["links10"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.Study([spec]).run()
    assert json.loads(spec.to_json())["failures"]["link_fraction"] == 0.1
