"""The port's studies path (``repro_torch.studies``: specs, the JSONL store,
the ``Study`` runner, the CLI, and the deprecated shims of
``repro_torch.sim.report`` / ``Fabric.sim_sweep``) against the reference's
(``repro.studies``): bundled spec files byte for byte, spec keys, digests
and JSON, ``Study(backend="numpy")`` record for record, and the torch
engine on the CPU against ``Study(backend="jax")`` bit for bit, resume
included.  Records are compared on every field but ``backend`` (``"jax"``
against ``"torch"``) and ``provenance`` (host, versions, timings).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro import studies as RS
from repro.sim import report as R_report
from repro.studies.store import JsonlStore as R_Store
from repro.studies.store import Result as R_Result

from repro_torch import sim as T
from repro_torch import studies as TS
from repro_torch.fabric import LacinDeprecationWarning, make_fabric
from repro_torch.studies.__main__ import main as cli
from repro_torch.studies.store import JsonlStore as T_Store
from repro_torch.studies.store import Result as T_Result

LOADABLE = sorted(TS.bundled_specs())


def fields(result, drop=("backend", "provenance")):
    return {k: v for k, v in result.record().items() if k not in drop}


def assert_same_results(ref, port):
    assert [r.key for r in port.results] == [r.key for r in ref.results]
    for a, b in zip(ref.results, port.results):
        assert fields(b) == fields(a), a.key


def cin16_replays():
    """The CIN-16 arms (minimal, adaptive) of the bundled collective_replay."""
    return [e for e in json.load(open(TS.bundled_spec_path(
        "collective_replay")))["experiments"]
        if e["fabric"]["kind"] == "cin"]


def test_bundled_spec_files_are_the_reference_bytes():
    assert sorted(TS.bundled_specs()) == sorted(RS.bundled_specs())
    for name, path in RS.bundled_specs().items():
        with open(path, "rb") as a, open(TS.bundled_spec_path(name),
                                         "rb") as b:
            assert b.read() == a.read(), name
        assert os.path.dirname(TS.bundled_spec_path(name)) != \
            os.path.dirname(path)


@pytest.mark.parametrize("name", LOADABLE)
def test_spec_keys_digests_and_json_equal(name):
    """repro.studies.spec: ExperimentSpec.key, digest and to_json, and the
    exact JSON round-trip, for every bundled spec the port loads."""
    ref = RS.load_specs(RS.bundled_spec_path(name))
    port = TS.load_specs(TS.resolve_spec_source(name))
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert b.name == a.name and b.digest() == a.digest()
        assert [b.key(*p) for p in b.points()] == \
            [a.key(*p) for p in a.points()]
        assert b.to_json() == a.to_json()
        assert TS.ExperimentSpec.from_json(b.to_json()) == b
        assert b.describe() == a.describe()


def test_serving_slo_builds_the_reference_traffic():
    """serving_slo, which needed repro_torch.workload: each experiment's
    traffic factory gives the reference's packets, requests and SLO."""
    ref = RS.Study(RS.bundled_spec_path("serving_slo"), backend="numpy")
    port = TS.Study(TS.bundled_spec_path("serving_slo"), backend="numpy")
    for a, b in zip(ref.experiments, port.experiments):
        ta = ref._resolve(a)[1](0.5, 7)
        tb = port._resolve(b)[1](0.5, 7)
        for f in ("src", "dst", "gen", "request"):
            assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
        assert (tb.name, tb.slo, tb.offered, tb.terminals) == \
            (ta.name, ta.slo, ta.offered, ta.terminals)
        assert tb.request.size > 0


def test_numpy_study_equals_the_reference():
    """Study(backend="numpy") on studies_smoke, record for record."""
    path = TS.bundled_spec_path("studies_smoke")
    ref = RS.Study(RS.bundled_spec_path("studies_smoke"),
                   backend="numpy").run()
    port = TS.Study(path, backend="numpy").run()
    assert_same_results(ref, port)
    assert port.backend == "numpy"
    assert port.saturation_points() == ref.saturation_points()


def test_torch_study_is_bit_identical_to_the_jax_study():
    """Study(backend="torch", device="cpu") against the reference's
    Study(backend="jax") on studies_smoke and on the CIN-16 replays of
    collective_replay: every record field, replays included."""
    specs = (RS.load_specs(RS.bundled_spec_path("studies_smoke"))
             + RS.load_specs(cin16_replays()))
    ref = RS.Study(specs, backend="jax").run()
    port = TS.Study([TS.ExperimentSpec.from_dict(e.to_dict())
                     for e in specs], backend="torch", device="cpu").run()
    assert_same_results(ref, port)
    assert {r.backend for r in port.results} == {"torch"}
    assert port.replay_points() == ref.replay_points()
    assert [p["measured"] for p in port.replay_points().values()] == [30, 30]
    prov = port.results[0].provenance
    assert set(prov) == (set(ref.results[0].provenance) - {"jax"}
                         | {"torch", "cuda", "device"})
    assert prov["torch"] == torch.__version__


def test_store_round_trips_through_both_packages_and_resumes(tmp_path):
    """A store the port writes reads back through the reference's Result
    (and the other way), every field kept; a second run executes nothing;
    a resume of missing points equals the reference's resume."""
    spec = TS.load_specs(TS.bundled_spec_path("studies_smoke"))
    store = str(tmp_path / "port.jsonl")
    full = TS.Study(spec, store=store, backend="torch", device="cpu").run()
    assert full.executed == 4
    for key, rec in R_Store(store).load().items():
        port_rec = T_Store(store).load()[key]
        assert rec.record() == port_rec.record()
        assert T_Result.from_record(rec.record()).record() == rec.record()
    again = TS.Study(spec, store=store, backend="torch", device="cpu").run()
    assert (again.executed, again.restored) == (0, 4)

    # Keep the first record of each experiment; both packages resume the
    # three missing points from copies of that store.
    with open(store) as f:
        lines = f.read().splitlines()
    stores = {}
    for who in ("ref", "port"):
        stores[who] = str(tmp_path / f"{who}.jsonl")
        with open(stores[who], "w") as f:
            f.write(lines[0] + "\n" + lines[2] + "\n")
    ref = RS.Study(RS.bundled_spec_path("studies_smoke"),
                   store=stores["ref"], backend="jax").run()
    port = TS.Study(spec, store=stores["port"], backend="torch",
                    device="cpu").run()
    assert (port.executed, port.restored) == (ref.executed, ref.restored) \
        == (2, 2)
    assert_same_results(ref, port)
    # A record the reference wrote, with a field the port does not know,
    # keeps it through the port's store.
    rec = R_Store(stores["ref"]).load()
    extra = dict(next(iter(rec.values())).record(), newer_field=[1, 2])
    back = T_Result.from_record(extra)
    assert back.extra == {"newer_field": [1, 2]}
    assert R_Result.from_record(back.record()).record() == extra


def test_auto_and_torch_raise_without_cuda(monkeypatch):
    """The study's default device is cuda: "auto" resolves to the torch
    engine there and raises where CUDA is absent, never running the
    oracle; so do the deprecated shims."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = TS.bundled_spec_path("studies_smoke")
    for backend in (None, "auto", "torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TS.Study(path, backend=backend).run()
    with pytest.raises(ValueError, match="unknown backend"):
        TS.Study(path, backend="jax").run()
    fab = make_fabric("xor", 8)
    tf = lambda load: T.uniform(8, offered=load, cycles=20,  # noqa: E731
                                terminals=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", LacinDeprecationWarning)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fab.sim_sweep("minimal", tf, [0.5])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.saturation_sweep(fab.sim_topology(), "minimal", tf, [0.5])


def test_deprecated_shims_warn_and_equal_the_reference():
    """repro.sim.report.saturation_sweep / compare_policies and
    Fabric.sim_sweep, on the torch engine on the CPU against the
    reference's jax engine."""
    from repro.fabric import make_fabric as r_make_fabric
    from repro import sim as R

    def tf(mod):
        return lambda load, seed: mod.uniform(8, offered=load, cycles=40,
                                              terminals=1, seed=seed)
    kw = dict(terminals=1, cycles=40, warmup=10)
    with pytest.warns(LacinDeprecationWarning):
        b = make_fabric("xor", 8).sim_sweep("valiant", tf(T), [0.3, 0.7],
                                            seeds=(1, 2), device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        a = r_make_fabric("xor", 8).sim_sweep("valiant", tf(R), [0.3, 0.7],
                                              seeds=(1, 2), **kw)
        ra = R_report.compare_policies(R.cin_topology("xor", 8),
                                       ["minimal"], tf(R), [0.5],
                                       backend="jax", **kw)
    with pytest.warns(LacinDeprecationWarning):
        rb = T.compare_policies(T.cin_topology("xor", 8), ["minimal"],
                                tf(T), [0.5], device="cpu", **kw)
    for ga, gb in ((a, b), ([ra["minimal"]], [rb["minimal"]])):
        for row_a, row_b in zip(ga, gb):
            for x, y in zip(row_a, row_b):
                assert T.to_record(y) | {"timing": None} == \
                    R_report.to_record(x) | {"timing": None}


def test_slo_capacity_and_the_cache_cli_run(capsys):
    """Study.slo_capacity and the cache command, which raised before the
    serving slice: a search on serving_slo's CIN-16 Poisson experiment
    equals the reference's, and cache prints this process's counters."""
    name = "cin-xor-16/serving-poisson-r0.05/minimal"
    kw = dict(hi=1.0, tol=0.5)
    ref = RS.Study(RS.bundled_spec_path("serving_slo"),
                   backend="numpy").slo_capacity(name, **kw)
    port = TS.Study(TS.bundled_spec_path("serving_slo"),
                    backend="numpy").slo_capacity(name, **kw)
    assert port == ref and port["capacity"] == 1.0
    assert cli(["cache"]) == 0
    assert "this-process counters: " in capsys.readouterr().out


def test_cli_specs_show_and_run(tmp_path, capsys, monkeypatch):
    """python -m repro_torch.studies: specs, show (with --results and
    --trace), and run studies_smoke --backend numpy, resumed."""
    monkeypatch.chdir(tmp_path)
    assert cli(["specs"]) == 0
    out = capsys.readouterr().out
    assert "studies_smoke" in out and "not runnable" not in out
    runnable = out.splitlines()
    assert len(runnable) == 9
    assert any(ln.startswith("serving_slo ") and "3 experiments" in ln
               for ln in runnable)
    assert any(ln.startswith("failure_sweep ") and "13 experiments" in ln
               for ln in runnable)
    assert any(ln.startswith("flow_scale_smoke ") for ln in runnable)
    assert cli(["show", "studies_smoke"]) == 0
    assert "4 grid points" in capsys.readouterr().out
    store = str(tmp_path / "smoke.jsonl")
    assert cli(["run", "studies_smoke", "--backend", "numpy",
                "--store", store, "--table"]) == 0
    out = capsys.readouterr().out
    assert "ran 4 grid points" in out and "saturation points:" in out
    assert len(T_Store(store).load()) == 4
    assert cli(["run", "studies_smoke", "--backend", "numpy",
                "--store", store]) == 0
    assert "ran 0 grid points (4 restored" in capsys.readouterr().out
    assert cli(["show", "studies_smoke", "--results", "--trace",
                "--store", store]) == 0
    out = capsys.readouterr().out
    assert "store: " in out and f"torch={torch.__version__}" in out
    with pytest.raises(SystemExit):
        cli(["run", "studies_smoke", "--backend", "jax"])
