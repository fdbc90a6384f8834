"""``chip_smoke.py``'s ``sim`` and ``studies`` phases on the CPU at a tiny
size, so that the phases the GPU run ends with cannot rot between chip
runs: they drive ``sim_speed``, ``xl_scale``, the exactness checks and the
studies path (the CLI as a subprocess, ``Study.run()``) through the same
code, with the CPU standing in for the card (no CUDA graph there), and
raise on any difference.  Imports neither jax nor repro.
"""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sim_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke):
    out = chip_smoke.phase_sim("cpu", chip_smoke.SIM_TINY)
    speed, xl, exact = out["sim_speed"], out["xl_scale"], out["exact"]
    tiny = chip_smoke.SIM_TINY
    assert speed["copies"] == (len(tiny["sim_speed"]["loads"])
                               * len(tiny["sim_speed"]["seeds"]))
    assert speed["lane_cycles_per_s_warm"] > 0
    assert speed["step"]["kernels_per_cycle"] > 0
    assert speed["step"]["graph_ms_per_cycle"] is None   # no graph on a CPU
    assert xl["packets_delivered"] > 0
    assert xl["timing_warm"]["backend"] == "torch"
    n = tiny["exact"]["a2a_n"]
    assert exact["a2a_packets"] == exact["a2a_links"] == n * (n - 1)
    assert set(exact["drained_delivered"]) == {"valiant", "adaptive"}


def test_sim_phase_sizes_are_the_reference_workloads(chip_smoke):
    """The full sizes are the reference's speed workloads
    (benchmarks/bench_simulation.py:136-150, bench_compile.py:161-200)."""
    full = chip_smoke.SIM_FULL
    assert full["sim_speed"] == {
        "n": 16, "terminals": 12, "loads": (0.5, 0.7, 0.9),
        "seeds": tuple(range(31, 39)), "cycles": 1600, "warmup": 400}
    assert full["xl_scale"]["dragonfly"] == (16, 8, 8, 65)
    assert (full["xl_scale"]["cycles"], full["xl_scale"]["warmup"],
            full["xl_scale"]["load"]) == (256, 64, 0.05)


def test_studies_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke):
    out = chip_smoke.phase_studies("cpu", chip_smoke.STUDIES_TINY)
    replay = out["replay"]
    assert replay["completion_vs_ideal"][
        "cin-xor-8/replay-all_to_all/minimal"] == [14, 14]
    assert replay["points"] == 2 and replay["lane_cycles_per_s_warm"] > 0
    assert replay["cli_says"] and "backend=torch" in replay["cli_says"][0]
    smoke = out["studies_smoke"]
    assert smoke["knees"] == smoke["oracle_knees"]
    assert smoke["cpu_check_points"] == 2
    assert smoke["execute_s_sum"] > 0 and smoke["host_s_sum"] > 0


def test_studies_phase_runs_the_bundled_specs(chip_smoke):
    """The full sizes are the bundled specs' own, and the expected replay
    completions are BENCH collective_replay's minimal rows."""
    full = chip_smoke.STUDIES_FULL
    assert full["replay"] == "collective_replay"
    assert set(full["saturation"]) == {"cin16_saturation",
                                       "hyperx256_uniform",
                                       "dragonfly72_uniform"}
    assert sorted(full["replay_expect"].values()) == [(30, 30), (60, 60),
                                                      (142, 32)]
