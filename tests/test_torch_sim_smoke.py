"""``chip_smoke.py``'s ``sim``, ``studies``, ``faults``, ``flow``,
``trace``, ``serving``, ``moe``, ``train`` and ``extract`` phases on the
CPU at a tiny size, so
that the phases the GPU run ends with cannot rot between chip runs: they
drive ``sim_speed``, ``xl_scale``, the exactness checks, the studies path
(the CLI as a subprocess, ``Study.run()``), degraded studies, the flow
tier, traced sweeps with ``trace export``, serving studies with the
workload CLI's SLO searches and the graph cache, and granite-moe-3b-a800m's
MoE layer (reduced) through the same code, with the CPU standing in for
the card (no CUDA graph there), and raise on any difference.
Imports neither jax nor repro.
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


def test_faults_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke):
    out = chip_smoke.phase_faults("cpu", chip_smoke.FAULTS_TINY)
    assert out["knees"] == {
        "cin-xor-8/uniform/minimal/f0": None,
        "cin-xor-8/uniform/minimal/f0.1": 0.8,
        "cin-xor-8/uniform/valiant/f0": 0.8,
        "cin-xor-8/uniform/valiant/f0.1": 0.5}
    assert out["oracle_knees"] == {
        "cin-xor-8/uniform/minimal/f0.1": 0.8,
        "cin-xor-8/uniform/valiant/f0.1": 0.5}
    assert (out["f0_points"], out["cpu_check_points"]) == (6, 12)
    assert list(out["degrade_host_s"]) == ["cin-xor-8+L0.1-s3"]


def test_flow_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke):
    out = chip_smoke.phase_flow("cpu", chip_smoke.FLOW_TINY)
    assert out["points"] == 4
    assert "backend=flow" in out["cli_says_device"][0]
    assert out["accepted"]["cin-xor-16/uniform/minimal|load=0.9|seed=0"] \
        == 0.6875
    first = out["breakdown"][0]
    assert first["iterations"] >= 1 and first["nnz"] == 240
    assert out["flow_knees"] == out["cycle_knees"]


def test_trace_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke):
    out = chip_smoke.phase_trace("cpu", chip_smoke.TRACE_TINY)
    first = out["runs"][0]
    assert (first["samples"], first["completion_cycles"]) == (15, 14)
    kpc = first["kernels_per_cycle"]
    assert kpc["traced"] > kpc["untraced"] > 0
    assert out["export_says"] == ["cross-engine traces agree exactly",
                                  "completion=14 ideal=14 ratio=1.000"]


def test_new_phases_run_the_bundled_specs(chip_smoke):
    """The full sizes are the bundled specs' own: failure_sweep held to the
    pristine grids it replicates, flow_scale_smoke escalated by "auto",
    the collective_replay spec traced."""
    assert chip_smoke.FAULTS_FULL["spec"] == "failure_sweep"
    assert set(chip_smoke.FAULTS_FULL["pristine"]) == {
        "cin16_saturation", "hyperx256_uniform", "dragonfly72_uniform"}
    assert (chip_smoke.FLOW_FULL["spec"], chip_smoke.FLOW_FULL["backend"]) \
        == ("flow_scale_smoke", "auto")
    assert chip_smoke.TRACE_FULL["spec"] == "collective_replay"


def test_serving_phase_runs_on_the_cpu_at_a_tiny_size(chip_smoke):
    out = chip_smoke.phase_serving("cpu", chip_smoke.SERVING_TINY)
    cache = out["cache"]
    assert cache["sim_speed_first"]["timing"]["compile_cached"] is False
    assert cache["sim_speed_second"]["timing"]["compile_cached"] == "memory"
    assert cache["bucketing"]["True"]["blocks_per_call"] == \
        cache["bucketing"]["False"]["blocks_per_call"] == 3
    assert cache["replay_study"]["compile_s_sum"] == 0.0
    assert out["study"]["points"] == 4 and out["study"]["oracle_checked"] == 2
    assert "backend=torch" in out["study"]["cli_says"][0]
    assert [s["capacity"] for s in out["searches"]] == [4.0, 2.51875]
    assert out["sweep"]["request_count"] == 60
    assert out["sweep"]["attach_serving_host_s"] > 0
    assert out["launches"] and not any(out["launches"].values())


def test_serving_phase_sizes_are_the_reference_workloads(chip_smoke):
    """The full serving phase: the bundled serving_slo spec, its two CIN-16
    experiments against the oracle, the CLI's default search, and MMPP
    serving traffic on xl_scale's 1040-switch Dragonfly."""
    full = chip_smoke.SERVING_FULL
    assert full["spec"] == "serving_slo" and full["slo"] == {}
    assert all(name.startswith("cin-xor-16/") for name in full["oracle"])
    sweep = full["sweep"]
    assert sweep["dragonfly"] == chip_smoke.SIM_FULL["xl_scale"]["dragonfly"]
    assert (sweep["cycles"], sweep["packets_per_request"], sweep["slo"]) == \
        (256, 4, 40.0)
    assert full["cache"]["sim_speed"] == chip_smoke.SIM_FULL["sim_speed"]


def test_moe_phase_rehearses_on_the_cpu(chip_smoke):
    """granite's MoE layer at the reduced width: the parts compose to
    ``_moe_local``, and the bound of the work the function needs is no
    more than that of the work the layer does."""
    from repro_torch.models import get_config
    from repro_torch.models import moe as TM
    tiny = chip_smoke.MOE_TINY
    shapes = chip_smoke.phase_moe("cpu", tiny)
    cfg = get_config(tiny["arch"]).reduced()
    stored = TM.expert_store_count(cfg)
    assert set(shapes) == set(tiny["tokens"])
    for what, t in tiny["tokens"].items():
        s = shapes[what]
        assert s["tokens"] == t and s["assignments"] == t * cfg.top_k
        assert s["capacity"] == TM._capacity(t, cfg)
        assert s["bucket_rows"] == stored * s["capacity"]
        assert 0 <= s["tokens_dropped"] < s["assignments"]
        assert 0 < s["experts_selected"] <= cfg.num_experts
        assert s["needed_ffn_flops"] <= s["ffn_flops"]
        assert s["needed_expert_bytes"] <= s["expert_bytes"]
        assert 0 < s["needed_bound_ms"] <= s["bound_ms"]
        assert all(s[k] > 0 for k in ("ms", "route_dispatch_ms",
                                      "expert_ffn_ms", "combine_ms"))


def test_moe_phase_sizes_are_the_serve_runs(chip_smoke):
    """The full moe phase: granite at full width, the serve run's prefill
    tokens (4 prompts of at most 512) and one decode step of 4 slots."""
    full = chip_smoke.MOE_FULL
    assert (full["arch"], full["reduced"]) == ("granite-moe-3b-a800m", False)
    assert full["tokens"] == {"prefill": 2048, "decode": 4}


def test_train_phase_rehearses_on_the_cpu(chip_smoke):
    """The train phase at a tiny size on the CPU (plain versions in place
    of the kernels): every hazard case passes (head dim 256 among them),
    the reduced models' card check runs CPU against CPU, the reduced llama
    and gemma3-1b train their steps with one backward call per layer a
    step, and each timed shape has its bounds.  On one torch thread:
    beside the suite's other test processes, torch's thread pool made it
    many times slower."""
    import torch
    tiny = chip_smoke.TRAIN_TINY
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, timing = chip_smoke.phase_train("cpu", tiny)
    finally:
        torch.set_num_threads(threads)
    steps, layers = tiny["steps"], 4
    assert set(launches) == {"llama3.2-3b", "gemma3-1b"}
    for arch in launches:
        assert launches[arch]["flash_attention_backward"] == steps * layers
    assert set(timing) == set(tiny["timing_cases"])
    for t in timing.values():
        assert t["fwd_bound_ms"] > 0 and t["bwd_bound_ms"] > 0


def test_train_phase_sizes_are_the_training_shape(chip_smoke):
    """The full phase: llama3.2-3b, then gemma3-1b, at full width and
    depth, B2 T1024, 4 steps, attention timed at each one's training
    shape; llama's bound is about 8 x params x tokens FLOP plus 28 bytes
    a parameter, about 80 ms on the H100."""
    from repro_torch.models import get_config
    full = chip_smoke.TRAIN_FULL
    assert (full["models"], full["model_reduced"], full["batch"],
            full["seq"], full["steps"]) == (("llama3.2-3b", "gemma3-1b"),
                                             False, 2, 1024, 4)
    assert [chip_smoke.TRAIN_HAZARDS[case][:6]
            for case in full["timing_cases"]] == [
        (2, 1024, 1024, 24, 8, 128), (2, 1024, 1024, 4, 1, 256)]
    cfg = get_config("llama3.2-3b")
    n = 3_212_749_824
    flops, nbytes = chip_smoke.train_step_work(cfg, 2, 1024, n)
    assert nbytes == 28 * n
    assert abs(flops / (8 * n * 2048) - 1) < 0.05
    ms = (flops / chip_smoke.PEAK_FLOPS[chip_smoke.torch.bfloat16]
          + nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3
    assert 75 < ms < 85


def test_train_step_work_counts_each_layers_window(chip_smoke):
    """The bound's attention counts each layer's visible (query, key)
    pairs: gemma3-1b's 22 local layers see at most 512 keys at T1024, its
    4 global layers every earlier key; a model without windows (llama)
    counts every layer fully causal, as before.  Pairs counted here from
    the masks themselves."""
    import numpy as np
    from repro_torch.models import get_config
    t = 1024
    q = np.arange(t)[:, None]
    k = np.arange(t)[None, :]
    causal = int((k <= q).sum())
    local = int(((k <= q) & (q - k < 512)).sum())
    assert chip_smoke.visible_pairs(t, 0) == causal
    assert chip_smoke.visible_pairs(t, 512) == local
    assert chip_smoke.visible_pairs(t, 4096) == causal
    for arch, pairs in (("gemma3-1b", 22 * local + 4 * causal),
                        ("llama3.2-3b", 28 * causal)):
        cfg = get_config(arch)
        flops, _ = chip_smoke.train_step_work(cfg, 2, t, 1)
        no_attn, _ = chip_smoke.train_step_work(
            chip_smoke.dataclasses.replace(cfg, num_heads=0), 2, t, 1)
        # attention: 4 B H dh a pair, forward, remat recompute and 2.5x
        # in the backward; the rest of the work does not depend on H
        # except through the q and o projections
        attn = 4 * 2 * cfg.num_heads * cfg.head_dim * pairs * 4.5
        proj = 8 * cfg.num_layers * 2 * cfg.num_heads * cfg.head_dim * \
            cfg.d_model * 2 * t
        assert flops - no_attn == attn + proj


def test_extract_phase_rehearses_on_the_cpu(chip_smoke):
    """The extract phase at a tiny size on the CPU: the reduced granite
    MoE layer and llama DP step recorded through the fake group and
    replayed on both engines (card = CPU = oracle, here CPU thrice), the
    CLI's three reference-size extractions and replays as processes of
    their own at the table's numbers, and an arrival trace swept."""
    import torch
    trace = chip_smoke.W.ArrivalSpec(kind="trace", times=(0, 0, 3))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.phase_extract(
            "cpu", chip_smoke.EXTRACT_TINY, trace=trace, card="CPU")
    finally:
        torch.set_num_threads(threads)
    assert launches["flash_attention_backward"] == 4    # reduced: 4 layers


def test_extract_phase_sizes_are_the_published_widths(chip_smoke):
    """granite's MoE layer at B4 T512 a rank over 8 EP ranks: 6 of 48
    stored experts a rank, capacity 512, 9,437,184 B a permute, 144
    messages a pair at 64 KiB; llama3.2-3b's DP step at B8 T1024."""
    from repro_torch.models import get_config
    from repro_torch.models import moe as TM
    full = chip_smoke.EXTRACT_FULL
    moe, dp = full["moe"], full["dp"]
    cfg = get_config(moe["arch"])
    e_loc = TM.expert_store_count(cfg) // moe["devices"]
    cap = TM._capacity(moe["batch"] * moe["seq"], cfg)
    chunk = e_loc * cap * cfg.d_model * 2
    assert (e_loc, cap, chunk) == (6, 512, 9_437_184)
    assert -(-chunk // moe["bytes_per_packet"]) == 144
    assert (dp["arch"], dp["reduced"], dp["batch"], dp["seq"],
            dp["devices"]) == ("llama3.2-3b", False, 8, 1024, 8)
    assert full["cli"] == (("moe", 8, 14, 896, 112),
                           ("dp", 8, 182, 3360, 420),
                           ("pipeline", 4, 11, 84, 26))
