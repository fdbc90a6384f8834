"""``chip_smoke.py``'s ``sim``, ``studies``, ``faults``, ``flow``,
``trace``, ``serving``, ``moe``, ``train``, ``xlstm_sp``, ``extract``,
``tp`` and internvl2-26b's ``prefill`` phases, and the serve phase's logit checks, on the CPU at a
tiny size, so
that the phases the GPU run ends with cannot rot between chip runs: they
drive ``sim_speed``, ``xl_scale``, the exactness checks, the studies path
(the CLI as a subprocess, ``Study.run()``), degraded studies, the flow
tier, traced sweeps with ``trace export``, serving studies with the
workload CLI's SLO searches and the graph cache, and granite-moe-3b-a800m's
MoE layer (reduced) through the same code, with the CPU standing in for
the card (no CUDA graph there), and raise on any difference.
Imports neither jax nor repro.
"""
import dataclasses
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
    of the kernels): every hazard case passes (head dim 256 and 12 query
    heads a KV head among them, and the mLSTM scan's Function), the reduced
    models' card check runs CPU against CPU, the reduced llama, gemma3-1b
    and starcoder2-3b train their steps with one attention backward call
    per layer a step, the reduced xlstm-350m (3 mLSTM layers, T 256) with
    one scan backward call per mLSTM layer a step and its step 1 checked in
    fp32 and bf16, the reduced hymba-1.5b (its step 1 in fp32 at 2 of its
    4 layers), whisper-base (2 encoder layers, and a self- and a
    cross-attention in each of its 4 decoder layers: 10 attentions) and
    internvl2-26b (cut to 2 layers) with one backward call an attention a
    step, every model's
    step 1 within FULL_GRAD_REL_L2 on every leaf, and each timed shape has
    its bounds.  On one torch thread: beside the suite's other test
    processes, torch's thread pool made it many times slower."""
    import torch
    tiny = chip_smoke.TRAIN_TINY
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines, timing = chip_smoke.phase_train("cpu", tiny)
    finally:
        torch.set_num_threads(threads)
    assert set(lines) == {"llama3.2-3b", "gemma3-1b", "starcoder2-3b",
                          "xlstm-350m", "hymba-1.5b", "whisper-base",
                          "internvl2-26b"}
    attention = {"llama3.2-3b": 4, "gemma3-1b": 4, "starcoder2-3b": 4,
                 "xlstm-350m": 0, "hymba-1.5b": 4,
                 "whisper-base": 2 + 2 * 4, "internvl2-26b": 2}
    for arch, line in lines.items():
        steps = tiny["steps_by_model"].get(arch, tiny["steps"])
        mlstm = line["blocks"]["mlstm"]
        assert line["steps"] == steps
        assert line["attention_layers"] == attention[arch]
        assert line["launches"]["flash_attention_backward"] == (
            steps * attention[arch])
        assert line["launches"]["mlstm_scan_backward"] == steps * mlstm
    assert lines["xlstm-350m"]["blocks"] == {"attn": 0, "mlstm": 3,
                                             "slstm": 1, "hymba": 0,
                                             "attn_cross": 0}
    assert lines["internvl2-26b"]["reduced"] == ["layers 4 -> 2"]
    assert lines["hymba-1.5b"]["step1_float32"]["layers"] == 2
    assert lines["hymba-1.5b"]["prefix"] == 4
    assert lines["internvl2-26b"]["prefix"] == 8
    assert lines["whisper-base"]["encoder_frames"] == 16
    assert all(line["weight_grads_nonzero_full_depth"] > 0
               for line in lines.values())
    for arch, line in lines.items():
        dtypes = ({"float32", "bfloat16"} if arch == "xlstm-350m" else
                  {"float32"} if arch == "hymba-1.5b" else {"bfloat16"})
        assert {k for k in line if k.startswith("step1_") and k !=
                "step1_launches"} == {f"step1_{d}" for d in dtypes}
        for d in dtypes:
            got = line[f"step1_{d}"]
            assert got["grad_rel_l2"]["max"] <= chip_smoke.FULL_GRAD_REL_L2
            assert got["denominator_positions"] == (
                2 * 256 * 4 * 3 if arch == "xlstm-350m" else 0)
    assert set(timing) == set(tiny["timing_cases"]) | {"mlstm bfloat16",
                                                       "mlstm float32"}
    for t in timing.values():
        assert t["fwd_bound_ms"] > 0 and t["bwd_bound_ms"] > 0


def _tiny_xlstm_step1(chip_smoke, dtype):
    import torch
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.models import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.runtime import trainer as TR
    cfg = chip_smoke.dataclasses.replace(
        get_config("xlstm-350m").reduced(), dtype=dtype, remat="none")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=2)
    params = TT.init_params(0, cfg, device="cpu")
    batch = TR.on_device(host_batch(data, 0), "cpu")
    torch.set_num_threads(1)
    return params, batch, cfg


def _halved_scan(*args, **kw):
    from repro_torch.kernels.ref import reference_mlstm_scan
    h, state = reference_mlstm_scan(*args, **kw)
    return h * 0.5, state


def _late_scan(*args, **kw):
    """The scan's output a position late (zeros at the first)."""
    import torch
    from repro_torch.kernels.ref import reference_mlstm_scan
    h, state = reference_mlstm_scan(*args, **kw)
    return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", ["none", "scan output halved",
                                   "scan output a position late",
                                   "scan backward zeroed",
                                   "scan backward doubled"])
def test_step1_check_fails_a_wrong_scan(chip_smoke, dtype, fault):
    """step1_check on the reduced xlstm-350m (T 256, the chunkwise path):
    the scan as the kernel's wrapper gives it passes; a scan whose forward
    output is scaled or late, or whose backward's gradients are scaled or
    zeroed, fails, in both compute dtypes (in bf16 by its layer-by-layer
    check)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import xlstm as MX
    threads = torch.get_num_threads()
    params, batch, cfg = _tiny_xlstm_step1(chip_smoke, dtype)
    bwd = MX.mlstm_backward
    patch = {"none": (),
             "scan output halved": ((ops, "mlstm_scan", _halved_scan),),
             "scan output a position late": ((ops, "mlstm_scan",
                                              _late_scan),),
             "scan backward zeroed": ((MX, "mlstm_backward", lambda *a, **kw:
                                       [g * 0 for g in bwd(*a, **kw)]),),
             "scan backward doubled": ((MX, "mlstm_backward", lambda *a, **kw:
                                        [g * 2 for g in bwd(*a, **kw)]),)}
    try:
        with chip_smoke.patched(*patch[fault]):
            if fault == "none":
                _, _, line = chip_smoke.step1_check(params, batch, cfg, 256)
                assert line["grad_rel_l2"]["max"] <= 1e-4
                assert line["mlstm_layers_max"] <= 1e-4
            else:
                with pytest.raises(AssertionError,
                                   match="^step 1|^mLSTM layer"):
                    chip_smoke.step1_check(params, batch, cfg, 256)
    finally:
        torch.set_num_threads(threads)


def test_denominator_sides_move_only_within_the_band(chip_smoke):
    """DenominatorBranches forced to another run's sides moves only the
    positions whose own margin is within the band, and forced to its own
    sides gives the unforced gradients bit for bit."""
    import torch
    from repro_torch.models import xlstm as MX
    threads = torch.get_num_threads()
    params, batch, cfg = _tiny_xlstm_step1(chip_smoke, "float32")
    try:
        own = chip_smoke.DenominatorBranches(256)
        with chip_smoke.patched((MX, "_denominator", own)):
            _, want = chip_smoke._step1(params, batch, cfg)
        assert len(own.taken) == 3 and own.taken[0].shape == (2, 256, 4)
        floor_side = [-(t.abs() + 1) for t in own.taken]   # every side flipped
        for band, force in ((float("inf"), own.taken), (0.0, floor_side)):
            forced = chip_smoke.DenominatorBranches(256, force, band)
            with chip_smoke.patched((MX, "_denominator", forced)):
                _, got = chip_smoke._step1(params, batch, cfg)
            assert forced.moved == [0, 0, 0]
            assert all(torch.equal(got[n], want[n]) for n in want)
        near = [t.abs() <= 0.5 for t in own.taken]
        forced = chip_smoke.DenominatorBranches(256, floor_side, 0.5)
        with chip_smoke.patched((MX, "_denominator", forced)):
            chip_smoke._step1(params, batch, cfg)
        assert forced.moved == [int((n & (t >= 0)).sum())
                                for n, t in zip(near, own.taken)]
        assert sum(forced.moved) > 0
    finally:
        torch.set_num_threads(threads)


def test_xlstm_witness_rehearses_on_the_cpu(chip_smoke):
    """The witness on the reduced xlstm-350m (T 256) on the CPU: every run
    of WITNESS_RUNS in order, float64 re-chunked within 1e-10 of float64,
    the fp32 kernels' wrapper within 1e-4 of it on every leaf, bf16 read
    against bf16 plain too, and float64's own readings by layer."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = chip_smoke.xlstm_witness("cpu", reduced=True, seq=256)
    finally:
        torch.set_num_threads(threads)
    by = {line["run"]: line for line in lines}
    assert list(by) == [run[0] for run in chip_smoke.WITNESS_RUNS]
    assert by["float64 re-chunked 128"]["vs float64"][
        "grad_rel_l2_max"] <= 1e-10
    assert by["fp32 kernels"]["vs float64"]["grad_rel_l2_max"] <= 1e-4
    assert "vs bf16 plain" in by["bf16 kernels"]
    assert len(by["float64"]["d_out_norm"]) == 4
    assert len(by["float64"]["b_f_terms"]) == 3


def test_train_phase_sizes_are_the_training_shape(chip_smoke):
    """The full phase: llama3.2-3b, gemma3-1b, starcoder2-3b at full width
    and depth, then xlstm-350m at full width with 8 of its 24 layers (its
    sLSTM at layer 4 among them), B2 T1024, 4 steps (xlstm-350m's
    host-bound step 3, and its depth, so that phase tp fits the time),
    attention timed
    at each attention model's training shape and the mLSTM scan at
    xlstm-350m's (H4 D512: its inner width 2048 over 4 heads); llama's
    bound is about 8 x params x tokens FLOP plus 28 bytes a parameter,
    about 80 ms on the H100, and xlstm-350m's, from the reference's
    executed-FLOPs model, about 8.8 ms."""
    from repro_torch.launch import analytic
    from repro_torch.models import get_config
    from repro_torch.models.config import ShapeConfig
    full = chip_smoke.TRAIN_FULL
    assert (full["models"][:4], full["model_reduced"], full["batch"],
            full["seq"], full["steps"]) == (
        (("llama3.2-3b", "training_shape"),
         ("gemma3-1b", "training_shape_d256"),
         ("starcoder2-3b", "training_shape_gqa12"), ("xlstm-350m", None)),
        False, 2, 1024, 4)
    assert full["steps_by_model"]["xlstm-350m"] == 3
    assert full["layers_by_model"]["xlstm-350m"] == 8
    assert "slstm" in get_config("xlstm-350m").block_pattern[:8]
    assert [chip_smoke.TRAIN_HAZARDS[case][:6]
            for case in full["timing_cases"][:3]] == [
        (2, 1024, 1024, 24, 8, 128), (2, 1024, 1024, 4, 1, 256),
        (2, 1024, 1024, 24, 2, 128)]
    xl = get_config("xlstm-350m")
    assert chip_smoke.MLSTM_TRAIN_HAZARDS[full["mlstm_timing_case"]] == (
        2, 1024, xl.num_heads, xl.ssm_expand * xl.d_model // xl.num_heads,
        256, "normal")
    cost = analytic.train_cost(xl, ShapeConfig("chip", 1024, 2, "train"), 1)
    ms = max(cost.exec_flops_total / chip_smoke.PEAK_FLOPS[
        chip_smoke.torch.bfloat16], cost.hbm_bytes_per_dev
        / chip_smoke.HBM_BYTES_PER_S) * 1e3
    assert 8 < ms < 10
    cfg = get_config("llama3.2-3b")
    n = 3_212_749_824
    flops, nbytes = chip_smoke.train_step_work(cfg, 2, 1024, n)
    assert nbytes == 28 * n
    assert abs(flops / (8 * n * 2048) - 1) < 0.05
    ms = (flops / chip_smoke.PEAK_FLOPS[chip_smoke.torch.bfloat16]
          + nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3
    assert 75 < ms < 85


def test_prefixed_training_sizes_are_the_published_widths(chip_smoke):
    """hymba-1.5b (8 of its 32 layers, so that the script keeps its time:
    128 meta tokens + 896 text tokens, the SSM's chunked scan, 3 steps,
    step 1 in fp32 at 4 of its layers),
    whisper-base (full depth, 1500 frames, 1024 text tokens) and
    internvl2-26b (4 of 48 layers: 2.70 B parameters, 43 GB of fp32
    train state at 16 bytes a parameter; 256 patch embeddings + 768 text
    tokens), each attention's lse shape among the hazards and timed at its
    published heads and head dim."""
    from repro_torch.launch import specs
    from repro_torch.models import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.config import ShapeConfig
    full = chip_smoke.TRAIN_FULL
    assert [m for m, _ in full["models"][4:]] == [
        "hymba-1.5b", "whisper-base", "internvl2-26b"]
    assert full["steps_by_model"] == {"hymba-1.5b": 3, "xlstm-350m": 3}
    assert full["step1"]["hymba-1.5b"] == (("float32",), 4)
    shape = ShapeConfig("chip", full["seq"], full["batch"], "train")
    text = {"hymba-1.5b": 896, "whisper-base": 1024, "internvl2-26b": 768}
    for arch, cases in full["models"][4:]:
        cfg = get_config(arch)
        if arch in full["layers_by_model"]:
            cfg = chip_smoke.cut_depth(cfg, full["layers_by_model"][arch])
        assert specs.train_input_specs(cfg, shape)["tokens"].shape == (
            2, text[arch])
        assert sum(n for _, n in cases) == chip_smoke.attention_layers(
            cfg) - (6 if arch == "whisper-base" else 0)
        for case, _ in cases:
            b, t, s, h, kvh, d = chip_smoke.TRAIN_HAZARDS[case][:6]
            assert (h, kvh, d) == (cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim)
            assert case in full["hazards"] and case in full["timing_cases"]
    vlm = chip_smoke.cut_depth(get_config("internvl2-26b"), 4)
    n = sum(a.numel() for _, a in chip_smoke._named_leaves(
        TT.param_shapes(vlm)))
    assert 2.6e9 < n < 2.8e9 and 16 * n < 45e9
    w = get_config("whisper-base")
    assert chip_smoke.attention_layers(w) == 18
    assert chip_smoke.TRAIN_HAZARDS["train_whisper_cross"][:3] == (
        2, 1024, w.encoder_seq_len)


def test_xlstm_sp_phase_rehearses_on_the_cpu(chip_smoke):
    """Phase xlstm_sp at a tiny size on the CPU: the segments folded on one
    rank give the whole sequence's scan within SP_REL_L2; the full sizes
    are xlstm-350m's heads and head dim at B2 T1024 in 4 segments."""
    import torch
    from repro_torch.models import get_config
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rel = chip_smoke.phase_xlstm_sp("cpu", chip_smoke.XLSTM_SP_TINY)
    finally:
        torch.set_num_threads(threads)
    assert rel <= chip_smoke.SP_REL_L2
    xl = get_config("xlstm-350m")
    full = chip_smoke.XLSTM_SP_FULL
    assert (full["b"], full["t"], full["h"], full["d"], full["segments"]) \
        == (2, 1024, xl.num_heads, xl.ssm_expand * xl.d_model
            // xl.num_heads, 4)


def test_tp_phase_rehearses_on_the_cpu(chip_smoke, capsys):
    """Phase tp at a tiny size on the CPU: the one-rank runs here, then two
    gloo ranks as processes of chip_smoke.py (``--tp-rank``) on a
    ("model",) mesh, each running every model, held to the phase's gates
    (they raise); each rank at half the heads (hymba's and whisper's
    reduced 4 query heads split), half the mLSTM heads, about half the
    resident bytes.  The full sizes are llama3.2-3b's published width at 8
    of its layers, xlstm-350m's at 8 (its sLSTM at layer 4 among them),
    hymba-1.5b's at 4 and whisper-base whole; the lse's timed cases are a
    rank's attention shapes."""
    import json
    import torch
    from repro_torch.models import get_config
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chip_smoke.phase_tp("cpu", chip_smoke.TP_TINY)
    finally:
        torch.set_num_threads(threads)
    lines = {json.loads(x)["model"]: json.loads(x)
             for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"phase": "tp"')}
    assert list(lines) == [f"{arch}-smoke" for arch in (
        "llama3.2-3b", "xlstm-350m", "hymba-1.5b", "whisper-base")]
    line = lines["llama3.2-3b-smoke"]
    cfg = get_config("llama3.2-3b").reduced()
    assert line["rank_attention_shape"] == [cfg.num_heads // 2,
                                            cfg.num_kv_heads // 2,
                                            cfg.head_dim]
    for line in lines.values():
        assert max(line["resident_share"]) <= chip_smoke.TP_RESIDENT_SHARE
    xl = get_config("xlstm-350m").reduced()
    assert lines["xlstm-350m-smoke"]["rank_scan_shapes"] == [
        [xl.num_heads // 2, 2 * xl.d_model // xl.num_heads]]
    assert lines["xlstm-350m-smoke"]["rank_attention_shapes"] == []
    for arch in ("hymba-1.5b", "whisper-base"):
        assert lines[f"{arch}-smoke"]["rank_attention_shapes"] == [[2, 1, 16]]
    full, llama = chip_smoke.TP_FULL, get_config("llama3.2-3b")
    assert full["layers"] <= 8 and not full["reduced"]
    assert full["blocks"] == {"xlstm-350m": 8, "hymba-1.5b": 4,
                              "whisper-base": 6}
    assert "slstm" in get_config("xlstm-350m").block_pattern[:8]
    assert get_config("whisper-base").num_layers == 6
    assert chip_smoke.TRAIN_HAZARDS[chip_smoke.TP_RANK_CASE][3:6] == (
        llama.num_heads // full["tp"], llama.num_kv_heads // full["tp"],
        llama.head_dim)
    w = get_config("whisper-base")
    for case in chip_smoke.TP_WHISPER_CASES:
        assert chip_smoke.TRAIN_HAZARDS[case][3:6] == (
            w.num_heads // full["tp"], w.num_kv_heads // full["tp"],
            w.head_dim)
    xf = get_config("xlstm-350m")
    assert chip_smoke.MLSTM_TRAIN_HAZARDS[chip_smoke.TP_MLSTM_CASE][2:4] == (
        xf.num_heads // full["tp"], 2 * xf.d_model // xf.num_heads)


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


def _one_thread(fn, *args, **kw):
    """``fn`` on one torch thread (the suite runs several test processes on
    the CPU at once)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(threads)


def test_vlm_prefill_phase_rehearses_on_the_cpu(chip_smoke, capsys):
    """internvl2-26b reduced (2 layers, 8 seeded patch embeddings before a
    16-token prompt): no kernel launched on the CPU, caches of 24
    positions, logits equal to the plain versions'."""
    import json
    launches = _one_thread(chip_smoke.phase_vlm_prefill, "cpu",
                           chip_smoke.VLM_TINY)
    assert launches and not any(launches.values())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["phase"], line["layers"], line["positions"],
            line["patch_embeds"]) == ("prefill", 2, 24, 8)
    assert line["prefill_logits_rel_l2_vs_plain"] == {"bfloat16": 0.0}
    assert line["prefill_ms"] > 0


def test_vlm_prefill_phase_sizes_are_the_published_widths(chip_smoke):
    """internvl2-26b at full width, 8 of its 48 layers, a 512-token prompt
    behind its 256 patch embeddings."""
    from repro_torch.models import get_config
    full = chip_smoke.VLM
    cfg = get_config(full["arch"])
    assert (full["arch"], full["reduced"], full["layers"],
            full["prompt"]) == ("internvl2-26b", False, 8, 512)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.num_patch_tokens) == (6144, 48, 8, 128, 256)


def _tiny_served(chip_smoke, arch, t=16):
    """The reduced ``arch`` in bf16 on the CPU, cast, with a batch of 4
    seeded prompts of ``t`` tokens and its seeded frames or patches."""
    import numpy as np
    import torch
    from repro_torch.models import get_config, init_params
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params = TT.cast_params(init_params(0, cfg, device="cpu"), cfg)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (4, t))),
             **chip_smoke.model_extras(cfg, 4, rng, "cpu")}
    return params, batch, cfg, TT.prefix_len(cfg, batch) + t + 8


@pytest.mark.parametrize("arch,check_dtype", [
    ("hymba-1.5b", "float32"), ("xlstm-350m", "float32"),
    ("whisper-base", "bfloat16")])
def test_prefill_logits_check_rehearses_on_the_cpu(chip_smoke, arch,
                                                   check_dtype):
    """prefill_logits_check on the reduced models as phase_serve holds
    them: hymba-1.5b in fp32 and layer by layer (4 layers, prefill and a
    decode step), xlstm-350m in fp32 and against its plain version
    re-chunked, whisper-base in bf16; the CPU's wrappers run the plain
    versions, so every reading is 0."""
    params, batch, cfg, seq = _tiny_served(chip_smoke, arch)
    _, _, fields = _one_thread(chip_smoke.prefill_logits_check, params,
                               batch, cfg, seq, check_dtype)
    assert fields["prefill_logits_rel_l2_vs_plain"] == dict.fromkeys(
        {cfg.dtype, check_dtype}, 0.0)
    if check_dtype != cfg.dtype:
        assert 0 < fields["plain_with_input_noise_rel_l2"] < 1
        assert 0 < fields["plain_vs_plain_in_check_dtype_rel_l2"] < 1
    if arch == "hymba-1.5b":
        assert fields["layers_rel_l2_vs_plain"] == {
            "prefill": [0.0] * 4, "decode": [0.0] * 4}


def _late(*args, **kw):
    """Attention with each query's output one position late (zeros at the
    first)."""
    import torch
    from repro_torch.kernels.ref import reference_attention
    o = reference_attention(*args, **kw)
    return torch.cat([torch.zeros_like(o[:, :1]), o[:, :-1]], dim=1)


@pytest.mark.parametrize("fault", ["none", "head dims reversed",
                                   "a position late"])
def test_hymba_layers_check_fails_a_wrong_attention(chip_smoke, fault):
    """hymba_layers_check on the reduced hymba-1.5b in bf16 (4 layers,
    prefill and a decode step): attention as the wrapper gives it passes;
    attention whose output has its head dims in reverse order, or comes a
    position late, fails, although the layer normalises the attention's
    output before it adds it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import reference_attention
    params, batch, cfg, seq = _tiny_served(chip_smoke, "hymba-1.5b")
    patch = {"none": (),
             "head dims reversed": (
                 (ops, "flash_attention",
                  lambda *a, **kw: reference_attention(*a, **kw).flip(-1)),),
             "a position late": ((ops, "flash_attention", _late),)}
    with chip_smoke.patched(*patch[fault]):
        if fault == "none":
            got = _one_thread(chip_smoke.hymba_layers_check, params, batch,
                              cfg, seq)
            assert got["layers_max_rel_l2"] == 0.0
        else:
            with pytest.raises(AssertionError, match="each layer"):
                _one_thread(chip_smoke.hymba_layers_check, params, batch,
                            cfg, seq)
