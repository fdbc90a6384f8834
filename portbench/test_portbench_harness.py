"""The harness at tiny cells on the CPU: the result line, the files found
by name, the output check passing sound runs and failing planted
faults."""
import json
import math
import time

import pytest
import torch

from portbench import check, harness
from portbench.conftest import TINY_CELLS

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_real_cells_are_found_by_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"] == cell.spec["config"]
        assert cell.mix["kind"] == "train"
        assert (harness.BENCH_DIR / "traffic" / "train.py").is_file()
        assert [m["name"] for m in cell.end_to_end] == [
            "train_tokens_per_s", "setup_s"]
        assert len(cell.per_layer) == 5
        assert {m["moves"] for m in cell.per_layer} == {"train_tokens_per_s"}
        for m in cell.per_layer:
            assert callable(harness.load_module("metrics", m["name"]).read)
        assert {"loss_gap", "grad_norm_gap", "update_gap"} <= set(
            cell.spec["limits"]) <= set(check.NUMBERS)
    for c in bench["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"] and c["source"] == cfg["source"]


def test_real_configs_build_the_port_config():
    bench = harness.benchmark()
    for c in bench["configs"]:
        config = harness.load_json("configs", c["name"])
        cfg = harness.port_config(config)
        sizes = harness.model_sizes(config)
        assert (cfg.d_model, cfg.num_layers, cfg.d_ff) == (
            sizes["d_model"], sizes["num_layers"], sizes["d_ff"])
        for key, value in config.get("published", {}).items():
            assert key in config["reduced"] and config[key] != value


def test_missing_names_raise(tiny_bench):
    with pytest.raises(FileNotFoundError):
        harness.find_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_gives_the_result_line(tiny_bench, one_thread, cell, trace):
    out = harness.run_cell(cell, 2**31 + 12345, 0.01, trace, "cpu",
                           time.perf_counter())
    run = out.pop("_run")
    assert list(out)[:5] == list(KEYS) and list(out)[-1] == "check"
    assert out["correct"], run["numbers"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    if trace:
        # no device on the CPU: every device metric is left out
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
        assert out["metrics"]["train_tokens_per_s"]["unit"] == "tokens/s"
    for v in out["check"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]
    dropped = run["numbers"]["dropped_share"]
    if "moe" in cell:
        assert 0.0 <= dropped < 1.0
    else:
        assert dropped is None
    json.dumps(out)


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_planted_faults_come_out_not_correct(tiny_bench, one_thread, cell,
                                             fault):
    out = harness.run_cell(cell, 7, 0.01, False, "cpu", time.perf_counter(),
                           fault=fault)
    assert not out["correct"], out["_run"]["numbers"]


def test_check_numbers_on_synthetic_readings():
    want = {"losses": [10.0, 9.0], "changes": {"a": 1.0, "b": 2.0, "c": 1e-9},
            "grad_norms": {"a": 1.0, "b": 4.0, "c": 1e-9}}
    got = {"losses": [10.01, 9.0], "changes": {"a": 1.0, "b": 1.0, "c": 5.0},
           "grad_norms": {"a": 1.1, "b": 4.0, "c": 0.0}}
    n = check.gaps(got, want)
    assert n["loss_gap"] == pytest.approx(1e-3)
    # over max(own norm, median norm 1.0): a 0.1, b 0, c 1e-9
    assert n["grad_norm_gap"] == pytest.approx(0.1)
    assert n["grad_norm_leaf"] == "a"
    assert n["grad_norm_gap_median"] == pytest.approx(1e-9)
    # c's gradient is under a thousandth of the median: its change is
    # rounding and is not compared; b moved half as far
    assert n["leaves_moved"] == 2
    assert n["update_gap"] == pytest.approx(0.5)
    ok, compared = check.judge(n, {"loss_gap": 2e-3, "update_gap": 0.6})
    assert ok and list(compared) == ["loss_gap", "update_gap"]
    assert not check.judge(n, {"loss_gap": 2e-3, "grad_norm_gap": 0.05})[0]
    # a dropped share is compared where the run read one
    assert n["dropped_share"] is None
    assert list(check.judge(n, {"dropped_share": 0.0})[1]) == []
    n = check.gaps({**got, "dropped_share": 0.01}, want)
    assert not check.judge(n, {"dropped_share": 0.0})[0]
    assert check.judge(n, {"dropped_share": 0.02})[0]


def test_published_multipliers_fold_into_the_weights():
    """The same draws, scaled as ``weights.py`` folds each multiplier; a
    configuration without multipliers draws as it did without gains."""
    from portbench import weights
    from portbench.conftest import TINY_CONFIGS
    plain = TINY_CONFIGS["tiny-moe"]
    mult = {**plain, "embedding_multiplier": 12.0, "residual_multiplier":
            0.22, "attention_multiplier": 1 / 16, "logits_scaling": 6.0}
    a = weights.make(harness.model_sizes(plain), 3, "cpu")
    b = weights.make(harness.model_sizes(mult), 3, "cpu")
    assert harness.model_sizes(plain)["gains"] == {
        "embed": 1.0, "residual": 1.0, "query": 1.0, "final": 1.0}
    close = dict(rtol=1e-6, atol=0)
    torch.testing.assert_close(b["embed"]["table"], 12 * a["embed"]["table"],
                               **close)
    for la, lb in zip(a["layers"], b["layers"]):
        # 1/16 over the port's 1/sqrt(16)
        torch.testing.assert_close(lb["attn"]["wq"], 0.25 * la["attn"]["wq"],
                                   **close)
        torch.testing.assert_close(lb["attn"]["wk"], la["attn"]["wk"], **close)
        for block in ("attn", "moe"):
            torch.testing.assert_close(lb[block]["wo"], 0.22 * la[block]["wo"],
                                       **close)
    # untied: the final norm's scale (1 + offset) over the logits scaling
    torch.testing.assert_close(1 + b["final_norm"]["scale"],
                               (1 + a["final_norm"]["scale"]) / 6.0, **close)
