"""The tiny cells through the port's kernels on the card: the harness's
run with the output check passing, the trace read, and each planted fault
failing it.  Skips where there is no card (the ``cuda_device`` fixture)."""
import time

import pytest

from portbench import harness
from portbench.conftest import TINY_CELLS

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_tiny_cell_on_the_card(tiny_bench, cuda_device, cell):
    out = harness.run_cell(cell, 2**31 + 99, 0.5, True, cuda_device,
                           time.perf_counter())
    run = out.pop("_run")
    assert out["correct"], run["numbers"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert {"device_idle_share", "train_mfu", "adamw_roofline",
            "loss_and_grads_ms"} <= set(out["metrics"])
    assert out["breakdown"]["device_ops"]


@pytest.mark.parametrize("cell", TINY_CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_tiny_faults_on_the_card(tiny_bench, cuda_device, cell, fault):
    out = harness.run_cell(cell, 5, 0.1, False, cuda_device,
                           time.perf_counter(), fault=fault)
    assert not out["correct"], out["_run"]["numbers"]
