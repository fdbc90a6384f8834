"""repro_torch.launch.analytic against repro.launch.analytic, on the CPU.

The port's copy of the executed-FLOPs and HBM-traffic model, on the port's
copy of the configs, gives the reference's numbers exactly (the same
float arithmetic in the same order): ``cell_cost`` for every architecture
that both packages register and every shape of ``SHAPES``, at 1 and 16
chips, and ``train_cost`` under each remat policy at the shape the port
trains on the card (B2 T1024).  Tolerance: none, equality.
"""
import dataclasses

import pytest

from repro.launch import analytic as JA
from repro.models import config as JC
from repro.models import list_archs as jax_list_archs

from repro_torch.launch import analytic as TA
from repro_torch.models import config as TC
from repro_torch.models import list_archs

BOTH = sorted(set(list_archs()) & set(jax_list_archs()))


def test_both_packages_register_the_ported_configs():
    assert set(list_archs()) <= set(jax_list_archs())
    assert {"starcoder2-3b", "xlstm-350m", "llama3.2-3b"} <= set(BOTH)


def test_shapes_are_the_reference_shapes():
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JC.SHAPES.items()}


@pytest.mark.parametrize("shape", sorted(JC.SHAPES))
@pytest.mark.parametrize("arch", BOTH)
def test_cell_cost_equals_reference(arch, shape):
    for chips in (1, 16):
        got = TA.cell_cost(TC.get_config(arch), TC.SHAPES[shape], chips)
        want = JA.cell_cost(JC.get_config(arch), JC.SHAPES[shape], chips)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "starcoder2-3b"])
def test_train_cost_at_the_card_shape_equals_reference(arch, remat):
    got = TA.train_cost(TC.get_config(arch),
                        TC.ShapeConfig("card", 1024, 2, "train"), 1,
                        remat=remat)
    want = JA.train_cost(JC.get_config(arch),
                         JC.ShapeConfig("card", 1024, 2, "train"), 1,
                         remat=remat)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.exec_flops_total > 0 and got.hbm_bytes_per_dev > 0
