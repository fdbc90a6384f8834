"""The port's fabric math (``repro_torch.core`` / ``repro_torch.fabric``)
against the reference's (``repro.core`` / ``repro.fabric``): P matrices,
far-end port tables, verification reports, the numpy routers and their
torch twins (reference ``route_*_jnp`` / ``mirror_route_jnp``), and the
closed-form HyperX / Dragonfly / CIN link loads.  Exact: integers.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fabric.mirror  # noqa: F401  (registers the mirror instance)
from repro.core import routing as R_routing
from repro.core import simulate as R_simulate
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
from repro.core.port_matrix import port_matrix as R_port_matrix
from repro.core.port_matrix import verify_instance as R_verify
from repro.fabric import get_instance as R_get_instance

import repro_torch.fabric  # noqa: F401  (registers the mirror instance)
from repro_torch.core import routing as T_routing
from repro_torch.core import simulate as T_simulate
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX
from repro_torch.core.port_matrix import port_matrix as T_port_matrix
from repro_torch.core.port_matrix import verify_instance as T_verify
from repro_torch.fabric import get_instance as T_get_instance
from repro_torch.fabric import instance_names as T_instance_names

#: Every registry instance, even and odd n (xor: powers of two).
INSTANCES = [("swap", 8), ("swap", 9), ("circle", 8), ("circle", 9),
             ("circle", 16), ("xor", 8), ("xor", 16), ("mirror", 8),
             ("mirror", 9)]


def test_the_port_registers_the_reference_instances():
    assert set(T_instance_names()) >= {"swap", "circle", "xor", "mirror"}
    for name in ("swap", "circle", "xor", "mirror"):
        assert T_get_instance(name).isoport == R_get_instance(name).isoport


@pytest.mark.parametrize("inst,n", INSTANCES)
def test_port_and_peer_matrices_equal(inst, n):
    """repro.core.port_matrix.port_matrix, InstanceSpec.peer_matrix and
    verify_instance."""
    assert np.array_equal(T_port_matrix(inst, n), R_port_matrix(inst, n))
    assert np.array_equal(T_get_instance(inst).peer_matrix(n),
                          R_get_instance(inst).peer_matrix(n))
    assert T_verify(inst, n) == R_verify(inst, n)


@pytest.mark.parametrize("inst,n", INSTANCES)
def test_routers_and_torch_twins_equal_the_reference(inst, n):
    """repro.core.routing.route (numpy) and route_jnp (the jnp twin)
    against the port's route and route_torch, over every ordered pair."""
    a, b = (np.array(x) for x in zip(*((s, t) for s, t in
                                       itertools.product(range(n), repeat=2)
                                       if s != t)))
    want = np.asarray(R_routing.route(inst, a, b, n))
    assert np.array_equal(np.asarray(T_routing.route(inst, a, b, n)), want)
    assert np.array_equal(
        np.asarray(R_routing.route_jnp(inst, jnp.asarray(a), jnp.asarray(b),
                                       n)), want)
    for dtype in (torch.int32, torch.int64):
        got = T_routing.route_torch(inst, torch.tensor(a, dtype=dtype),
                                    torch.tensor(b, dtype=dtype), n)
        assert got.dtype == dtype
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [8, 9, 16])
def test_circle_closed_form_and_routing_costs_equal(n):
    a, b = np.meshgrid(np.arange(n), np.arange(n))
    assert np.array_equal(T_routing.route_circle_closed(a, b, n),
                          R_routing.route_circle_closed(a, b, n))
    for inst in ("swap", "circle", "xor", "mirror"):
        assert T_routing.routing_ops(inst) == R_routing.routing_ops(inst)


@pytest.mark.parametrize("inst,n", [("circle", 9), ("xor", 16), ("swap", 8),
                                    ("mirror", 9)])
def test_cin_closed_forms_equal(inst, n):
    """repro.core.simulate.cin_link_loads, all_to_all_steps and
    schedule_step_report."""
    assert T_simulate.cin_link_loads(inst, n) == \
        R_simulate.cin_link_loads(inst, n)
    assert T_simulate.all_to_all_steps(inst, n) == \
        R_simulate.all_to_all_steps(inst, n)
    assert [vars(r) for r in T_simulate.schedule_step_report(inst, n)] == \
        [vars(r) for r in R_simulate.schedule_step_report(inst, n)]
    flows = [(0, n - 1, 1.0), (1, 2, 0.5)]
    assert T_simulate.valiant_link_loads(inst, n, flows) == \
        R_simulate.valiant_link_loads(inst, n, flows)


@pytest.mark.parametrize("dims,inst", [((4, 4), "xor"), ((3, 5), "circle"),
                                       ((4, 2, 2), "xor")])
def test_hyperx_link_loads_equal(dims, inst):
    """repro.core.simulate.hyperx_link_loads (exact, every pair)."""
    assert T_simulate.hyperx_link_loads(T_HyperX(dims, 2, inst)) == \
        R_simulate.hyperx_link_loads(R_HyperX(dims, 2, inst))


@pytest.mark.parametrize("a,p,h,g,local,glob", [
    (4, 2, 2, 9, "circle", "circle"), (6, 3, 2, 12, "circle", "circle"),
    (4, 2, 2, 8, "xor", "xor"), (4, 2, 2, 5, "mirror", "mirror")])
def test_dragonfly_link_loads_equal(a, p, h, g, local, glob):
    """repro.core.simulate.dragonfly_link_loads."""
    assert T_simulate.dragonfly_link_loads(
        T_Dragonfly(a, p, h, g, local, glob)) == \
        R_simulate.dragonfly_link_loads(R_Dragonfly(a, p, h, g, local, glob))
