"""The port's 1-factor schedules, factorizations, layouts and ``Fabric``
objects (``repro_torch.core.{schedule,factorization,layout}``,
``repro_torch.fabric.fabric``) against the reference's
(``repro.core.schedule.partner_table`` / ``make_schedule``,
``repro.core.factorization``, ``repro.core.layout``,
``repro.fabric.make_fabric``).  Exact: integers, and floats from the same
numpy expressions.
"""
import dataclasses
import importlib

import numpy as np
import pytest

import repro.fabric.mirror  # noqa: F401  (registers the mirror instance)
from repro.core import layout as R_layout
from repro.core import schedule as R_sched
from repro.core.dragonfly import DragonflyConfig as R_Dragonfly
from repro.core.hyperx import HyperXConfig as R_HyperX
from repro.fabric import make_fabric as R_make_fabric

from repro_torch.core import layout as T_layout
from repro_torch.core import schedule as T_sched
from repro_torch.core.dragonfly import DragonflyConfig as T_Dragonfly
from repro_torch.core.hyperx import HyperXConfig as T_HyperX
from repro_torch.fabric import make_fabric as T_make_fabric

# The packages export a function named ``factorization`` over the module.
R_fact = importlib.import_module("repro.core.factorization")
T_fact = importlib.import_module("repro_torch.core.factorization")

#: Every registry instance at even and odd n (xor: powers of two), and the
#: schedule-only ``cyclic`` baseline.
INSTANCES = ["swap", "circle", "xor", "mirror", "cyclic"]
SIZES = [5, 8, 9, 16]


def assert_same(a, b, where="value"):
    """Equal structure and values: dicts, sequences, arrays, dataclasses."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def outcome(fn, *args):
    """``fn(*args)``, or the type of the error it raises."""
    try:
        return fn(*args)
    except (ValueError, AssertionError) as e:
        return type(e)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inst", INSTANCES)
def test_partner_tables_and_schedules_equal(inst, n):
    """repro.core.schedule.partner_table and make_schedule: the steps, the
    inverse tables, the permutations and the structural verdicts, or the
    same refusal (anisoport swap, xor at a size that is no power of two)."""
    a = outcome(R_sched.partner_table, inst, n)
    b = outcome(T_sched.partner_table, inst, n)
    assert_same(a, b, "partner_table")
    if isinstance(a, type):
        assert outcome(T_sched.make_schedule, inst, n) is a
        return
    ra, rb = R_sched.make_schedule(inst, n), T_sched.make_schedule(inst, n)
    assert_same(ra, rb, "schedule")
    for verdict in ("is_matching_per_step", "is_contention_free",
                    "covers_all_pairs"):
        assert getattr(rb, verdict)() == getattr(ra, verdict)(), verdict


@pytest.mark.parametrize("n", SIZES)
def test_auto_schedule_picks_as_the_reference(n):
    assert_same(R_sched.make_schedule("auto", n),
                T_sched.make_schedule("auto", n), "auto")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inst", ["swap", "circle", "xor", "mirror"])
def test_factorizations_and_layouts_equal(inst, n):
    """repro.core.factorization (factors, is_one_factorization,
    column_contention) and repro.core.layout (crossings, column report)."""
    from repro_torch.core.port_matrix import port_matrix
    a = outcome(R_fact.factorization, inst, n)
    assert_same(a, outcome(T_fact.factorization, inst, n), "factorization")
    p = outcome(port_matrix, inst, n)
    if isinstance(p, type):
        return
    assert T_fact.is_one_factorization(p) == R_fact.is_one_factorization(p)
    assert_same(R_fact.column_contention(p), T_fact.column_contention(p))
    for fn in ("instance_crossings", "column_report"):
        assert_same(outcome(getattr(R_layout, fn), inst, n),
                    outcome(getattr(T_layout, fn), inst, n), fn)


@pytest.mark.parametrize("n", [8, 9, 16])
def test_wire_lengths_and_table1_equal(n):
    """repro.core.layout: LACIN and Swap wire lengths, Table 1, and the
    Circle crossing rule."""
    for fn in ("wire_length_histogram", "lacin_total_wire_length",
               "lacin_total_wire_length_enumerated", "swap_total_wire_length",
               "swap_to_lacin_ratio", "table1",
               "circle_layout_crossings_with_rule"):
        assert_same(getattr(R_layout, fn)(n), getattr(T_layout, fn)(n), fn)
    if n % 2 == 0:
        assert_same(R_layout.circle_predicted_crossings(n),
                    T_layout.circle_predicted_crossings(n))


class _Mesh:
    """What the port reads of a ``torch.distributed`` ``DeviceMesh``."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]


def test_schedule_for_axis_raises_naming_its_roadmap_item():
    """Ported (ROADMAP queue A, item 9): schedule_for_axis reads the axis's
    size from a DeviceMesh and equals the reference's on a mesh of that
    shape; an axis the mesh lacks raises, naming the mesh's axes."""
    mesh = _Mesh(data=2, model=8)
    for inst in ("auto", "xor", "circle", "cyclic"):
        assert_same(R_sched.make_schedule(inst, 8),
                    T_sched.schedule_for_axis(mesh, "model", inst))
    assert T_sched.schedule_for_axis(mesh, "data").n == 2
    with pytest.raises(ValueError, match="data"):
        T_sched.schedule_for_axis(mesh, "pod")


#: (name, reference fabric, port fabric): small CIN, HyperX and Dragonfly.
FABRICS = {
    "cin-xor-8": (lambda: R_make_fabric("xor", 8),
                  lambda: T_make_fabric("xor", 8)),
    "cin-circle-9": (lambda: R_make_fabric("circle", 9),
                     lambda: T_make_fabric("circle", 9)),
    "cin-swap-8": (lambda: R_make_fabric("swap", 8),
                   lambda: T_make_fabric("swap", 8)),
    "cin-mirror-9": (lambda: R_make_fabric("mirror", 9),
                     lambda: T_make_fabric("mirror", 9)),
    "hyperx-4x4": (lambda: R_make_fabric(R_HyperX((4, 4), 2)),
                   lambda: T_make_fabric(T_HyperX((4, 4), 2))),
    "hyperx-4x4x4": (lambda: R_make_fabric(R_HyperX((4, 4, 4), 2)),
                     lambda: T_make_fabric(T_HyperX((4, 4, 4), 2))),
    "hyperx-3x3-circle": (
        lambda: R_make_fabric(R_HyperX((3, 3), 2, "circle")),
        lambda: T_make_fabric(T_HyperX((3, 3), 2, "circle"))),
    "dragonfly-a4h2g9": (lambda: R_make_fabric(R_Dragonfly(4, 2, 2, 9)),
                         lambda: T_make_fabric(T_Dragonfly(4, 2, 2, 9))),
}


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_fabrics_equal(name):
    """repro.fabric.make_fabric: names, sizes, neighbour and peer-port
    matrices, schedules, uniform link loads, deployments and verify()."""
    ra, tb = (f() for f in FABRICS[name])
    assert type(tb).__name__ == type(ra).__name__
    assert (tb.name, tb.num_switches, tb.diameter, tb.num_links) == \
        (ra.name, ra.num_switches, ra.diameter, ra.num_links)
    assert_same(ra.neighbor_matrix(), tb.neighbor_matrix(), "neighbor")
    assert_same(ra.peer_port_matrix(), tb.peer_port_matrix(), "peer")
    assert_same(ra.schedule(), tb.schedule(), "schedule")
    assert_same(ra.link_loads(), tb.link_loads(), "link_loads")
    assert_same(ra.deployment(), tb.deployment(), "deployment")
    assert_same(ra.verify(), tb.verify(), "verify")
    assert T_make_fabric(tb) is tb


def test_fabric_collectives_raise_naming_their_roadmap_item():
    """Ported (ROADMAP queue A, item 9): every fabric's collectives() binds
    the instances the reference's binds, per axis, and raises where the
    mesh's axes do not match the fabric (the reference's _check_axis)."""
    axes = {"cin-xor-8": dict(axis_name="x"),
            "cin-circle-9": dict(axis_name="x"),
            "cin-swap-8": dict(axis_name="x"),
            "hyperx-4x4": dict(axis_names=("a", "b")),
            "hyperx-3x3-circle": dict(axis_names=("a", "b")),
            "dragonfly-a4h2g9": dict(local_axis="l", global_axis="g")}
    for name, kw in axes.items():
        ra, tb = (f() for f in FABRICS[name])
        for call in ({}, kw):
            want, got = ra.collectives(None, **call), tb.collectives(None, **call)
            assert (got.instance, got.impl, got.axis_instances) == \
                (want.instance, want.impl, want.axis_instances), (name, call)
            for axis in want.axis_instances:
                assert got.axis_instance(axis) == want.axis_instance(axis)
    good = _Mesh(a=4, b=4)
    coll = FABRICS["hyperx-4x4"][1]().collectives(good, axis_names=("a", "b"))
    assert coll.mesh is good and coll.axis_size("b") == 4
    with pytest.raises(ValueError, match="size 2"):
        FABRICS["hyperx-4x4"][1]().collectives(_Mesh(a=4, b=2),
                                               axis_names=("a", "b"))
    with pytest.raises(ValueError, match="no axis 'g'"):
        FABRICS["dragonfly-a4h2g9"][1]().collectives(
            _Mesh(l=4, x=9), local_axis="l", global_axis="g")
    with pytest.raises(ValueError, match="no axis"):
        coll.axis_size("c")
