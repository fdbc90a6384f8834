"""repro_torch's LACIN collectives (core and fabric) against the JAX
reference, on the CPU, over multi-process gloo groups.

The reference side is one child process on 8 forced host devices, as
tests/test_collectives_multidev.py and tests/test_fabric_collectives.py run
it; the port side is one gloo group of 8 ranks and one of 5, each rank a
process of its own with a ``FileStore`` under the test's temporary
directory.  All three are started together and draw the same inputs from
one numpy seed (``_INPUTS``); row ``r`` of every input is rank ``r``'s.

Tolerances: all-to-all and all-gather move bytes, so they are exact.
Reduce-scatter and all-reduce add the same addends in the same step order
as the reference, so they are held bit for bit too (atol = rtol = 0).
Against the library's own ``dist.all_to_all_single`` (exact) and
``dist.all_reduce`` (its own order of addition): exact on integer-valued
inputs, rtol 1e-6 / atol 1e-6 on gaussians.  Gradients go through the
inverse exchanges on the port side and ``ppermute``'s transpose on the
reference side: rtol 1e-6 / atol 1e-6.
"""
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from repro_torch.core import schedule as T_sched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
INSTS = ("xor", "circle", "cyclic")
EXACT = dict(rtol=0, atol=0)
CLOSE = dict(rtol=1e-6, atol=1e-6)
TIMEOUT_S = 240

#: Every input, row r = rank r's.  Run in both children.
_INPUTS = r"""
import numpy as np

def make_inputs():
    rng = np.random.default_rng(19)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    d = {}
    for inst in ("xor", "circle", "cyclic"):
        d[f"a2a_{inst}"] = f(8, 8, 4, 3)
        d[f"ag_{inst}"] = f(8, 2, 5)
        d[f"rs_{inst}"] = f(8, 8, 6)
        d[f"ar_{inst}"] = f(8, 7, 3)            # 21 elements: padded to 24
    d["a2a_circle5"] = f(5, 5, 4)
    d["ag_circle5"] = f(5, 3)
    d["rs_circle5"] = f(5, 5, 6)
    d["ar_circle5"] = f(5, 7, 3)
    d["grid_2x4"] = f(8, 8, 3, 2)
    d["two_level"] = f(8, 6, 5)
    d["fabric_cin"] = f(8, 9)
    d["fabric_hyperx"] = f(8, 8, 5)
    d["fabric_dragonfly"] = rng.integers(-8, 8, (8, 7, 3)).astype(np.float32)
    d["grad_a2a"] = f(8, 8, 3)
    d["grad_a2a_w"] = f(8, 8, 3)
    d["grad_ar"] = f(8, 4)
    d["lib_ar_int"] = rng.integers(-8, 8, (8, 5, 3)).astype(np.float32)
    return d
"""

#: The reference's outputs, stacked over devices, into an npz file.
_REF_CHILD = _INPUTS + r"""
import sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro._compat.jaxapi import shard_map
from repro.core import (DragonflyConfig, HyperXConfig, all_gather_lacin,
                        all_reduce_lacin, all_to_all_lacin,
                        reduce_scatter_lacin)
from repro.fabric import LacinCollectives, make_fabric

devs = jax.devices()
assert len(devs) == 8, len(devs)
d = make_inputs()
out = {}


def run(mesh, axes, fn, x):
    return np.asarray(jax.jit(shard_map(
        lambda xl: fn(xl[0])[None], mesh=mesh, in_specs=P(axes),
        out_specs=P(axes)))(x))


mesh = Mesh(np.array(devs), ("x",))
mesh5 = Mesh(np.array(devs[:5]), ("x",))
for inst in ("xor", "circle", "cyclic"):
    kw = dict(instance=inst)
    out[f"a2a_{inst}"] = run(mesh, "x", lambda v: all_to_all_lacin(v, "x", **kw),
                             d[f"a2a_{inst}"])
    out[f"ag_{inst}"] = run(mesh, "x", lambda v: all_gather_lacin(v, "x", **kw),
                            d[f"ag_{inst}"])
    out[f"agt_{inst}"] = run(mesh, "x", lambda v: all_gather_lacin(
        v, "x", tiled=True, **kw), d[f"ag_{inst}"])
    out[f"rs_{inst}"] = run(mesh, "x", lambda v: reduce_scatter_lacin(
        v, "x", **kw), d[f"rs_{inst}"])
    out[f"ar_{inst}"] = run(mesh, "x", lambda v: all_reduce_lacin(v, "x", **kw),
                            d[f"ar_{inst}"])
for name, fn in (("a2a", all_to_all_lacin), ("ag", all_gather_lacin),
                 ("rs", reduce_scatter_lacin), ("ar", all_reduce_lacin)):
    out[f"{name}_circle5"] = run(mesh5, "x", lambda v: fn(
        v, "x", instance="circle"), d[f"{name}_circle5"])

mesh24 = Mesh(np.array(devs).reshape(2, 4), ("a", "b"))
out["grid_2x4"] = run(mesh24, ("a", "b"), lambda v: LacinCollectives(
    mesh=mesh24).all_to_all_grid(v, ("a", "b")), d["grid_2x4"])
meshd = Mesh(np.array(devs).reshape(2, 4), ("g", "l"))
colld = LacinCollectives(mesh=meshd,
                         axis_instances=(("l", "circle"), ("g", "circle")))
out["two_level"] = run(meshd, ("g", "l"), lambda v: colld.all_reduce_two_level(
    v, "l", "g"), d["two_level"])

cin = make_fabric("xor", 8).collectives(mesh, axis_name="x")
out["fabric_cin"] = run(mesh, "x", lambda v: cin.all_reduce(v, "x"),
                        d["fabric_cin"])
hx = make_fabric(HyperXConfig((2, 4), 2)).collectives(
    mesh24, axis_names=("a", "b"))
out["fabric_hyperx"] = run(mesh24, ("a", "b"), lambda v: hx.all_to_all_grid(
    v, ("a", "b")), d["fabric_hyperx"])
df = make_fabric(DragonflyConfig(4, 2, 1, 5, local_instance="circle",
                                 global_instance="mirror")).collectives(
    meshd, local_axis="l")
out["fabric_dragonfly"] = run(meshd, ("g", "l"), lambda v: df.all_reduce_two_level(
    v, "l", "g"), d["fabric_dragonfly"])


def grad_of(fn, x):
    def loss(x_):
        return jnp.sum(shard_map(lambda xl: fn(xl[0])[None], mesh=mesh,
                                 in_specs=P("x"), out_specs=P("x"))(x_))
    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))


w = jnp.asarray(d["grad_a2a_w"])
out["grad_a2a"] = grad_of(lambda v: all_to_all_lacin(v, "x")
                          * w[jax.lax.axis_index("x")], d["grad_a2a"])
out["grad_ar"] = grad_of(lambda v: all_reduce_lacin(v, "x") ** 2, d["grad_ar"])
np.savez(sys.argv[1], **out)
"""

#: One rank of the port's side: its outputs, exchange counts and the
#: library's outputs into out_<rank>.npz.
_PORT_RANK = _INPUTS + r"""
import datetime, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.core import collectives as C
from repro_torch.core import DragonflyConfig, HyperXConfig
from repro_torch.core.schedule import schedule_for_axis
from repro_torch.fabric import LacinCollectives, make_fabric

d = {k: torch.from_numpy(v[rank]) for k, v in make_inputs().items()
     if v.shape[0] == world}
out = {}


def counted(key, fn, *args, **kw):
    before = C.exchanges
    out[key] = fn(*args, **kw).detach().numpy()
    out["n_" + key] = np.int64(C.exchanges - before)


mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("x",))
g = mesh.get_group("x")
if world == 8:
    for inst in ("xor", "circle", "cyclic"):
        counted(f"a2a_{inst}", C.all_to_all_lacin, d[f"a2a_{inst}"], g,
                instance=inst)
        counted(f"ag_{inst}", C.all_gather_lacin, d[f"ag_{inst}"], g,
                instance=inst)
        counted(f"agt_{inst}", C.all_gather_lacin, d[f"ag_{inst}"], g,
                instance=inst, tiled=True)
        counted(f"rs_{inst}", C.reduce_scatter_lacin, d[f"rs_{inst}"], g,
                instance=inst)
        counted(f"ar_{inst}", C.all_reduce_lacin, d[f"ar_{inst}"], g,
                axis_size=8, instance=inst)
    mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("a", "b"))
    counted("grid_2x4", LacinCollectives(mesh=mesh24).all_to_all_grid,
            d["grid_2x4"], ("a", "b"))
    meshd = init_device_mesh("cpu", (2, 4), mesh_dim_names=("g", "l"))
    colld = LacinCollectives(mesh=meshd,
                             axis_instances=(("l", "circle"), ("g", "circle")))
    counted("two_level", colld.all_reduce_two_level, d["two_level"], "l", "g")
    counted("fabric_cin", make_fabric("xor", 8).collectives(
        mesh, axis_name="x").all_reduce, d["fabric_cin"], "x")
    hx = make_fabric(HyperXConfig((2, 4), 2)).collectives(
        mesh24, axis_names=("a", "b"))
    counted("fabric_hyperx", hx.all_to_all_grid, d["fabric_hyperx"],
            ("a", "b"))
    dfab = make_fabric(DragonflyConfig(4, 2, 1, 5, local_instance="circle",
                                       global_instance="mirror"))
    try:
        dfab.collectives(meshd, local_axis="l", global_axis="g")
        out["fabric_mesh_check"] = np.bool_(False)   # g is 2, not 5 groups
    except ValueError:
        out["fabric_mesh_check"] = np.bool_(True)
    counted("fabric_dragonfly", dfab.collectives(
        meshd, local_axis="l").all_reduce_two_level, d["fabric_dragonfly"],
        "l", "g")
    out["sched_b"] = np.asarray(schedule_for_axis(mesh24, "b").table)
    out["sched_g_circle"] = np.asarray(
        schedule_for_axis(meshd, "g", "circle").table)

    # gradients through the exchanges (backward = the inverse exchange)
    x = d["grad_a2a"].clone().requires_grad_(True)
    (C.all_to_all_lacin(x, g) * d["grad_a2a_w"]).sum().backward()
    out["grad_a2a"] = x.grad.numpy()
    x = d["grad_ar"].clone().requires_grad_(True)
    (C.all_reduce_lacin(x, g) ** 2).sum().backward()
    out["grad_ar"] = x.grad.numpy()

    # the library's own collectives on the same inputs
    lib = torch.empty_like(d["a2a_xor"])
    dist.all_to_all_single(lib, d["a2a_xor"].contiguous(), group=g)
    out["lib_a2a"] = lib.numpy()
    out["lib_ar"] = C.library_all_reduce(d["ar_xor"], g).numpy()
    for impl in ("lacin", "xla"):
        coll = LacinCollectives(mesh=mesh, impl=impl)
        out[f"lib_ar_int_{impl}"] = coll.psum(d["lib_ar_int"], "x").numpy()
    try:
        C.all_to_all_lacin(d["a2a_xor"], g, axis_size=4)
        out["size_check"] = np.bool_(False)
    except ValueError:
        out["size_check"] = np.bool_(True)
else:
    for name, fn in (("a2a", C.all_to_all_lacin), ("ag", C.all_gather_lacin),
                     ("rs", C.reduce_scatter_lacin),
                     ("ar", C.all_reduce_lacin)):
        counted(f"{name}_circle5", fn, d[f"{name}_circle5"], g,
                instance="circle")
    # 'auto' takes circle at an odd size, through the mesh-less front-end
    counted("a2a_auto5", LacinCollectives().all_to_all, d["a2a_circle5"], g)
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", **out)
"""


def start_ranks(script: str, world: int, tmp, env=None):
    """``world`` processes of ``script`` (argv: rank, world, FileStore
    path, output directory), started now; :func:`join_ranks` collects
    them."""
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    env = dict(env or os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return tmp, [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), store, str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def join_ranks(started, timeout=TIMEOUT_S):
    """Wait for every rank (a deadlock fails here, not hangs the suite);
    returns one dict of numpy outputs per rank."""
    tmp, procs = started
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    errors = []
    try:
        for r, p in enumerate(procs):
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                _, err = p.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r}: no result in {timeout} s")
                continue
            if p.returncode:
                errors.append(f"rank {r}: exit {p.returncode}\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    outs = []
    for r in range(len(procs)):
        with np.load(os.path.join(tmp, f"out_{r}.npz")) as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def start_reference(script: str, out_path):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return out_path, subprocess.Popen(
        [sys.executable, "-c", script, str(out_path)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def join_reference(started, timeout=TIMEOUT_S):
    out_path, p = started
    try:
        _, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-3000:]
    with np.load(out_path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port at 8 ranks, port at 5 ranks), run at once."""
    tmp = tmp_path_factory.mktemp("collectives")
    ref = start_reference(_REF_CHILD, tmp / "ref.npz")
    p8 = start_ranks(_PORT_RANK, 8, tmp / "w8")
    p5 = start_ranks(_PORT_RANK, 5, tmp / "w5")
    return join_reference(ref), join_ranks(p8), join_ranks(p5)


def _stacked(outs, key):
    return np.stack([o[key] for o in outs])


def _inputs():
    scope = {}
    exec(_INPUTS, scope)
    return scope["make_inputs"]()


@pytest.mark.parametrize("inst", INSTS)
@pytest.mark.parametrize("chain", ["a2a", "ag", "agt", "rs", "ar"])
def test_chains_equal_reference_on_8_ranks(runs, chain, inst):
    """repro.core.collectives at N = 8, bit for bit; N-1 exchanges a
    chain, 2(N-1) for all-reduce."""
    ref, p8, _ = runs
    key = f"{chain}_{inst}"
    np.testing.assert_allclose(_stacked(p8, key), ref[key], **EXACT)
    assert {int(o["n_" + key]) for o in p8} == {14 if chain == "ar" else 7}


@pytest.mark.parametrize("chain", ["a2a", "ag", "rs", "ar"])
def test_circle_chains_equal_reference_on_5_ranks(runs, chain):
    """Odd N: the Circle schedule's idle step keeps the rank's own chunk
    and posts nothing, so every rank still makes N-1 (2(N-1)) exchanges."""
    ref, _, p5 = runs
    key = f"{chain}_circle5"
    np.testing.assert_allclose(_stacked(p5, key), ref[key], **EXACT)
    assert {int(o["n_" + key]) for o in p5} == {8 if chain == "ar" else 4}


def test_auto_instance_and_mesh_less_front_end_on_5_ranks(runs):
    ref, _, p5 = runs
    np.testing.assert_allclose(_stacked(p5, "a2a_auto5"), ref["a2a_circle5"],
                               **EXACT)


@pytest.mark.parametrize("key", ["grid_2x4", "two_level"])
def test_hierarchical_schedules_equal_reference(runs, key):
    """repro.fabric.collectives: the (2, 4) grid all-to-all (1 + 3
    exchanges) and the two-level all-reduce with a = 4, g = 2 (2*3 local +
    2*1 global)."""
    ref, p8, _ = runs
    np.testing.assert_allclose(_stacked(p8, key), ref[key], **EXACT)
    assert {int(o["n_" + key]) for o in p8} == {4 if key == "grid_2x4" else 8}


@pytest.mark.parametrize("key", ["fabric_cin", "fabric_hyperx",
                                 "fabric_dragonfly"])
def test_fabric_bound_collectives_equal_reference(runs, key):
    """Fabric.collectives(mesh, ...) of each fabric kind, bound to a
    DeviceMesh, against the reference's on the same mesh shape."""
    ref, p8, _ = runs
    np.testing.assert_allclose(_stacked(p8, key), ref[key], **EXACT)


def test_fabric_checks_the_mesh_and_the_size_check(runs):
    _, p8, _ = runs
    assert all(bool(o["fabric_mesh_check"]) for o in p8)
    assert all(bool(o["size_check"]) for o in p8)


@pytest.mark.parametrize("key", ["grad_a2a", "grad_ar"])
def test_gradients_flow_through_the_schedule(runs, key):
    """Backward runs the inverse exchange: the gradients equal jax.grad's
    through ppermute's transpose."""
    ref, p8, _ = runs
    got = _stacked(p8, key)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], **CLOSE)


def test_chains_equal_the_library_collectives(runs):
    """dist.all_to_all_single (exact) and dist.all_reduce (its own order
    of addition) on the same inputs; LacinCollectives.psum with
    impl='lacin' and impl='xla' (the library's) on integer values."""
    _, p8, _ = runs
    for o in p8:
        np.testing.assert_allclose(o["a2a_xor"], o["lib_a2a"], **EXACT)
        np.testing.assert_allclose(o["ar_xor"], o["lib_ar"], **CLOSE)
        np.testing.assert_allclose(o["lib_ar_int_lacin"], o["lib_ar_int_xla"],
                                   **EXACT)
    want = _inputs()["lib_ar_int"].sum(0)
    np.testing.assert_allclose(p8[0]["lib_ar_int_lacin"], want, **EXACT)


def test_schedule_for_axis_reads_the_device_mesh(runs):
    """core.schedule.schedule_for_axis(mesh, axis) on a DeviceMesh: the
    schedule of the axis's size."""
    _, p8, _ = runs
    assert p8[0]["sched_b"].tolist() == [list(r) for r in
                                         T_sched.make_schedule("xor", 4).table]
    assert p8[3]["sched_g_circle"].tolist() == [
        list(r) for r in T_sched.make_schedule("circle", 2).table]


def test_collectives_need_a_process_group():
    """Outside an initialised group the chains raise, as the reference's
    do outside shard_map."""
    from repro_torch.core import all_to_all_lacin
    with pytest.raises((RuntimeError, ValueError)):
        all_to_all_lacin(torch.zeros(2, 3))
