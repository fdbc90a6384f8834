"""repro_torch.runtime.pipeline against the sequential forward and against
repro.runtime.pipeline, on the CPU.

lacin-demo reduced (4 uniform attention layers) in fp32, the reference's
``init_params(PRNGKey(0))`` for both sides (the port's ranks restore it
from a checkpoint this test writes).  The port runs the GPipe loss on one
gloo group of 4 ranks (the launcher of tests/test_torch_collectives.py),
the reference on 4 of 8 forced host devices, as tests/test_pipeline.py
runs it.  The port's gradient of the replicated parameters is the mean
over the ranks of each rank's autograd gradient (the library all-reduce's
backward sums them; see ``make_pipeline_loss_fn``).

Tolerances: loss rtol 1e-5; every gradient leaf within 1e-5 of its
largest entry, against the port's sequential ``forward_train`` and
against the reference's ``jax.grad`` of its pipeline (fp32 on both sides:
the same sums in other orders).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.models import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.runtime.pipeline import make_pipeline_loss_fn as jax_pipeline

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import get_config
from repro_torch.runtime.pipeline import make_pipeline_loss_fn

from test_torch_collectives import (join_ranks, join_reference, start_ranks,
                                    start_reference)

WORLD = 4
TOL = 1e-5

_COMMON = r"""
import dataclasses
import numpy as np

def small(cfg):
    return dataclasses.replace(cfg.reduced(), dtype="float32")

def make_batch():
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 256, (4, 16)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
"""

_REF_CHILD = _COMMON + r"""
import sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import NO_SHARD, forward_train, get_config, init_params
from repro.runtime.pipeline import make_pipeline_loss_fn

cfg = small(get_config("lacin-demo"))
params = init_params(jax.random.PRNGKey(0), cfg)
batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
pipe = make_pipeline_loss_fn(cfg, mesh, n_micro=2)
loss, grads = jax.jit(jax.value_and_grad(lambda p: pipe(p, batch)))(params)
out = {"loss": np.asarray(loss)}
for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
    out[f"g_{i}"] = np.asarray(g)
np.savez(sys.argv[1], **out)
"""

_PORT_RANK = _COMMON + r"""
import datetime, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.collectives import library_all_reduce
from repro_torch.models import get_config, init_params
from repro_torch.models.convert import (numpy_from_params, params_from_numpy,
                                        shapes_from_params)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.pipeline import make_pipeline_loss_fn
from repro_torch.runtime.trainer import loss_and_grads


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


cfg = small(get_config("lacin-demo"))
like = shapes_from_params(init_params(0, cfg, device="cpu"), cfg)
params = params_from_numpy(CheckpointManager(f"{outdir}/../init").restore(
    0, like), cfg, device="cpu")
batch = {k: torch.from_numpy(v).long() for k, v in make_batch().items()}
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
pipe = make_pipeline_loss_fn(cfg, mesh, n_micro=2)

flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
it = iter(flat)
live = tree_map(lambda _, p: next(it), params)
loss = pipe(live, batch)
grads = torch.autograd.grad(loss, flat, materialize_grads=True)
# the mean over the ranks: each rank holds its stage's part, times world
grads = [library_all_reduce(g) / world for g in grads]
it = iter(grads)
out = {"loss": loss.detach().numpy()}
for i, g in enumerate(leaves(numpy_from_params(
        tree_map(lambda _, p: next(it), params), cfg))):
    out[f"g_{i}"] = g
seq_loss, _, seq_grads = loss_and_grads(params, batch, cfg)
out["seq_loss"] = seq_loss.numpy()
for i, g in enumerate(leaves(numpy_from_params(seq_grads, cfg))):
    out[f"seq_g_{i}"] = g
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, one dict per port rank), run at once."""
    tmp = tmp_path_factory.mktemp("pipeline")
    scope = {}
    exec(_COMMON, scope)
    cj = scope["small"](jax_get_config("lacin-demo"))
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), cj))
    CheckpointManager(tmp / "init").save(0, params, blocking=True)
    ref = start_reference(_REF_CHILD, tmp / "ref.npz")
    port = start_ranks(_PORT_RANK, WORLD, tmp / "ranks")
    return join_reference(ref), join_ranks(port)


def _leaf_keys(out, prefix):
    n = len([k for k in out if k.startswith(prefix)])
    assert n > 0
    return [f"{prefix}{i}" for i in range(n)]


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-12)
    return float(np.abs(got - want).max()) / scale


def test_pipeline_loss_matches_sequential_and_reference(runs):
    ref, ranks = runs
    for out in ranks:
        np.testing.assert_allclose(out["loss"], out["seq_loss"], rtol=TOL)
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=TOL)
        assert np.array_equal(out["loss"], ranks[0]["loss"])


@pytest.mark.parametrize("against", ["sequential", "reference"])
def test_pipeline_gradients_match(runs, against):
    """Autograd through the shift's backward gives the reverse pipeline:
    every leaf, the stages' layers, the embedding and the final norm."""
    ref, ranks = runs
    keys = _leaf_keys(ranks[0], "g_")
    for out in ranks:
        for i, key in enumerate(keys):
            want = out[f"seq_g_{i}"] if against == "sequential" else ref[key]
            assert out[key].shape == want.shape
            assert _close(out[key], want) <= TOL, (key, _close(out[key],
                                                               want))
            assert np.abs(want).max() > 0


def test_pipeline_raises_where_the_reference_does():
    """A stack of more than one run, and layers that do not divide the
    stages: the same errors as the reference's (which raises before it
    reads more of its mesh than the axis size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    xl, xj = get_config("xlstm-350m").reduced(), \
        jax_get_config("xlstm-350m").reduced()
    demo = dataclasses.replace(get_config("lacin-demo").reduced(),
                               dtype="float32")
    demo_j = dataclasses.replace(jax_get_config("lacin-demo").reduced(),
                                 dtype="float32")
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
    try:
        for port_cfg, ref_cfg in ((xl, xj), (demo, demo_j)):
            with pytest.raises(ValueError) as want:
                jax_pipeline(ref_cfg, types.SimpleNamespace(
                    shape={"pipe": 3}))
            with pytest.raises(ValueError) as got:
                make_pipeline_loss_fn(port_cfg, None)
            assert str(got.value) == str(want.value)
    finally:
        dist.destroy_process_group()
