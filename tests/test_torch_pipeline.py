"""repro_torch.runtime.pipeline against the sequential forward and against
repro.runtime.pipeline, on the CPU.

Two single-run stacks in fp32: lacin-demo reduced (4 attention layers,
B4 T16) and xlstm-350m reduced with every layer an mLSTM block (B4 T256:
each microbatch's length is the mLSTM chunk, so the port's layers take the
scan's autograd Function).  The reference's ``init_params(PRNGKey(0))``
goes to both sides (the port's ranks restore it from a checkpoint this
test writes).  The port runs the GPipe loss on one
gloo group of 4 ranks (the launcher of tests/test_torch_collectives.py),
the reference on 4 of 8 forced host devices, as tests/test_pipeline.py
runs it.  The port's gradient of the replicated parameters is the mean
over the ranks of each rank's autograd gradient (the library all-reduce's
backward sums them; see ``make_pipeline_loss_fn``).

Tolerances: loss rtol 1e-5; every gradient leaf within 1e-5 of its
largest entry (the mLSTM stack's within 1e-4 against the reference),
against the port's sequential ``forward_train`` and against the
reference's ``jax.grad`` of its pipeline (fp32 on both sides: the same
sums in other orders; the mLSTM's h = num / den amplifies their rounding
where |den| is small, as tests/test_torch_xlstm.py says, and its embedding
gradient differs from the reference's by 1.6e-5 of its largest entry).
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
MLSTM_GRAD_TOL = 1e-4          # against the reference

_COMMON = r"""
import dataclasses
import numpy as np

# name: (arch, fields replaced in the reduced config, sequence length)
STACKS = {"demo": ("lacin-demo", {}, 16),
          "mlstm": ("xlstm-350m", {"block_pattern": ("mlstm",) * 4}, 256)}

def small(get_config, name):
    arch, fields, _ = STACKS[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **fields)

def make_batch(name):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 256, (4, STACKS[name][2])).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
"""

_REF_CHILD = _COMMON + r"""
import sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import NO_SHARD, forward_train, get_config, init_params
from repro.runtime.pipeline import make_pipeline_loss_fn

mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
out = {}
for name in STACKS:
    cfg = small(get_config, name)
    params = init_params(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in make_batch(name).items()}
    pipe = make_pipeline_loss_fn(cfg, mesh, n_micro=2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: pipe(p, batch)))(params)
    out[f"{name}/loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
        out[f"{name}/g_{i}"] = np.asarray(g)
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


mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
out = {}
for name in STACKS:
    cfg = small(get_config, name)
    like = shapes_from_params(init_params(0, cfg, device="cpu"), cfg)
    params = params_from_numpy(CheckpointManager(
        f"{outdir}/../init_{name}").restore(0, like), cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in make_batch(name).items()}
    pipe = make_pipeline_loss_fn(cfg, mesh, n_micro=2)

    flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(flat)
    live = tree_map(lambda _, p: next(it), params)
    loss = pipe(live, batch)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    # the mean over the ranks: each rank holds its stage's part, times world
    grads = [library_all_reduce(g) / world for g in grads]
    it = iter(grads)
    out[f"{name}/loss"] = loss.detach().numpy()
    for i, g in enumerate(leaves(numpy_from_params(
            tree_map(lambda _, p: next(it), params), cfg))):
        out[f"{name}/g_{i}"] = g
    seq_loss, _, seq_grads = loss_and_grads(params, batch, cfg)
    out[f"{name}/seq_loss"] = seq_loss.numpy()
    for i, g in enumerate(leaves(numpy_from_params(seq_grads, cfg))):
        out[f"{name}/seq_g_{i}"] = g
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
    for name in scope["STACKS"]:
        cj = scope["small"](jax_get_config, name)
        params = jax.tree_util.tree_map(
            np.asarray, jax_init_params(jax.random.PRNGKey(0), cj))
        CheckpointManager(tmp / f"init_{name}").save(0, params,
                                                     blocking=True)
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


def _check_loss(runs, stack):
    ref, ranks = runs
    key = f"{stack}/loss"
    for out in ranks:
        np.testing.assert_allclose(out[key], out[f"{stack}/seq_loss"],
                                   rtol=TOL)
        np.testing.assert_allclose(out[key], ref[key], rtol=TOL)
        assert np.array_equal(out[key], ranks[0][key])


def _check_gradients(runs, stack, against, tol=TOL):
    ref, ranks = runs
    keys = _leaf_keys(ranks[0], f"{stack}/g_")
    for out in ranks:
        for i, key in enumerate(keys):
            want = (out[f"{stack}/seq_g_{i}"] if against == "sequential"
                    else ref[key])
            assert out[key].shape == want.shape
            assert _close(out[key], want) <= tol, (key, _close(out[key],
                                                               want))
            assert np.abs(want).max() > 0


def test_pipeline_loss_matches_sequential_and_reference(runs):
    _check_loss(runs, "demo")


@pytest.mark.parametrize("against", ["sequential", "reference"])
def test_pipeline_gradients_match(runs, against):
    """Autograd through the shift's backward gives the reverse pipeline:
    every leaf, the stages' layers, the embedding and the final norm."""
    _check_gradients(runs, "demo", against)


def test_mlstm_pipeline_loss_matches_sequential_and_reference(runs):
    """A single run of mLSTM layers pipelines, as the reference's does."""
    _check_loss(runs, "mlstm")


@pytest.mark.parametrize("against", ["sequential", "reference"])
def test_mlstm_pipeline_gradients_match(runs, against):
    """Every leaf of the mLSTM stack: the gates', q, k, v and the up and
    down projections of each stage, through the scan's Function."""
    _check_gradients(runs, "mlstm", against,
                     MLSTM_GRAD_TOL if against == "reference" else TOL)


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
