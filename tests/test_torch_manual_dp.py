"""repro_torch.runtime.manual_dp against repro.runtime.manual_dp, on the
CPU: the LACIN gradient all-reduce and the explicit data-parallel train
step.

The reference runs ``make_manual_dp_train_step`` in one child process on
4 forced host devices, as tests/test_distributed_runtime.py runs it; the
port runs it on one gloo group of 4 ranks, each a process with a
``FileStore`` under the test's temporary directory (the launcher of
tests/test_torch_collectives.py).  Both start from the reference's
``init_train_state(PRNGKey(1))`` (the port's ranks restore it from a
checkpoint this test writes) and take the same global batches, in fp32.

Tolerances: losses rtol 1e-5, plain and int8-compressed.  Parameters
after 4 steps of lr 1e-4: without compression atol 1e-5 (AdamW moves an
entry by at most lr a step; entries whose gradient is near 0 differ by a
few percent of that, as in tests/test_torch_train.py); with compression
atol 1e-4, one step's lr, and 99% of the entries within 1e-5: a scattered
shard entry within an ulp of a rounding boundary of the int8 quantizer
takes neighbouring codes in the two packages, one quantum (max |g| / 127)
apart, and AdamW turns that into up to a step on an entry whose gradient
is small.  The all-reduce of gradients without
compression bit for bit (the same addends in the same step order); with
int8 compression the error against the uncompressed mean under 0.02 of
its largest entry, the bound tests/test_distributed_runtime.py holds the
reference to.
"""
import jax
import numpy as np
import pytest

from repro.models import get_config as jax_get_config
from repro.runtime.trainer import init_train_state as jax_init_train_state

from repro_torch.checkpoint import CheckpointManager

from test_torch_collectives import (join_ranks, join_reference, start_ranks,
                                    start_reference)

WORLD, STEPS = 4, 4

_COMMON = r"""
import dataclasses
import numpy as np

def make_batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        tok = rng.integers(0, 256, (8, 16)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
    return out

def make_grads():
    rng = np.random.default_rng(2)
    return rng.normal(size=(4, 1000)).astype(np.float32)

OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)


# lacin-demo reduced to one layer, in fp32: the step, not the depth, is
# under test, and the reference's compile time grows with the leaves its
# LACIN chains reduce.
def small(cfg):
    return dataclasses.replace(cfg.reduced(), num_layers=1,
                               block_pattern=("attn",), windows=(0,),
                               dtype="float32")
"""

_REF_CHILD = _COMMON + r"""
import sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro._compat.jaxapi import shard_map
from repro.fabric import LacinCollectives
from repro.models import get_config
from repro.optim import OptConfig
from repro.runtime.manual_dp import (lacin_grad_allreduce,
                                     make_manual_dp_train_step)
from repro.runtime.trainer import init_train_state

cfg = small(get_config("lacin-demo"))
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
out = {}
for compress in (False, True):
    step = make_manual_dp_train_step(cfg, mesh, OptConfig(**OPT),
                                     compress=compress)
    st = init_train_state(jax.random.PRNGKey(1), cfg)
    losses = []
    for b in make_batches():
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    out[f"loss_{compress}"] = np.asarray(losses)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(st["params"])):
        out[f"p_{compress}_{i}"] = np.asarray(leaf)
for compress in (False, True):
    red = jax.jit(shard_map(lambda g: lacin_grad_allreduce(
        {"w": g}, "data", LacinCollectives(), compress=compress)["w"],
        mesh=mesh, in_specs=P("data"), out_specs=P("data")))
    out[f"ar_{compress}"] = np.asarray(red(jnp.asarray(make_grads())))
np.savez(sys.argv[1], **out)
"""

_PORT_RANK = _COMMON + r"""
import datetime, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.collectives import record_collectives
from repro_torch.fabric import LacinCollectives
from repro_torch.models import get_config
from repro_torch.models.convert import (numpy_from_params,
                                        train_state_from_numpy,
                                        train_state_like)
from repro_torch.optim import OptConfig
from repro_torch.runtime.manual_dp import (lacin_grad_allreduce,
                                           make_manual_dp_train_step)
from repro_torch.runtime.trainer import init_train_state


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


cfg = small(get_config("lacin-demo"))
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
mgr = CheckpointManager(f"{outdir}/../init")
like = train_state_like(init_train_state(0, cfg, device="cpu"), cfg)
out = {}
for compress in (False, True):
    step = make_manual_dp_train_step(cfg, mesh, OptConfig(**OPT),
                                     compress=compress)
    st = train_state_from_numpy(mgr.restore(0, like), cfg, device="cpu")
    losses = []
    for i, b in enumerate(make_batches()):
        if i == 0 and not compress:
            with record_collectives() as ops:
                st, m = step(st, b)
            out["recorded"] = np.asarray(
                [[o.kind == "all-reduce", o.raw_bytes, o.group_size]
                 for o in ops])
        else:
            st, m = step(st, b)
        losses.append(float(m["loss"]))
    out[f"loss_{compress}"] = np.asarray(losses)
    for i, leaf in enumerate(leaves(numpy_from_params(st["params"], cfg))):
        out[f"p_{compress}_{i}"] = leaf
    g = torch.from_numpy(make_grads()[rank:rank + 1])
    out[f"ar_{compress}"] = lacin_grad_allreduce(
        {"w": g}, "data", LacinCollectives(mesh=mesh),
        compress=compress)["w"].numpy()
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, one dict per port rank), run at once."""
    tmp = tmp_path_factory.mktemp("manual_dp")
    scope = {}
    exec(_COMMON, scope)
    cj = scope["small"](jax_get_config("lacin-demo"))
    state = jax.tree_util.tree_map(
        np.asarray, jax_init_train_state(jax.random.PRNGKey(1), cj))
    CheckpointManager(tmp / "init").save(0, state, blocking=True)
    ref = start_reference(_REF_CHILD, tmp / "ref.npz")
    port = start_ranks(_PORT_RANK, WORLD, tmp / "ranks")
    return join_reference(ref), join_ranks(port)


@pytest.mark.parametrize("compress", [False, True])
def test_manual_dp_step_matches_reference(runs, compress):
    """Losses of 4 steps and the parameters after them, on every rank."""
    ref, ranks = runs
    n = len([k for k in ref if k.startswith(f"p_{compress}_")])
    assert n > 0
    for out in ranks:
        np.testing.assert_allclose(out[f"loss_{compress}"],
                                   ref[f"loss_{compress}"], rtol=1e-5)
        diff = []
        for i in range(n):
            np.testing.assert_allclose(out[f"p_{compress}_{i}"],
                                       ref[f"p_{compress}_{i}"], rtol=0,
                                       atol=1e-4 if compress else 1e-5)
            assert np.array_equal(out[f"p_{compress}_{i}"],
                                  ranks[0][f"p_{compress}_{i}"])
            diff.append(np.abs(out[f"p_{compress}_{i}"]
                               - ref[f"p_{compress}_{i}"]).ravel())
        assert np.mean(np.concatenate(diff) > 1e-5) < 0.01
    assert ref[f"loss_{compress}"][-1] < ref[f"loss_{compress}"][0]


def test_lacin_grad_allreduce_matches_reference(runs):
    """Without compression the mean of every rank's gradients bit for bit;
    with int8 compression within 0.02 of its largest entry."""
    ref, ranks = runs
    plain = np.concatenate([o["ar_False"] for o in ranks])
    assert np.array_equal(plain, ref["ar_False"])
    packed = np.concatenate([o["ar_True"] for o in ranks])
    scale = np.abs(plain).max()
    assert np.abs(packed - plain).max() / scale < 0.02
    assert np.abs(ref["ar_True"] - ref["ar_False"]).max() / scale < 0.02


def test_manual_dp_loss_is_one_library_all_reduce(runs):
    """The loss is averaged as the reference's ``lax.pmean`` is: one
    library all-reduce of 4 B, where its HLO has one; the gradients go
    through the LACIN chains, 2(N-1) matching steps a leaf."""
    _, ranks = runs
    for out in ranks:
        rec = out["recorded"]
        reduces = rec[rec[:, 0] == 1]
        assert reduces.tolist() == [[1, 4, WORLD]]
        permutes = rec[rec[:, 0] == 0]
        assert len(permutes) > 0 and len(permutes) % (2 * (WORLD - 1)) == 0
        assert np.array_equal(rec, ranks[0]["recorded"])
