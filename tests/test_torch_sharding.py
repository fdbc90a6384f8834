"""repro_torch.runtime.sharding, the sharded train step, the sharded
checkpoint and the loop on a mesh, on the CPU.

(a) Specs: the port's ``param_specs``, ``opt_state_specs``,
``grad_accum_specs``, ``state_specs``, ``train_batch_specs`` and
``cache_specs`` against repro.runtime.sharding's, entry by entry, for every
architecture on two stand-in meshes (16 x 16 and 2 x 4 x 2, no process
group), the port's per-layer specs stacked back to the reference's layout.
Where the reference shards a leaf's stacked layer axis (hymba-1.5b's SSM
leaves, ROADMAP C23), the port's spec is the reference's rule on the
layer's own shape.

(b)-(d) run in one spawn of 8 gloo ranks (a (4, 2) mesh, "data" x
"model") and then one of 4 (a (2, 2) mesh), each rank a process of one
torch thread, as tests/test_torch_manual_dp.py launches them.  Each rank
restores the initial train state from a checkpoint this test writes (the
reference's ``init_params(PRNGKey(0))``), with ``shardings=`` by
``state_specs``, and the ranks lower ``FSDP_MIN_ELEMS`` to 4096 so that
ZeRO-extended leaves occur in the reduced models; (a) holds the real
threshold at full size.

(b) Two sharded steps (``grad_specs=grad_accum_specs``) against two steps
of the single-device port step on the same global batches: the reduced
llama3.2-3b, its labels < 0 spread unevenly over the dp ranks, and
granite-moe-3b-a800m (experts over "model": the expert-parallel MoE) on
(4, 2), llama3.2-3b with ``grad_accum=2`` and granite on (2, 2), and
whisper-base (its frames split over dp like the tokens, the encoder
trained through the cross-attention) on (2, 1), a third spawn of 2 ranks
beside the 4.  On a "model" axis of 2 the step computes the ``ATTN``
blocks, the embedding and the loss on "model" slices (tensor parallelism,
models/layers.py), so the same cases also run in a fourth spawn of 2
ranks on a (1, 2) mesh: the same slices and the same sums over "model",
without dp or ZeRO.  Losses rtol 1e-6 of the single-device step; each
rank's local shard of every parameter is within one lr of the slice its
spec gives of the single-device result everywhere, and, wherever the
entry's m (the gradients' running mean) is at least SMALL_GRAD of its
leaf's largest, within rtol 1e-5 atol 1e-6 of the same step's parameters
without dp: the single-device result where "model" is 1, else the (1, 2)
run's within TP_BOUND times that.  AdamW's step is a ratio of gradients
that the dp sums, and the tensor-parallel products and norms, round in
another order, and the first step's update of an entry whose gradient is
within rounding of zero moves the second step's gradients.  Readings, of
the entries above SMALL_GRAD, as a share of rtol 1e-5 atol 1e-6: whole
layers on every "model" rank against the single device, 0.94 at most;
the tensor-parallel step against the single device, 9.8 (2.3e-5, 0.023
lr, on one of granite's expert entries; tests/test_torch_tensor_parallel.py
holds it to the single device at its own stated tolerance), and against
the (1, 2) run 1.41 (one entry of llama's (4, 2) case).  granite runs at
capacity factor 4, where no token is dropped: a sharded MoE step buckets
each dp shard's tokens by its own capacity, the reference's ``shard_map``
too, where the single-device step buckets the whole batch's (C24).  The
llama (4, 2) case is also held to the reference's jitted single-device
step (tests/test_torch_train.py's tolerances).  Each local shard's shape
is its spec's arithmetic.

(c) The elastic restore: 8 ranks save lacin-demo's train state with the
embedding sharded over "model" on (4, 2) (tests/test_distributed_runtime.
py's case); 4 fresh ranks restore it onto (2, 2) with ``shardings=``, equal
to the bit.  The ``data.npz`` bytes equal an unsharded save's, and the
reference's CheckpointManager reads the checkpoint.

(d) ``run_training`` on (2, 2) with one injected failure: the unsharded
run's losses, rtol 1e-6.
"""
import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.layers import AxisRules as JRules
from repro.optim import OptConfig as JOpt
from repro.runtime import sharding as JS
from repro.runtime import trainer as JTR

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig
from repro_torch.models import get_config, list_archs
from repro_torch.models.convert import (numpy_from_params, shapes_from_params,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.layers import AxisRules
from repro_torch.models.transformer import param_shapes
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import loop as TL
from repro_torch.runtime import sharding as S
from repro_torch.runtime import trainer as TTR

from test_torch_collectives import join_ranks, start_ranks

SMALL_GRAD = 1e-4
#: the strict parameter bound's factor where "model" is 2 (the docstring)
TP_BOUND = 2.0

_COMMON = r"""
import dataclasses
import numpy as np

SMALL_FSDP = 4096
MESH = {8: (4, 2), 4: (2, 2), 2: (2, 1)}
TP_ONLY = (1, 2)     # the "model" cases without dp: the tp spawn's mesh
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# case: (arch, grad_accum, uneven labels, world)
CASES = {"llama": ("llama3.2-3b", 1, True, 8),
         "granite": ("granite-moe-3b-a800m", 1, False, 8),
         "llama_ga2": ("llama3.2-3b", 2, False, 4),
         "granite_22": ("granite-moe-3b-a800m", 1, False, 4),
         "whisper_21": ("whisper-base", 1, False, 2)}


def config(get_config, arch):
    extra = {"capacity_factor": 4.0} if "granite" in arch else {}
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **extra)


def small_demo(get_config):
    return dataclasses.replace(get_config("lacin-demo").reduced(),
                               dtype="float32")


# global batches of 8 rows; with an encoder-decoder cfg each also carries
# seeded frames x 0.02
def batches(vocab, uneven, steps=2, cfg=None):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        lab = np.roll(tok, -1, axis=1)
        if uneven:      # dp rank 0's rows mostly ignored, rank 2's one row
            lab[0:2, 3:] = -100
            lab[4, :] = -1
        out.append({"tokens": tok, "labels": lab})
        if cfg is not None and cfg.is_encdec:
            out[-1]["frames"] = (rng.normal(size=(
                8, cfg.encoder_seq_len, cfg.d_model)) * 0.02).astype(
                    np.float32)
    return out


# {"/key/index/...": leaf} over nested dicts and lists
def by_path(tree, path=""):
    if isinstance(tree, dict):
        items = [(f"{path}/{k}", v) for k, v in tree.items()]
    elif isinstance(tree, list):
        items = [(f"{path}/{i}", v) for i, v in enumerate(tree)]
    else:
        return {path: tree}
    return {n: x for k, v in items for n, x in by_path(v, k).items()}


LOOP_DATA = dict(seq_len=16, global_batch=8)
LOOP = dict(total_steps=6, ckpt_every=2, log_every=1)
"""

_RANK = _COMMON + r"""
import datetime, os, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=180))
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig
from repro_torch.models import get_config
from repro_torch.models.convert import (train_state_from_reference,
                                        train_state_like,
                                        train_state_to_reference)
from repro_torch.optim import OptConfig
from repro_torch.runtime import loop as TL, sharding as S, trainer as T

S.FSDP_MIN_ELEMS = SMALL_FSDP
tp_only = os.environ.get("SHARDING_TP_ONLY") == "1"
mesh = init_device_mesh("cpu", TP_ONLY if tp_only else MESH[world],
                        mesh_dim_names=("data", "model"))
rules = T.make_rules(mesh)
root = outdir + "/.."
out = {}
for case, (arch, ga, uneven, w) in CASES.items():
    if (MESH[w][1] != TP_ONLY[1]) if tp_only else w != world:
        continue
    cfg = config(get_config, arch)
    fresh = T.init_train_state(0, cfg, device="cpu")
    specs = S.state_specs(fresh["params"], cfg, rules)
    state = train_state_from_reference(CheckpointManager(
        f"{root}/init/{arch}").restore(
            0, train_state_like(fresh, cfg),
            shardings=S.checkpoint_shardings(specs, cfg, mesh)), cfg)
    del fresh
    step = T.make_train_step(cfg, rules, OptConfig(**OPT), grad_accum=ga,
                             grad_specs=S.grad_accum_specs(
                                 state["params"], cfg, rules))
    losses = []
    for b in batches(cfg.vocab_size, uneven, cfg=cfg):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    out[f"{case}/loss"] = np.asarray(losses)
    for name, leaf in by_path(state["params"]).items():
        out[f"{case}/p{name}"] = (leaf.full_tensor() if tp_only
                                  else leaf.to_local()).numpy()
    out[f"{case}/step"] = state["step"].to_local().numpy()

demo = small_demo(get_config)
if world == 8:      # save with the embedding sharded over "model"
    st = T.init_train_state(0, demo, device="cpu")
    st["params"]["embed"]["table"] = S.place(
        st["params"]["embed"]["table"], S.Spec("model", None), mesh)
    CheckpointManager(f"{root}/elastic").save(
        5, train_state_to_reference(st, demo), blocking=True)
elif world == 4:    # restore onto (2, 2), then the loop
    like = train_state_like(T.init_train_state(0, demo, device="cpu"), demo)
    sh = S.spec_map(lambda _, x: (mesh, S.Spec()), like)
    sh["params"]["embed"]["table"] = (mesh, S.Spec("model", None))
    got = CheckpointManager(f"{root}/elastic").restore(5, like, shardings=sh)
    for name, x in by_path(got).items():
        out[f"elastic{name}"] = x.to_local().numpy()
    out["elastic/table_placements"] = np.asarray(
        [str(p) for p in got["params"]["embed"]["table"].placements])
    data = DataConfig(vocab_size=demo.vocab_size, **LOOP_DATA)
    loop = TL.LoopConfig(ckpt_dir=f"{root}/loop", fail_at_steps=(3,),
                         **LOOP)
    rep = TL.run_training(demo, OptConfig(**OPT), loop, data, mesh=mesh,
                          device="cpu")
    out["loop/losses"] = np.asarray([l for _, l in sorted(dict(
        rep.losses).items())])
    out["loop/restored"] = np.asarray(rep.restored_from)
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", **out)
"""


def _common():
    scope = {}
    exec(_COMMON, scope)
    return scope


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInMesh:
    """A mesh's names and sizes, no process group (the reference's test
    FakeMesh, for the port's ``mesh_dim_names`` and ``size(i)``)."""

    def __init__(self, axes: dict):
        self.mesh_dim_names = tuple(axes)
        self.shape = dict(axes)              # the reference reads this
        self.axis_names = tuple(axes)

    def size(self, i):
        return self.shape[self.mesh_dim_names[i]]


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x4x2": {"pod": 2, "data": 4, "model": 2}}


@functools.cache
def _reference_shapes(arch):
    cj = jax_get_config(arch)
    return jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cj))


def _rules(axes):
    mesh = StandInMesh(axes)
    dp = tuple(n for n in axes if n in ("pod", "data"))
    return (JRules(dp=dp, tp="model", mesh=mesh),
            AxisRules(dp=dp, tp="model", mesh=mesh))


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _sleaves(tree):
    """Leaves in the port's (insertion) order."""
    out = []
    S.spec_map(lambda _, s: out.append(s), tree)
    return out


def _sorted(tree, path=()):
    """(dict-key path, leaf) in jax.tree_util's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted(tree[k],
                                                          path + (k,))]
    if isinstance(tree, list):
        return [x for v in tree for x in _sorted(v, path)]
    return [(path, tree)]


def _legal(spec, shape, mesh):
    for dim, ax in zip(shape, tuple(spec)):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        extent = int(np.prod([mesh.shape[a] for a in axes]))
        assert dim % extent == 0, (spec, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(arch, mesh):
    jr, tr = _rules(MESHES[mesh])
    cj, ct = jax_get_config(arch), get_config(arch)
    jshapes = _reference_shapes(arch)
    tparams = param_shapes(ct)
    shapes = _sorted(shapes_from_params(tparams, ct))
    jshape_leaves = jax.tree_util.tree_leaves(jshapes)
    assert [tuple(s.shape) for _, s in shapes] == \
        [tuple(x.shape) for x in jshape_leaves]

    jp = JS.param_specs(jshapes, cj, jr)
    jst = JS.state_specs(jshapes, cj, jr)
    jg = JS.grad_accum_specs(jshapes, cj, jr)
    tst = S.state_specs(tparams, ct, tr)
    tp = S.param_specs(tparams, ct, tr)
    tg = S.grad_accum_specs(tparams, ct, tr)
    assert tp == tst["params"]
    assert tst["opt"]["step"] == tst["step"] == S.Spec() == tuple(jst["step"])

    def stacked(tree):
        return [x for _, x in _sorted(S.stacked_specs(tree, ct))]

    # the layer axis: the reference shards it on hymba-1.5b's SSM leaves
    # alone (C23); the port's rule there skips it
    layer_sharded = []
    for kind, ref, got in (("params", _jleaves(jp), stacked(tp)),
                           ("m", _jleaves(jst["opt"]["m"]),
                            stacked(tst["opt"]["m"])),
                           ("v", _jleaves(jst["opt"]["v"]),
                            stacked(tst["opt"]["v"])),
                           ("grad", _jleaves(jg), stacked(tg))):
        assert len(ref) == len(got) == len(shapes)
        for (path, shape), r, g, (_, base) in zip(
                shapes, ref, got, _sorted(
                    S.stacked_specs(tp, ct)) if kind != "params"
                else [(None, None)] * len(shapes)):
            _legal(g, shape.shape, tr.mesh)
            stacked_leaf = S._has_layer_axis(path)
            if stacked_leaf:
                assert g[0] is None, (kind, path, g)
            if not (stacked_leaf and tuple(r)[0] is not None):
                assert tuple(g) == tuple(r), (kind, path, g, r)
                continue
            layer_sharded.append((kind, "/".join(map(str, path))))
            if kind == "params":
                unext = JS._fit_spec(JS._leaf_spec(
                    [jax.tree_util.DictKey(k) for k in path],
                    jax.ShapeDtypeStruct(shape.shape, jnp.float32), cj, jr),
                    shape.shape, jr.mesh)
                want = JS.zero_extend_spec(P(*tuple(unext)[1:]),
                                           shape.shape[1:], jr)
            else:
                want = JS.zero_extend_spec(P(*tuple(base)[1:]),
                                           shape.shape[1:], jr)
            want = (None,) + tuple(want) + (None,) * (
                len(shape.shape) - 1 - len(tuple(want)))
            assert tuple(g) == want, (kind, path, g, want)
    if arch == "hymba-1.5b":
        assert {p for _, p in layer_sharded} >= {
            "stack/ssm/x_proj", "stack/ssm/dt_proj"}
    else:
        assert not layer_sharded, layer_sharded

    assert {k: tuple(v) for k, v in S.train_batch_specs(ct, tr).items()} \
        == {k: tuple(v) for k, v in JS.train_batch_specs(cj, jr).items()}
    for batch in (4, 1):        # 1: the sequence-parallel branch
        ref = JS.cache_specs(cj, jr, batch)
        want = []
        for run, specs in zip(JT.build_runs(cj), ref):
            for _ in range(run.count):
                layer = {}
                for name, spec in specs.items():
                    assert tuple(spec)[0] is None
                    layer[name] = tuple(spec)[1:]
                want.append(layer)
        got = [{n: tuple(s) for n, s in layer.items()}
               for layer in S.cache_specs(ct, tr, batch)]
        assert got == want


def test_placements_of_specs():
    """Shard on each mesh dim a spec names, Replicate elsewhere; several
    mesh dims on one tensor dim in the mesh's order."""
    mesh = StandInMesh({"pod": 2, "data": 4, "model": 2})
    assert S.placements(S.Spec(("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert S.placements(S.Spec(None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        S.placements(S.Spec(("data", "pod")), mesh)


# ---------------------------------------------------------------------------
# The gloo ranks.
# ---------------------------------------------------------------------------

def _reference_state(arch, cfg_j):
    pn = jax.tree_util.tree_map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), cfg_j))
    return {"params": pn, "opt": jax.tree_util.tree_map(
        np.asarray, JTR.init_opt_state(pn)), "step": np.int32(0)}


def _single_device(scope, case, state_np):
    arch, ga, uneven, _ = scope["CASES"][case]
    ct = scope["config"](get_config, arch)
    step = TTR.make_train_step(ct, TTR.make_rules(None),
                               OptConfig(**scope["OPT"]), grad_accum=ga)
    st = train_state_from_numpy(state_np, ct, device="cpu")
    losses = []
    for b in scope["batches"](ct.vocab_size, uneven, cfg=ct):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    return np.asarray(losses), st


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns' outputs, the single-device runs they are held to, the
    reference's jitted step on the llama case and the unsharded loop."""
    tmp = tmp_path_factory.mktemp("sharding")
    scope = _common()
    states = {}
    for arch in ("llama3.2-3b", "granite-moe-3b-a800m", "whisper-base"):
        cj = scope["config"](jax_get_config, arch)
        states[arch] = _reference_state(arch, cj)
        CheckpointManager(tmp / "init" / arch).save(0, states[arch],
                                                    blocking=True)
    w8 = start_ranks(_RANK, 8, tmp / "w8")
    single = {case: _single_device(scope, case, states[arch])
              for case, (arch, *_rest) in scope["CASES"].items()}
    cj = scope["config"](jax_get_config, "llama3.2-3b")
    jstep = jax.jit(JTR.make_train_step(cj, JRules(), JOpt(**scope["OPT"])))
    jst = states["llama3.2-3b"]
    jlosses = []
    for b in scope["batches"](cj.vocab_size, scope["CASES"]["llama"][2]):
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(jm["loss"]))
    out8 = join_ranks(w8)
    w4 = start_ranks(_RANK, 4, tmp / "w4")
    w2 = start_ranks(_RANK, 2, tmp / "w2")
    tp2 = start_ranks(_RANK, 2, tmp / "tp2",
                      env=dict(os.environ, SHARDING_TP_ONLY="1"))
    demo = scope["small_demo"](get_config)
    unsharded = TTR.init_train_state(0, demo, device="cpu")
    CheckpointManager(tmp / "unsharded").save(
        5, train_state_to_numpy(unsharded, demo), blocking=True)
    data = DataConfig(vocab_size=demo.vocab_size, **scope["LOOP_DATA"])
    loop = TL.LoopConfig(ckpt_dir=str(tmp / "loop_unsharded"),
                         **scope["LOOP"])
    base = TL.run_training(demo, OptConfig(**scope["OPT"]), loop, data,
                           device="cpu")
    out4, out2, outtp = join_ranks(w4), join_ranks(w2), join_ranks(tp2)
    return dict(tmp=tmp, scope=scope, ranks={8: out8, 4: out4, 2: out2},
                tp_only=outtp[0],
                single=single, reference=(np.asarray(jlosses), jst),
                unsharded=unsharded, loop=base)


def _regions(ct, world, scope, monkeypatch):
    """Per rank, {leaf path: region} of every parameter leaf as its spec
    gives it: per tensor dim the (mesh extent, coordinate) of each mesh
    axis, outermost first."""
    monkeypatch.setattr(S, "FSDP_MIN_ELEMS", scope["SMALL_FSDP"])
    shape = scope["MESH"][world]
    mesh = StandInMesh({"data": shape[0], "model": shape[1]})
    rules = AxisRules(dp=("data",), tp="model", mesh=mesh)
    specs = scope["by_path"](S.param_specs(param_shapes(ct), ct, rules))
    out = []
    for rank in range(world):
        coord = dict(zip(mesh.mesh_dim_names,
                         (rank // shape[1], rank % shape[1])))
        out.append({name: [[(mesh.shape[a], coord[a]) for a in (
            () if entry is None else entry if isinstance(entry, tuple)
            else (entry,))] for entry in spec]
            for name, spec in specs.items()})
    return out


def _index(shape, region):
    idx = []
    for dim, parts in zip(shape, list(region) + [[]] * (
            len(shape) - len(region))):
        lo, n = 0, dim
        for size, c in parts:
            n //= size
            lo += c * n
        idx.append(slice(lo, lo + n))
    return tuple(idx)


@pytest.mark.parametrize("case", list(_common()["CASES"]))
def test_sharded_step_matches_single_device(runs, case, monkeypatch):
    """Two sharded steps against two single-device steps, and against the
    same step on (1, 2) where "model" is 2: losses, and every rank's shard
    of every parameter (the module docstring)."""
    scope = runs["scope"]
    arch, _, _, world = scope["CASES"][case]
    ct = scope["config"](get_config, arch)
    want_losses, st = runs["single"][case]
    params = scope["by_path"](st["params"])
    moments = scope["by_path"](st["opt"]["m"])
    regions = _regions(ct, world, scope, monkeypatch)
    lr = scope["OPT"]["lr"]
    tp = scope["MESH"][world][1]
    if tp > 1:
        assert tp == scope["TP_ONLY"][1]
        np.testing.assert_allclose(runs["tp_only"][f"{case}/loss"],
                                   want_losses, rtol=1e-6)
    sharded = 0
    for rank, out in enumerate(runs["ranks"][world]):
        np.testing.assert_allclose(out[f"{case}/loss"], want_losses,
                                   rtol=1e-6)
        assert int(out[f"{case}/step"]) == 2
        for name, full in params.items():
            full, m = full.numpy(), moments[name].numpy()
            got = out[f"{case}/p{name}"]
            idx = _index(full.shape, regions[rank][name])
            want = full[idx]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            sharded += got.size < full.size
            big = np.abs(m[idx]) >= SMALL_GRAD * np.abs(m).max()
            err = np.abs(got - want)
            assert (err <= lr).all(), (name, err.max())
            scale = 1.0
            if tp > 1:
                want = runs["tp_only"][f"{case}/p{name}"][idx]
                err, scale = np.abs(got - want), TP_BOUND
            assert (err[big] <= scale * (1e-6 + 1e-5 * np.abs(want[big]))
                    ).all(), (name, err[big].max())
    assert sharded > 0


def test_sharded_step_matches_reference(runs, monkeypatch):
    """The llama (4, 2) case, its parameters gathered from the ranks'
    shards, against the reference's jitted single-device step: losses rtol
    1e-5, parameters atol 1e-4 and 99.9% of the entries within 1e-6
    (tests/test_torch_train.py's tolerances for the single-device port
    step)."""
    scope = runs["scope"]
    jlosses, jst = runs["reference"]
    outs = runs["ranks"][8]
    np.testing.assert_allclose(outs[0]["llama/loss"], jlosses, rtol=1e-5)
    ct = scope["config"](get_config, "llama3.2-3b")
    regions = _regions(ct, 8, scope, monkeypatch)
    _, st = runs["single"]["llama"]

    def gather(path, p):
        name = "/" + "/".join(map(str, path))
        full = np.full(tuple(p.shape), np.nan, np.float32)
        for rank, out in enumerate(outs):
            full[_index(full.shape, regions[rank][name])] = \
                out[f"llama/p{name}"]
        assert not np.isnan(full).any()
        return torch.from_numpy(full)
    tree = tree_map(gather, st["params"])
    got = jax.tree_util.tree_leaves(numpy_from_params(tree, ct))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jst["params"]))
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    assert diff.max() <= 1e-4
    assert np.mean(diff > 1e-6) < 1e-3


def test_elastic_restore_onto_a_smaller_mesh(runs):
    """Saved by 8 ranks on (4, 2), the embedding sharded over "model";
    restored by 4 fresh ranks onto (2, 2): every leaf equal to the bit,
    the embedding a DTensor sharded over "model".  The sharded save's
    data.npz is byte for byte an unsharded save's, and the reference's
    manager restores it."""
    tmp, scope = runs["tmp"], runs["scope"]
    sharded = (tmp / "elastic" / "step_00000005" / "data.npz").read_bytes()
    plain = (tmp / "unsharded" / "step_00000005" / "data.npz").read_bytes()
    assert hashlib.sha256(sharded).hexdigest() == \
        hashlib.sha256(plain).hexdigest()
    demo = scope["small_demo"](get_config)
    want = train_state_to_numpy(runs["unsharded"], demo)
    leaves = scope["by_path"](want)
    for rank, out in enumerate(runs["ranks"][4]):
        assert list(out["elastic/table_placements"]) == [
            str(Replicate()), str(Shard(0))]
        for name, x in leaves.items():
            got = out[f"elastic{name}"]
            if name == "/params/embed/table":   # its half over "model"
                half = x.shape[0] // 2
                x = x[(rank % 2) * half:(rank % 2 + 1) * half]
            assert got.dtype == x.dtype and np.array_equal(got, x), name
    cj = scope["small_demo"](jax_get_config)
    like = jax.eval_shape(lambda: JTR.init_train_state(
        jax.random.PRNGKey(0), cj))
    ref = JManager(tmp / "elastic").restore(5, like)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), b)


def test_loop_on_a_mesh_resumes_after_a_failure(runs):
    """run_training on (2, 2) with a failure injected at step 3: restored
    from step 2 onto the mesh, the unsharded run's losses, rtol 1e-6."""
    base = np.asarray([l for _, l in sorted(dict(runs["loop"].losses)
                                            .items())])
    for out in runs["ranks"][4]:
        assert list(out["loop/restored"]) == [2]
        np.testing.assert_allclose(out["loop/losses"], base, rtol=1e-6)
