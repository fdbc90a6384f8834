"""Tensor-parallel compute over the mesh's "model" axis (models/layers.py,
models/transformer.py, runtime/sharding.py ``working_copy``, the sharded
train step, serving on a mesh) and ``repro_torch.launch.mesh``, on the CPU.

Two spawns of 4 gloo ranks run at once, each rank a process of one torch
thread: a (2, 2) ("data", "model") mesh, and a (1, 4) one, where the
reduced models' 2 KV heads do not split over 4 ranks (``wk``/``wv``
replicated, each rank cutting the KV head its query head reads).  Each
rank restores the initial train state (the port's ``init_train_state`` from
seed 0, in the reference's layout) from a checkpoint this test writes,
placed by
``state_specs`` with ``FSDP_MIN_ELEMS`` lowered to 4096, so that leaves are
also ZeRO-extended over "data", and for each reduced model in float32
(llama3.2-3b under remat "full"; gemma3-1b: KV 1, tied embedding, a logit
softcap of 30; starcoder2-3b: biases, gelu; nemotron-4-15b: squared_relu,
an untied head; granite-moe-3b-a800m: expert-parallel experts at capacity
factor 4, C24, under tensor-parallel attention):

* counts its working copy (``sharding.working_copy``): 1/tp of every leaf
  that the layers compute on its slice;
* takes ``loss_and_grads`` of the whole first batch on the working copy
  under rules over "model" alone: every gradient against the single-device
  port's (a leaf computed whole, the norms' and a replicated ``wk``'s,
  equal to the bit on every rank; a slice its slice; an expert slice tp
  times its slice, as the sharded step divides it);
* serves through ``make_serve_steps`` on its working copy and
  ``ServingEngine`` on the placed DTensors: prefill logits and three greedy decode steps against the
  reference's ``prefill``/``decode_step`` and the single-device port, and
  the engine's tokens against the single-device engine's;
* runs two sharded train steps (``grad_specs=grad_accum_specs``): losses
  and ``grad_norm`` against two single-device port steps, the first loss
  against the reference's ``forward_train``, and each rank's shard of every
  parameter against the single-device result.

The other block kinds (the mLSTM, hymba-1.5b's, cross-attention and the
encoder) are held in tests/test_torch_tensor_parallel_blocks.py.
Tolerances (float32):
losses and ``grad_norm`` rtol 1e-5 (the vocab-parallel log-sum-exp and the
row-parallel products sum in another order); gradients rtol 1e-4, atol
1e-5 of the leaf's largest (tests/test_torch_train.py's tolerance against
the reference, relative here); parameters, after AdamW, within rtol 1e-5
plus STEP_TOL of lr where m and the first step's gradient are at least
BIG_GRAD of their leaf's largest, and within one lr elsewhere.  AdamW's
step is lr m / (sqrt(v) + eps): on a gradient entry within rounding of
zero a ratio of rounding errors, which the reordered sums change
(llama3.2-3b's first-layer ``wo`` held an entry whose first gradient was
2.9e-9 on one device and -1.4e-9 over tp, against a largest of 1e-3, and
moved 0.21 lr apart), and elsewhere a ratio that a gradient's error
(measured up to 4e-6 of its leaf's largest) moves by that error over the
entry's own size, the second step's again through the first step's
parameters (0.4% of lr at most on llama3.2-3b's entries above BIG_GRAD);
logits rtol 1e-5,
atol 1e-5 against the single-device port, atol 1e-4 against the reference
(tests/test_torch_model.py's float32 tolerance).

The mesh module: ``describe_mesh`` against ``repro.launch.mesh``'s on four
shapes; ``make_host_mesh`` on the 4 ranks of each spawn;
``make_production_mesh`` raising on a world of 4.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import describe_mesh as jax_describe_mesh
from repro.models import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.layers import AxisRules as JRules

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as LM
from repro_torch.models import get_config
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import OptConfig
from repro_torch.runtime import trainer as TTR
from repro_torch.serving import Request, ServingEngine

from test_torch_collectives import join_ranks, start_ranks

#: entries whose m and first gradient are at least this share of their
#: leaf's largest are held to STEP_TOL of lr
BIG_GRAD = 1e-2
STEP_TOL = 1e-2
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
REFERENCE_LOGITS_TOL = dict(rtol=0, atol=1e-4)

_COMMON = r"""
import dataclasses
import numpy as np

SMALL_FSDP = 4096
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: config overrides a model; "serve": held in serving too
CASES = {"llama3.2-3b": dict(remat="full"),
         "gemma3-1b": dict(logit_softcap=30.0),
         "starcoder2-3b": {}, "nemotron-4-15b": {},
         "granite-moe-3b-a800m": dict(capacity_factor=4.0)}
PROMPT_T, SEQ, DECODE_STEPS = 9, 16, 3
ENGINE_LENGTHS, ENGINE_NEW, ENGINE_SEQ = (5, 9, 3, 7), 4, 24


def config(get_config, arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **CASES[arch])


# two global batches of 8 rows of 16 tokens
def batches(vocab, steps=2):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        tok = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        lab = np.roll(tok, -1, axis=1)
        lab[1, 5:] = -100
        out.append({"tokens": tok, "labels": lab})
    return out


def prompts(vocab):
    rng = np.random.default_rng(11)
    return (rng.integers(0, vocab, (4, PROMPT_T)),
            [rng.integers(0, vocab, n).astype(np.int32)
             for n in ENGINE_LENGTHS])


# {"/key/index/...": leaf} over nested dicts and lists
def by_path(tree, path=""):
    if isinstance(tree, dict):
        items = [(f"{path}/{k}", v) for k, v in tree.items()]
    elif isinstance(tree, list):
        items = [(f"{path}/{i}", v) for i, v in enumerate(tree)]
    else:
        return {path: tree}
    return {n: x for k, v in items for n, x in by_path(v, k).items()}
"""

_RANK = _COMMON + r"""
import datetime, os, sys
import torch, torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=180))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as LM
from repro_torch.models import get_config, transformer as TT
from repro_torch.models.convert import (train_state_from_reference,
                                        train_state_like)
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import sharding as S, trainer as T
from repro_torch.serving import Request, ServingEngine

S.FSDP_MIN_ELEMS = SMALL_FSDP
tag = os.environ["TP_TEST_MESH"]
mesh = init_device_mesh("cpu", MESHES[tag], mesh_dim_names=("data", "model"))
rules = T.make_rules(mesh)
tp_only = dataclasses.replace(rules, dp=())
root = outdir + "/.."
out = {}
host = LM.make_host_mesh(2 if tag == "2x2" else 4, device="cpu")
out["host_mesh"] = np.asarray([host.size(0), host.size(1),
                               *host.get_coordinate()])
out["host_names"] = np.asarray(host.mesh_dim_names)
try:
    LM.make_production_mesh(device="cpu")
except ValueError as e:
    out["production_error"] = np.asarray(str(e))

for arch in CASES:
    cfg = config(get_config, arch)
    fresh = T.init_train_state(0, cfg, device="cpu")
    specs = S.state_specs(fresh["params"], cfg, rules)
    state = train_state_from_reference(CheckpointManager(
        f"{root}/init/{arch}").restore(
            0, train_state_like(fresh, cfg),
            shardings=S.checkpoint_shardings(specs, cfg, mesh)), cfg)
    del fresh
    # the working copy: each leaf's local and whole element counts
    live = S.working_copy(state["params"], cfg, rules)
    names = list(by_path(live))
    counts = []
    tree_map(lambda path, p, w: counts.append(
        (TT.tp_slice_dim(path, cfg) is not None
         or S.is_expert_leaf(path, cfg, rules), w.numel(), p.numel())),
        state["params"], live)
    out[f"{arch}/working"] = np.asarray(counts, np.int64)
    out[f"{arch}/working_names"] = np.asarray(names)
    # every gradient of the whole first batch under tp alone
    b0 = T.on_device(batches(cfg.vocab_size)[0], "cpu")
    _, _, grads = T.loss_and_grads(live, b0, cfg, tp_only)
    for name, g in by_path(grads).items():
        out[f"{arch}/g{name}"] = g.numpy()
    # serving, on the working copy of the placed DTensors
    toks, engine_prompts = prompts(cfg.vocab_size)
    served = TT.cast_params(live, cfg)
    prefill_fn, decode_fn = T.make_serve_steps(cfg, rules, SEQ)
    with torch.no_grad():
        logits, caches = prefill_fn(served, {
            "tokens": torch.from_numpy(toks)})
        out[f"{arch}/cache_heads"] = np.asarray(caches[0]["k"].shape[2])
        out[f"{arch}/prefill"] = logits.numpy()
        for i in range(DECODE_STEPS):
            logits, caches = decode_fn(served, logits.argmax(-1), caches,
                                       PROMPT_T + i)
            out[f"{arch}/decode{i}"] = logits.numpy()
    eng = ServingEngine(cfg, state["params"], slots=4,
                        max_seq=ENGINE_SEQ, rules=rules, device="cpu")
    for rid, p in enumerate(engine_prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=ENGINE_NEW))
    out[f"{arch}/engine"] = np.asarray([r.out_tokens for r in sorted(
        eng.run(), key=lambda r: r.rid)])
    del eng, live, grads
    step = T.make_train_step(cfg, rules, OptConfig(**OPT),
                             grad_specs=S.grad_accum_specs(
                                 state["params"], cfg, rules))
    losses, norms = [], []
    for b in batches(cfg.vocab_size):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{arch}/loss"] = np.asarray(losses)
    out[f"{arch}/grad_norm"] = np.asarray(norms)
    for name, leaf in by_path(state["params"]).items():
        out[f"{arch}/p{name}"] = leaf.to_local().numpy()
        region = S.local_region(tuple(leaf.shape), leaf.placements, mesh)
        out[f"{arch}/r{name}"] = np.asarray([(s.start, s.stop)
                                             for s in region])
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", **out)
"""


def _common():
    scope = {}
    exec(_COMMON, scope)
    return scope


SCOPE = _common()
SERVED = list(SCOPE["CASES"])
TRAINED = [(a, m) for a in SCOPE["CASES"] for m in SCOPE["MESHES"]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _initial_state(arch):
    """The port's initial train state from seed 0 as numpy leaves in the
    reference's layout, which both packages read."""
    ct = SCOPE["config"](get_config, arch)
    return train_state_to_numpy(TTR.init_train_state(0, ct, device="cpu"),
                                ct)


def _single_device(arch, state_np):
    """The single-device port on the ranks' inputs: two train steps, the
    first batch's gradients, prefill and decode logits, engine tokens."""
    ct = SCOPE["config"](get_config, arch)
    out = {}
    batches = SCOPE["batches"](ct.vocab_size)
    st = train_state_from_numpy(state_np, ct, device="cpu")
    _, _, grads = TTR.loss_and_grads(st["params"],
                                     TTR.on_device(batches[0], "cpu"), ct)
    out["grads"] = SCOPE["by_path"](grads)
    toks, engine_prompts = SCOPE["prompts"](ct.vocab_size)
    params = TT.cast_params(st["params"], ct)
    with torch.no_grad():
        logits, caches = TT.prefill(params, {"tokens": torch.from_numpy(
            toks)}, ct, SCOPE["SEQ"])
        out["prefill"] = logits.numpy()
        for i in range(SCOPE["DECODE_STEPS"]):
            logits, caches = TT.decode_step(
                params, logits.argmax(-1), caches, SCOPE["PROMPT_T"] + i,
                ct, SCOPE["SEQ"])
            out[f"decode{i}"] = logits.numpy()
    eng = ServingEngine(ct, st["params"], slots=4,
                        max_seq=SCOPE["ENGINE_SEQ"], device="cpu")
    for rid, p in enumerate(engine_prompts):
        eng.submit(Request(rid=rid, prompt=p,
                           max_new_tokens=SCOPE["ENGINE_NEW"]))
    out["engine"] = [r.out_tokens for r in sorted(eng.run(),
                                                  key=lambda r: r.rid)]
    step = TTR.make_train_step(ct, TTR.make_rules(None),
                               OptConfig(**SCOPE["OPT"]))
    losses, norms = [], []
    for b in batches:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out.update(loss=np.asarray(losses), grad_norm=np.asarray(norms),
               params=SCOPE["by_path"](st["params"]),
               m=SCOPE["by_path"](st["opt"]["m"]))
    return out


def _reference(arch, pn):
    """The reference's first loss (``forward_train``), prefill logits and
    decode steps on the ranks' inputs."""
    cj = SCOPE["config"](jax_get_config, arch)
    b0 = SCOPE["batches"](cj.vocab_size)[0]
    loss, _ = jax.jit(lambda p, b: JT.forward_train(p, b, cj, JRules()))(
        pn, {k: jnp.asarray(v) for k, v in b0.items()})
    out = {"loss": float(loss)}
    toks, _ = SCOPE["prompts"](cj.vocab_size)
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, cj, JRules(), SCOPE["SEQ"]))(
            pn, {"tokens": jnp.asarray(toks, jnp.int32)})
    out["prefill"] = np.asarray(logits)
    decode = jax.jit(lambda p, tok, c, pos: JT.decode_step(
        p, tok, c, pos, cj, JRules(), SCOPE["SEQ"]))
    for i in range(SCOPE["DECODE_STEPS"]):
        logits, caches = decode(
            pn, jnp.argmax(logits, -1).astype(jnp.int32), caches,
            jnp.asarray(SCOPE["PROMPT_T"] + i, jnp.int32))
        out[f"decode{i}"] = np.asarray(logits)
    return out


def tensor_parallel_runs(tmp):
    """Both spawns' outputs, and the single-device port and the reference
    on the same weights and inputs, computed while the ranks run."""
    states = {}
    for arch in SCOPE["CASES"]:
        states[arch] = _initial_state(arch)
        CheckpointManager(tmp / "init" / arch).save(0, states[arch],
                                                    blocking=True)
    started = {tag: start_ranks(_RANK, 4, tmp / tag, env=dict(
        os.environ, TP_TEST_MESH=tag)) for tag in SCOPE["MESHES"]}
    single = {arch: _single_device(arch, states[arch])
              for arch in SCOPE["CASES"]}
    reference = {arch: _reference(arch, states[arch]["params"])
                 for arch in SCOPE["CASES"]}
    ranks = {tag: join_ranks(s) for tag, s in started.items()}
    return dict(ranks=ranks, single=single, reference=reference)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tensor_parallel_runs(tmp_path_factory.mktemp("tensor_parallel"))


def _tp(mesh):
    return SCOPE["MESHES"][mesh][1]


@pytest.mark.parametrize("arch,mesh", TRAINED)
def test_sharded_steps_match_single_device_and_reference(runs, arch, mesh):
    """Two sharded steps with tensor-parallel layers: losses and grad_norm
    against the single-device port (a replicated leaf's gradient counted
    once: the norm would grow with tp otherwise), the first loss against
    the reference's forward_train, and every rank's shard of every
    parameter against the single-device result."""
    single = runs["single"][arch]
    lr = SCOPE["OPT"]["lr"]
    for out in runs["ranks"][mesh]:
        np.testing.assert_allclose(out[f"{arch}/loss"], single["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[f"{arch}/grad_norm"],
                                   single["grad_norm"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[f"{arch}/loss"][0],
                                   runs["reference"][arch]["loss"],
                                   rtol=LOSS_RTOL)
        for name, full in single["params"].items():
            full, m = full.numpy(), single["m"][name].numpy()
            g1 = single["grads"][name].numpy()
            idx = tuple(slice(a, b) for a, b in out[f"{arch}/r{name}"])
            got, want = out[f"{arch}/p{name}"], full[idx]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            big = (np.abs(m[idx]) >= BIG_GRAD * np.abs(m).max()) & (
                np.abs(g1[idx]) >= BIG_GRAD * np.abs(g1).max())
            err = np.abs(got - want)
            assert (err[big] <= STEP_TOL * lr
                    + 1e-5 * np.abs(want[big])).all(), (name, err[big].max())
            assert (err <= lr).all(), (name, err.max())


@pytest.mark.parametrize("arch,mesh", TRAINED)
def test_working_copy_holds_a_tp_slice(runs, arch, mesh):
    """Each rank's working copy holds 1/tp of every leaf that the layers
    compute on its slice (all of them on (2, 2); on (1, 4) the replicated
    wk/wv/bk/bv stay whole) and the whole of every other leaf."""
    tp = _tp(mesh)
    cfg = SCOPE["config"](get_config, arch)
    for out in runs["ranks"][mesh]:
        counts = out[f"{arch}/working"]
        sliced = counts[:, 0].astype(bool)
        local, whole = counts[:, 1], counts[:, 2]
        kept = local < whole
        assert (local[kept] * tp == whole[kept]).all()
        assert (local[~kept] == whole[~kept]).all()
        assert not kept[~sliced].any()
        names = {n for n, k in zip(out[f"{arch}/working_names"], kept) if k}
        head = "/embed/table" if cfg.tie_embeddings else "/lm_head/w"
        ffn = ("moe/wi", "moe/wo") if cfg.is_moe else ("mlp/wi", "mlp/wo")
        want = {"/embed/table", head} | {
            f"/layers/{i}/{leaf}" for i in range(cfg.num_layers)
            for leaf in ("attn/wq", "attn/wo") + ffn}
        if cfg.num_kv_heads % tp == 0:
            want |= {f"/layers/{i}/attn/{w}" for i in range(cfg.num_layers)
                     for w in ("wk", "wv")}
        assert names >= want, want - names


@pytest.mark.parametrize("mesh", list(SCOPE["MESHES"]))
@pytest.mark.parametrize("arch", SERVED)
def test_tensor_parallel_gradients(runs, arch, mesh):
    """``loss_and_grads`` of the whole first batch on the working copy under
    rules over "model" alone: a whole leaf's gradient (norm scales, a
    replicated wk/wv, the router) equal to the bit on every rank and to the
    single-device gradient; a sliced leaf's the slice of it; an expert
    slice's tp times it (the all-to-all's backward sums the tp ranks' equal
    losses, which the sharded step divides out)."""
    tp = _tp(mesh)
    ranks = runs["ranks"][mesh]
    want = {k: v.numpy() for k, v in runs["single"][arch]["grads"].items()}
    replicated = 0
    for name, full in want.items():
        got = [out[f"{arch}/g{name}"] for out in ranks]
        tol = dict(rtol=GRAD_TOL["rtol"],
                   atol=GRAD_TOL["atol"] * max(np.abs(full).max(), 1e-30))
        if got[0].shape == full.shape:
            replicated += 1
            for g in got[1:]:
                np.testing.assert_array_equal(g, got[0], err_msg=name)
            np.testing.assert_allclose(got[0], full, err_msg=name, **tol)
            continue
        dim = [i for i, (a, b) in enumerate(zip(got[0].shape, full.shape))
               if a != b]
        assert len(dim) == 1 and got[0].shape[dim[0]] * tp == \
            full.shape[dim[0]], name
        scale = tp if "/moe/" in name else 1
        for j, g in enumerate(got):
            # rank j's coordinate on "model" is j % tp on both meshes
            part = np.split(full, tp, axis=dim[0])[j % tp]
            np.testing.assert_allclose(g, scale * part, err_msg=name, **tol)
    assert replicated > 0


@pytest.mark.parametrize("mesh", list(SCOPE["MESHES"]))
@pytest.mark.parametrize("arch", SERVED)
def test_tensor_parallel_serving(runs, arch, mesh):
    """make_serve_steps on each rank's working copy of the placed DTensors
    (ServingEngine takes the DTensors): the whole prefill logits and
    three greedy decode steps against the single-device port and the
    reference's prefill/decode_step; caches of this rank's KV heads;
    ServingEngine's tokens equal on every rank and to the single-device
    engine's."""
    tp = _tp(mesh)
    single, ref = runs["single"][arch], runs["reference"][arch]
    cfg = SCOPE["config"](get_config, arch)
    for out in runs["ranks"][mesh]:
        for key in ["prefill"] + [f"decode{i}"
                                  for i in range(SCOPE["DECODE_STEPS"])]:
            got = out[f"{arch}/{key}"]
            assert got.shape == (4, 1, cfg.vocab_padded)
            np.testing.assert_allclose(got, single[key], err_msg=key,
                                       **LOGITS_TOL)
            np.testing.assert_allclose(got, ref[key], err_msg=key,
                                       **REFERENCE_LOGITS_TOL)
        kv = cfg.num_kv_heads
        assert int(out[f"{arch}/cache_heads"]) == (
            kv // tp if kv % tp == 0 else 1)
        assert out[f"{arch}/engine"].tolist() == single["engine"]


class _OneRankOf:
    """Rank ``rank`` of a ("model",) mesh of ``tp``, no process group: the
    layers' forward reads the coordinate and posts nothing before an
    all-reduce."""

    mesh_dim_names = ("model",)

    def __init__(self, tp, rank):
        self.tp, self.rank = tp, rank

    def size(self, i):
        return self.tp

    def get_local_rank(self, name):
        return self.rank

    def get_group(self, name):
        return None


@pytest.mark.parametrize("heads,kv,tp,local_kv", [
    (4, 2, 2, 1),     # the KV heads split: each rank its slice
    (4, 2, 4, 1),     # replicated wk/wv: one KV head a rank
    (4, 1, 2, 1),     # KV 1 (gemma3-1b)
    (6, 3, 2, 3),     # query groups split unevenly: a KV head a query head
    (24, 8, 3, 8)])   # granite-moe-3b-a800m's heads over 3 ranks: the same
def test_each_ranks_heads_attend_as_the_whole_layer(heads, kv, tp, local_kv):
    """qkv_proj on each rank's wq/wo slice (wk/wv sliced where the KV heads
    split over tp, else whole and cut to local_kv_heads), attention (the
    kernel's plain version) at the rank's heads, and the rank's partial
    out-projection: each rank's heads equal the whole layer's, and the
    partial products sum to its output; the caches hold
    len(local_kv_heads) heads."""
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              num_heads=heads, num_kv_heads=kv,
                              dtype="float32")
    gen = torch.Generator().manual_seed(3)
    p = L.init_attention(gen, cfg, torch.float32)
    x = torch.randn((2, 7, cfg.d_model), generator=gen)
    pos = torch.arange(7, dtype=torch.int32)

    def attend(q, k, v):
        return L.attention(q, k, v, q_pos=pos, kv_pos=pos)
    with torch.no_grad():
        whole = attend(*L.qkv_proj(p, x, cfg))
        y = L.out_proj(p, whole, cfg)
        h_loc, total = heads // tp, 0
        for r in range(tp):
            rules = L.AxisRules(tp="model", mesh=_OneRankOf(tp, r))
            mine = slice(r * h_loc, (r + 1) * h_loc)
            local = dict(p, wq=p["wq"][:, mine], wo=p["wo"][mine])
            kv_heads = L.local_kv_heads(cfg, rules)
            if kv % tp == 0:
                local.update(wk=p["wk"][:, kv_heads], wv=p["wv"][:, kv_heads])
            q, k, v = L.qkv_proj(local, x, cfg, rules)
            assert k.shape[2] == v.shape[2] == len(kv_heads) == local_kv
            o = attend(q, k, v)
            torch.testing.assert_close(o, whole[:, :, mine], rtol=1e-6,
                                       atol=1e-6)
            total = total + o.flatten(-2) @ local["wo"].reshape(
                h_loc * cfg.head_dim, cfg.d_model)
        torch.testing.assert_close(total, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16},
                                  {"data": 4, "model": 6},
                                  {"data": 5, "model": 3}])
def test_describe_mesh_matches_reference(axes):
    """repro.launch.mesh.describe_mesh, given an object with the reference's
    ``.shape`` dict, against the port's on a MeshShape."""

    class Shaped:
        shape = axes
    assert LM.describe_mesh(LM.MeshShape(axes)) == jax_describe_mesh(Shaped)


def test_production_mesh_shape_is_the_references():
    for multi in (False, True):
        shape = LM.production_mesh_shape(multi_pod=multi)
        assert LM.describe_mesh(shape)["devices"] == (512 if multi else 256)
        assert shape.mesh_dim_names == (("pod", "data", "model") if multi
                                        else ("data", "model"))


@pytest.mark.parametrize("mesh", list(SCOPE["MESHES"]))
def test_host_and_production_meshes_on_gloo_ranks(runs, mesh):
    """make_host_mesh over 4 ranks: (2, 2) with model=2, (1, 4) with
    model=4, named ("data", "model"), each rank at its coordinate;
    make_production_mesh raises on a world of 4."""
    shape = SCOPE["MESHES"][mesh]
    for rank, out in enumerate(runs["ranks"][mesh]):
        assert out["host_mesh"].tolist() == [*shape, rank // shape[1],
                                             rank % shape[1]]
        assert out["host_names"].tolist() == ["data", "model"]
        assert "256 ranks" in str(out["production_error"])
