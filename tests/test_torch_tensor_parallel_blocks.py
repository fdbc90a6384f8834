"""Tensor-parallel compute for the mLSTM, the hymba block (attention, the
selective SSM and the MLP), cross-attention and the encoder
(models/layers.py ``sum_tp``, models/ssm.py, models/xlstm.py,
models/transformer.py, runtime/sharding.py ``working_copy``, the sharded
train step, serving on a mesh), on the CPU.

Two spawns of 4 gloo ranks run at once, each rank a process of one torch
thread, as in tests/test_torch_tensor_parallel.py: a (2, 2) ("data",
"model") mesh and a (1, 4) one.  The reduced xlstm-350m (three mLSTM
blocks and one sLSTM; its 4 mLSTM heads split over both meshes; at 256
positions, so that prefill reaches the chunked scan and training the
scan's autograd Function), hymba-1.5b (its 4 query heads split; its 2 KV
heads split at tp 2 and are cut from replicated ``wk``/``wv`` at tp 4; the
SSM's 128 channels split) and whisper-base (2 encoder layers over 16
frames, decoder blocks with cross-attention; its heads as hymba's), each in
float32, restored on every rank from a checkpoint of the port's initial
train state (seed 0) placed by ``state_specs`` with ``FSDP_MIN_ELEMS``
lowered to 4096:

* count their working copy: exactly the leaves that ``tp_slice_dim`` names
  and the specs place on that dim hold 1/tp (the sLSTM's, the norms', the
  mLSTM's ``up``/``conv_w``/gates and the SSM's ``in_proj`` stay whole);
* take ``loss_and_grads`` of the whole first batch under rules over
  "model" alone: every gradient against the single-device port's;
* serve through ``make_serve_steps`` and ``ServingEngine``: prefill logits
  and three greedy decode steps against the reference's
  ``prefill``/``decode_step`` and the single-device port, the engine's
  tokens against the single-device engine's, each cache of the rank-local
  shape of ``init_caches(rules=)``;
* run two sharded train steps: losses and ``grad_norm`` against the
  single-device port, the first loss against the reference's
  ``forward_train``, and each rank's shard of every parameter against the
  single-device result.

The tolerances are tests/test_torch_tensor_parallel.py's, stated in its
docstring and imported from it, but for hymba-1.5b, whose float32
gradients are bound by rounding at 4 reduced layers (ROADMAP C20): there
the single-device port is itself up to 3.3e-5 of a leaf's largest
gradient from the same model in float64 (the SSM's ``D``, ``dt_bias``,
``x_proj``), above GRAD_TOL's 1e-5, and the ranks' run up to 2.3e-5 (on
(2, 2)), so each rank's gradient is held within AMPLIFIED_GRAD times the
single device's distance from float64 (or 1e-5 of the leaf's largest,
where that is smaller) of float64.  Likewise its step-2 ``grad_norm``,
which reads step 1's AdamW update of entries whose gradient is within
rounding of zero (a ratio of rounding errors, up to lr each): measured
1.3e-5 (single device), 3.5e-5 ((2, 2)) and 2.5e-6 ((1, 4)) from float64,
held to STEP2_NORM_RTOL of float64.  That these differences are rounding
and nothing else, the float64 tests show: the whole model, every leaf on
its tp slices, equals the single device to 1e-10 in float64.

The single-process tests run each rank of a ("model",) axis as a thread
of this process over an in-process sum (``layers.library_all_reduce`` and
the max of the vocabulary-parallel cross entropy replaced for the test):
every block kind's output and gradients at tp 2 and 4 against the same
block whole, within BLOCK_TOL; the whole reduced models' gradients in
float64 against the single device's, within FLOAT64_TOL; and
:func:`~repro_torch.models.layers.sum_tp` against ``reduce_tp`` alone,
which gives the mLSTM's and the SSM's gradients wrong.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.layers import AxisRules as JRules

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ATTN_CROSS, HYMBA, MLSTM, SLSTM
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime import sharding as S
from repro_torch.runtime import trainer as TTR
from repro_torch.serving import Request, ServingEngine

from test_torch_collectives import join_ranks, start_ranks
from test_torch_tensor_parallel import (BIG_GRAD, GRAD_TOL, LOGITS_TOL,
                                        LOSS_RTOL, REFERENCE_LOGITS_TOL,
                                        STEP_TOL)

#: a block on its tp slices against the same block whole, float32: the
#: row-parallel products and the sums over tp round in another order
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
#: every gradient of a whole model on its tp slices against the single
#: device, float64, relative to the leaf's largest (measured 1.2e-14 to
#: 3.8e-14)
FLOAT64_TOL = 1e-10
#: stacks whose float32 gradients are rounding-bound at 4 reduced layers,
#: held against float64 (the docstring)
AMPLIFIED = ("hymba-1.5b",)
AMPLIFIED_GRAD = 2.0
STEP2_NORM_RTOL = 1e-4

_COMMON = r"""
import dataclasses
import numpy as np

SMALL_FSDP = 4096
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: each model's train rows and positions, serve prompt and cache length
CASES = {"xlstm-350m": dict(rows=4, t=256, prompt=256, seq=260),
         "hymba-1.5b": dict(rows=8, t=16, prompt=9, seq=16),
         "whisper-base": dict(rows=8, t=16, prompt=9, seq=16)}
DECODE_STEPS = 3
ENGINE_LENGTHS, ENGINE_NEW, ENGINE_SEQ = (5, 9, 3, 7), 4, 24


def config(get_config, arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _frames(rng, cfg, b):
    return (rng.normal(size=(b, cfg.encoder_seq_len, cfg.d_model))
            * 0.02).astype(np.float32)


# two global batches (tokens, labels, frames for whisper)
def batches(cfg, arch, steps=2):
    rng = np.random.default_rng(7)
    rows, t = CASES[arch]["rows"], CASES[arch]["t"]
    out = []
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (rows, t)).astype(np.int32)
        lab = np.roll(tok, -1, axis=1)
        lab[1, 5:] = -100
        b = {"tokens": tok, "labels": lab}
        if cfg.is_encdec:
            b["frames"] = _frames(rng, cfg, rows)
        out.append(b)
    return out


# the prefill batch of 4 prompts, and the engine's prompts
def prompts(cfg, arch):
    rng = np.random.default_rng(11)
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                (4, CASES[arch]["prompt"]))}
    if cfg.is_encdec:
        b["frames"] = _frames(rng, cfg, 4)
    return b, [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in ENGINE_LENGTHS]


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
import datetime, json, os, sys
import torch, torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=180))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import CheckpointManager
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


def shapes(caches):
    return json.dumps([{n: list(a.shape) for n, a in c.items()}
                       for c in caches])


for arch, case in CASES.items():
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
    out[f"{arch}/working_names"] = np.asarray(list(by_path(live)))
    counts = []
    tree_map(lambda path, p, w: counts.append((w.numel(), p.numel())),
             state["params"], live)
    out[f"{arch}/working"] = np.asarray(counts, np.int64)
    # every gradient of the whole first batch under tp alone
    b0 = T.on_device(batches(cfg, arch)[0], "cpu")
    _, _, grads = T.loss_and_grads(live, b0, cfg, tp_only)
    for name, g in by_path(grads).items():
        out[f"{arch}/g{name}"] = g.numpy()
    # serving, on the working copy of the placed DTensors
    batch, engine_prompts = prompts(cfg, arch)
    served = TT.cast_params(live, cfg)
    prefill_fn, decode_fn = T.make_serve_steps(cfg, rules, case["seq"])
    with torch.no_grad():
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        logits, caches = prefill_fn(served, batch)
        out[f"{arch}/cache_shapes"] = np.asarray(shapes(caches))
        out[f"{arch}/init_cache_shapes"] = np.asarray(shapes(TT.init_caches(
            cfg, 4, case["seq"], device="cpu", rules=rules)))
        out[f"{arch}/prefill"] = logits.numpy()
        start = case["prompt"] + TT.prefix_len(cfg, batch)
        for i in range(DECODE_STEPS):
            logits, caches = decode_fn(served, logits.argmax(-1), caches,
                                       start + i)
            out[f"{arch}/decode{i}"] = logits.numpy()
        out[f"{arch}/decode_cache_shapes"] = np.asarray(shapes(caches))
    eng = ServingEngine(cfg, state["params"], slots=4, max_seq=ENGINE_SEQ,
                        rules=rules, device="cpu")
    for rid, p in enumerate(engine_prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=ENGINE_NEW))
    out[f"{arch}/engine"] = np.asarray([r.out_tokens for r in sorted(
        eng.run(), key=lambda r: r.rid)])
    del eng, live, grads, served
    step = T.make_train_step(cfg, rules, OptConfig(**OPT),
                             grad_specs=S.grad_accum_specs(
                                 state["params"], cfg, rules))
    losses, norms = [], []
    for b in batches(cfg, arch):
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
ARCHS = list(SCOPE["CASES"])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _float64(mp):
    """Through ``mp`` (a pytest MonkeyPatch): a float64 model computes in
    float64 every op that computes in float32 for bfloat16 and float32
    models (``.float()`` keeps float64; the xLSTM zero states are
    float64)."""
    keep = torch.Tensor.float
    zero, slstm = XL._zero_state, XL.init_slstm_cache
    mp.setattr(torch.Tensor, "float", lambda self, *a, **kw: (
        self if self.dtype == torch.float64 else keep(self, *a, **kw)))
    mp.setattr(XL, "_zero_state", lambda *a, **kw: tuple(
        x.double() for x in zero(*a, **kw)))
    mp.setattr(XL, "init_slstm_cache", lambda *a, **kw: {
        n: x.double() for n, x in slstm(*a, **kw).items()})


def _config64(cfg):
    return dataclasses.replace(cfg, dtype="float64", param_dtype="float64")


def _double(tree):
    return tree_map(lambda _, a: a.double() if a.is_floating_point() else a,
                    tree)


def _batch64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _single_device_float64(arch, state_np):
    """The single-device port in float64 on the ranks' inputs: the first
    batch's gradients and two train steps' losses and grad norms."""
    ct = SCOPE["config"](get_config, arch)
    c64 = _config64(ct)
    batches = [_batch64(b) for b in SCOPE["batches"](ct, arch)]
    with pytest.MonkeyPatch.context() as mp:
        _float64(mp)
        st = _double(train_state_from_numpy(state_np, ct, device="cpu"))
        _, _, grads = TTR.loss_and_grads(st["params"], TTR.on_device(
            batches[0], "cpu"), c64)
        step = TTR.make_train_step(c64, TTR.make_rules(None),
                                   OptConfig(**SCOPE["OPT"]))
        losses, norms = [], []
        for b in batches:
            st, m = step(st, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return dict(grads=SCOPE["by_path"](grads), loss=np.asarray(losses),
                grad_norm=np.asarray(norms))


def _single_device(arch, state_np):
    """The single-device port on the ranks' inputs: two train steps, the
    first batch's gradients, prefill and decode logits, engine tokens."""
    ct = SCOPE["config"](get_config, arch)
    case = SCOPE["CASES"][arch]
    out = {}
    batches = SCOPE["batches"](ct, arch)
    st = train_state_from_numpy(state_np, ct, device="cpu")
    _, _, grads = TTR.loss_and_grads(st["params"],
                                     TTR.on_device(batches[0], "cpu"), ct)
    out["grads"] = SCOPE["by_path"](grads)
    batch, engine_prompts = SCOPE["prompts"](ct, arch)
    batch = _tensors(batch)
    params = TT.cast_params(st["params"], ct)
    with torch.no_grad():
        logits, caches = TT.prefill(params, batch, ct, case["seq"])
        out["prefill"] = logits.numpy()
        start = case["prompt"] + TT.prefix_len(ct, batch)
        for i in range(SCOPE["DECODE_STEPS"]):
            logits, caches = TT.decode_step(
                params, logits.argmax(-1), caches, start + i, ct,
                case["seq"])
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
    case = SCOPE["CASES"][arch]
    b0 = SCOPE["batches"](cj, arch)[0]
    loss, _ = jax.jit(lambda p, b: JT.forward_train(p, b, cj, JRules()))(
        pn, {k: jnp.asarray(v) for k, v in b0.items()})
    out = {"loss": float(loss)}
    batch, _ = SCOPE["prompts"](cj, arch)
    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
             for k, v in batch.items()}
    logits, caches = jax.jit(lambda p, b: JT.prefill(
        p, b, cj, JRules(), case["seq"]))(pn, batch)
    out["prefill"] = np.asarray(logits)
    start = case["prompt"] + cj.num_meta_tokens
    decode = jax.jit(lambda p, tok, c, pos: JT.decode_step(
        p, tok, c, pos, cj, JRules(), case["seq"]))
    for i in range(SCOPE["DECODE_STEPS"]):
        logits, caches = decode(
            pn, jnp.argmax(logits, -1).astype(jnp.int32), caches,
            jnp.asarray(start + i, jnp.int32))
        out[f"decode{i}"] = np.asarray(logits)
    return out


def block_runs(tmp):
    """Both spawns' outputs, and the single-device port and the reference
    on the same weights and inputs, computed while the ranks run."""
    states = {}
    for arch in ARCHS:
        ct = SCOPE["config"](get_config, arch)
        states[arch] = train_state_to_numpy(
            TTR.init_train_state(0, ct, device="cpu"), ct)
        CheckpointManager(tmp / "init" / arch).save(0, states[arch],
                                                    blocking=True)
    started = {tag: start_ranks(_RANK, 4, tmp / tag, env=dict(
        os.environ, TP_TEST_MESH=tag)) for tag in SCOPE["MESHES"]}
    single = {arch: _single_device(arch, states[arch]) for arch in ARCHS}
    reference = {arch: _reference(arch, states[arch]["params"])
                 for arch in ARCHS}
    float64 = {arch: _single_device_float64(arch, states[arch])
               for arch in AMPLIFIED}
    ranks = {tag: join_ranks(s) for tag, s in started.items()}
    return dict(ranks=ranks, single=single, reference=reference,
                float64=float64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return block_runs(tmp_path_factory.mktemp("tensor_parallel_blocks"))


def _tp(mesh):
    return SCOPE["MESHES"][mesh][1]


CELLS = [(a, m) for a in ARCHS for m in SCOPE["MESHES"]]


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_block_sharded_steps_match_single_device_and_reference(runs, arch,
                                                               mesh):
    """Two sharded steps with every block kind on its tp slices: losses and
    grad_norm against the single-device port (hymba-1.5b's grad norms
    against float64: step 1 at LOSS_RTOL, step 2 at STEP2_NORM_RTOL), the
    first loss against the reference's forward_train, every rank's shard
    of every parameter against the single-device result (by lr, as
    tests/test_torch_tensor_parallel.py holds it)."""
    single = runs["single"][arch]
    lr = SCOPE["OPT"]["lr"]
    for out in runs["ranks"][mesh]:
        np.testing.assert_allclose(out[f"{arch}/loss"], single["loss"],
                                   rtol=LOSS_RTOL)
        norms = out[f"{arch}/grad_norm"]
        if arch in AMPLIFIED:
            exact = runs["float64"][arch]["grad_norm"]
            np.testing.assert_allclose(norms[0], exact[0], rtol=LOSS_RTOL)
            np.testing.assert_allclose(norms[1], exact[1],
                                       rtol=STEP2_NORM_RTOL)
        else:
            np.testing.assert_allclose(norms, single["grad_norm"],
                                       rtol=LOSS_RTOL)
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


def _sliced_leaves(cfg, tp):
    """The leaves each rank's working copy holds 1/tp of: every mLSTM's
    q, k, v and down; hymba's attention, MLP and SSM channel leaves;
    whisper's self- and cross-attention and MLP leaves, the encoder's too
    (k and v where the KV heads split, biases with their heads); the
    embedding and the head."""
    kv = cfg.num_kv_heads % tp == 0
    attn = ["attn/wq", "attn/wo"] + (["attn/wk", "attn/wv"] if kv else [])
    if cfg.attn_bias:
        attn += ["attn/bq"] + (["attn/bk", "attn/bv"] if kv else [])
    mlp = ["mlp/wi", "mlp/wo"] + (["mlp/wg"] if cfg.mlp == "swiglu" else [])
    mlp += ["mlp/bi"] if cfg.mlp_bias else []
    per_kind = {
        MLSTM: ["wq", "wk", "wv", "down"], SLSTM: [],
        HYMBA: attn + mlp + [f"ssm/{n}" for n in (
            "conv_w", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
            "out_proj")],
        ATTN_CROSS: attn + mlp + ["xattn/wq", "xattn/wo"] + (
            ["xattn/wk", "xattn/wv"] if kv else [])}
    names = {"/embed/table"} | (set() if cfg.tie_embeddings
                                else {"/lm_head/w"})
    for i, kind in enumerate(cfg.block_pattern):
        names |= {f"/layers/{i}/{n}" for n in per_kind[kind]}
    for i in range(cfg.encoder_layers):
        names |= {f"/encoder/{i}/{n}" for n in attn + mlp}
    return names


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_block_working_copy_holds_a_tp_slice(runs, arch, mesh):
    """Each rank's working copy holds 1/tp of exactly the leaves that the
    layers compute on their slices, and the whole of every other leaf
    (the sLSTM's, the norms', the mLSTM's up, conv_w and gates, the SSM's
    in_proj)."""
    tp = _tp(mesh)
    cfg = SCOPE["config"](get_config, arch)
    for out in runs["ranks"][mesh]:
        local, whole = out[f"{arch}/working"].T
        kept = local < whole
        assert (local[kept] * tp == whole[kept]).all()
        assert (local[~kept] == whole[~kept]).all()
        names = {n for n, k in zip(out[f"{arch}/working_names"], kept) if k}
        assert names == _sliced_leaves(cfg, tp), (
            names ^ _sliced_leaves(cfg, tp))


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_block_tensor_parallel_gradients(runs, arch, mesh):
    """``loss_and_grads`` of the whole first batch on the working copy under
    rules over "model" alone: a whole leaf's gradient (the sLSTM's, the
    norms', up, in_proj, a replicated wk/wv, the mLSTM's gates) equal to the
    bit on every rank and to the single-device gradient; a sliced leaf's
    the slice of it (hymba-1.5b's against float64, the docstring)."""
    tp = _tp(mesh)
    ranks = runs["ranks"][mesh]
    want = {k: v.numpy() for k, v in runs["single"][arch]["grads"].items()}
    exact = ({k: v.numpy() for k, v in runs["float64"][arch][
        "grads"].items()} if arch in AMPLIFIED else None)
    sliced = 0
    for name, full in want.items():
        got = [out[f"{arch}/g{name}"] for out in ranks]
        if got[0].shape == full.shape:
            for g in got[1:]:
                np.testing.assert_array_equal(g, got[0], err_msg=name)
            parts = [slice(None)] * len(got)
        else:
            sliced += 1
            dim = [i for i, (a, b) in enumerate(zip(got[0].shape,
                                                    full.shape)) if a != b]
            assert len(dim) == 1 and got[0].shape[dim[0]] * tp == \
                full.shape[dim[0]], name
            # rank j's coordinate on "model" is j % tp on both meshes
            parts = [tuple(slice(None) if i != dim[0] else slice(
                (j % tp) * g.shape[i], (j % tp + 1) * g.shape[i])
                for i in range(g.ndim)) for j, g in enumerate(got)]
        for g, part in zip(got, parts):
            if exact is None:
                np.testing.assert_allclose(
                    g, full[part], err_msg=name, rtol=GRAD_TOL["rtol"],
                    atol=GRAD_TOL["atol"] * max(np.abs(full).max(), 1e-30))
                continue
            top = np.abs(exact[name]).max()
            bound = AMPLIFIED_GRAD * max(
                np.abs(full - exact[name]).max(), GRAD_TOL["atol"] * top)
            assert np.abs(g - exact[name][part]).max() <= bound, (
                name, np.abs(g - exact[name][part]).max() / top,
                bound / top)
    assert sliced > 0


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_block_tensor_parallel_serving(runs, arch, mesh):
    """make_serve_steps on each rank's working copy: the whole prefill
    logits and three greedy decode steps against the single-device port and
    the reference's prefill/decode_step; ServingEngine's tokens equal on
    every rank and to the single-device engine's."""
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
        assert out[f"{arch}/engine"].tolist() == single["engine"]


def _local_cache_shapes(cfg, tp, batch, seq):
    """Each layer's cache shapes on one rank: attention and cross K/V of one
    KV head (2 heads over 2 ranks; at tp 4 each rank's query head reads
    one), the SSM's channels and the mLSTM's heads over tp, the mLSTM's
    conv window and the sLSTM's state whole."""
    d, k = cfg.d_model, cfg.conv_kernel - 1
    inner = cfg.ssm_expand * d
    hd, dh = cfg.head_dim, inner // cfg.num_heads
    out = []
    for kind in cfg.block_pattern:
        if kind == MLSTM:
            h = cfg.num_heads // tp
            out.append({"conv": [batch, k, inner], "C": [batch, h, dh, dh],
                        "n": [batch, h, dh], "m": [batch, h]})
        elif kind == SLSTM:
            out.append({n: [batch, d] for n in ("h", "c", "n", "m")})
        else:
            c = {"k": [batch, seq, 1, hd], "v": [batch, seq, 1, hd]}
            if kind == ATTN_CROSS:
                c.update(ck=[batch, cfg.encoder_seq_len, 1, hd],
                         cv=[batch, cfg.encoder_seq_len, 1, hd])
            else:
                c.update(conv=[batch, k, inner // tp],
                         state=[batch, inner // tp, cfg.ssm_state])
            out.append(c)
    return out


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_block_caches_are_rank_local(runs, arch, mesh):
    """``init_caches(rules=)`` gives every block kind's cache its rank-local
    shape, and prefill and decode leave caches of the same shapes."""
    cfg = SCOPE["config"](get_config, arch)
    seq = SCOPE["CASES"][arch]["seq"]
    want = _local_cache_shapes(cfg, _tp(mesh), 4, seq)
    for out in runs["ranks"][mesh]:
        assert json.loads(str(out[f"{arch}/init_cache_shapes"])) == want
        for key in ("cache_shapes", "decode_cache_shapes"):
            assert json.loads(str(out[f"{arch}/{key}"])) == want, key


# ---------------------------------------------------------------------------
# One process, a thread a rank.
# ---------------------------------------------------------------------------

class _ThreadSum:
    """The sum over ``n`` threads, each a rank: each posts its tensor, all
    read the sum in rank order (the same bits on every rank)."""

    def __init__(self, n):
        self.n, self.posted = n, [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def all_reduce(self, x, rank):
        self.posted[rank] = x.detach().clone()
        self.barrier.wait()
        total = self.posted[0].clone()
        for y in self.posted[1:]:
            total = total + y
        self.barrier.wait()
        return total


class _ThreadRank:
    """Rank ``rank`` of a ("model",) mesh of threads: the group handle its
    layers' all-reduces post to."""

    mesh_dim_names = ("model",)

    def __init__(self, group, rank):
        self.group, self.rank = group, rank

    def size(self, i):
        return self.group.n

    def get_local_rank(self, name):
        return self.rank

    def get_group(self, name):
        return self


def _on_thread_ranks(tp, fn, monkeypatch):
    """``fn(rules)`` on ``tp`` threads, each a rank of a ("model",) axis;
    their results in rank order."""
    group = _ThreadSum(tp)
    monkeypatch.setattr(L, "library_all_reduce",
                        lambda x, g: g.group.all_reduce(x, g.rank))
    results, errors = [None] * tp, []

    def run(r):
        torch.set_num_threads(1)
        try:
            results[r] = fn(L.AxisRules(tp="model",
                                        mesh=_ThreadRank(group, r)))
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
            group.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _leaf_items(tree, path=()):
    """(path, leaf) over nested dicts and lists, paths as ``tp_slice_dim``
    reads them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, path + (i,))
    else:
        yield path, tree


def _block(kind, cfg, t):
    """A reduced model's first block of ``kind`` (its parameters and its
    path's prefix), an input, a cross source and an output weight."""
    params = TT.init_params(0, cfg, device="cpu")
    i = [k for k, _, _ in TT._layer_specs(cfg)].index(kind)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, t, cfg.d_model), generator=gen)
    src = torch.randn((2, 5, cfg.d_model), generator=gen)
    w = torch.randn((2, t, cfg.d_model), generator=gen)
    return params["layers"][i], ("layers", i), x, src, w


def _apply(kind, p, x, src, cfg, rules):
    if kind == MLSTM:
        return TT.apply_mlstm_block(p, x, cfg, rules=rules)[0]
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    if kind == HYMBA:
        return TT.apply_hymba_block(p, x, cfg, window=0, theta=1e4,
                                    q_pos=pos, kv_pos=pos, rules=rules)[0]
    return TT.apply_attn_block(p, x, cfg, window=0, theta=1e4, q_pos=pos,
                               kv_pos=pos, rules=rules, cross_src=src)[0]


def _output_and_grads(kind, p, x, src, w, cfg, rules=L.AxisRules()):
    """The block's output and the gradients of <output, w> in x, the cross
    source and every leaf."""
    leaves = [a.detach().clone().requires_grad_(True)
              for _, a in _leaf_items(p)]
    p = _rebuild(p, iter(leaves))
    x, src = (a.clone().requires_grad_(True) for a in (x, src))
    y = _apply(kind, p, x, src, cfg, rules)
    grads = torch.autograd.grad((y * w).sum(), [x, src] + leaves,
                                allow_unused=True)
    return y.detach(), grads


def _rebuild(tree, leaves):
    """``tree``'s dicts and lists with its leaves taken from ``leaves`` in
    :func:`_leaf_items`' order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _rank_slice(a, dim, tp, r):
    """This rank's slice of a whole leaf where the specs would place it on
    ``dim`` (the dim divides over tp), else the leaf."""
    if dim is None or a.shape[dim] % tp:
        return a
    return a.chunk(tp, dim)[r]


BLOCKS = [("xlstm-350m", MLSTM), ("hymba-1.5b", HYMBA),
          ("whisper-base", ATTN_CROSS)]


@pytest.mark.parametrize("t", [7, 256])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch,kind", BLOCKS)
def test_each_rank_computes_its_block_slice(monkeypatch, arch, kind, tp, t):
    """Each block kind on every rank's tp slices (cut as the specs place
    them) against the same block whole: the output on every rank, the
    gradients of the input and of the cross source whole on every rank,
    and each leaf's gradient its slice of the whole one.  At 256 positions
    the mLSTM takes the chunked scan's Function and the SSM its
    checkpointed chunks of 128."""
    cfg = SCOPE["config"](get_config, arch)
    p, prefix, x, src, w = _block(kind, cfg, t)
    y, grads = _output_and_grads(kind, p, x, src, w, cfg)
    dims = [TT.tp_slice_dim(prefix + path, cfg, L.AxisRules())
            for path, _ in _leaf_items(p)]

    def rank(rules):
        r = rules.tp_rank
        local = _rebuild(p, iter(
            _rank_slice(a, d, tp, r)
            for (_, a), d in zip(_leaf_items(p), dims)))
        return _output_and_grads(kind, local, x, src, w, cfg, rules)
    for r, (y_r, g_r) in enumerate(_on_thread_ranks(tp, rank, monkeypatch)):
        torch.testing.assert_close(y_r, y, **BLOCK_TOL)
        names = ["x", "cross source"] + [
            "/".join(path) for path, _ in _leaf_items(p)]
        for name, d, got, want in zip(names, [None, None] + dims, g_r,
                                      grads):
            if want is None:
                assert got is None, name
                continue
            want = _rank_slice(want, d, tp, r)
            scale = max(float(want.abs().max()), 1e-30)
            torch.testing.assert_close(got / scale, want / scale,
                                       msg=lambda m: f"{name}: {m}",
                                       **BLOCK_TOL)


class _ThreadDist:
    """``torch.distributed``'s ``all_reduce`` with ``ReduceOp.MAX`` (the
    vocabulary-parallel cross entropy's) over the thread ranks."""

    ReduceOp = torch.distributed.ReduceOp

    @staticmethod
    def all_reduce(x, op, group):
        assert op == torch.distributed.ReduceOp.MAX
        threads = group.group
        threads.posted[group.rank] = x.detach().clone()
        threads.barrier.wait()
        top = torch.stack(threads.posted).amax(dim=0)
        threads.barrier.wait()
        x.copy_(top)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_on_thread_ranks_in_float64(monkeypatch, arch, tp):
    """``loss_and_grads`` of the whole reduced model in float64, every leaf
    that ``tp_slice_dim`` names on its tp slice (where the dim divides, as
    the specs place it) on each thread rank, against the single device in
    float64: the loss, and every gradient (a slice its slice) within
    FLOAT64_TOL of the leaf's largest.  Nothing but rounding separates the
    float32 runs of the spawn tests from the single device."""
    cfg = SCOPE["config"](get_config, arch)
    c64 = _config64(cfg)
    _float64(monkeypatch)
    monkeypatch.setattr(L, "dist", _ThreadDist)
    params = _double(TTR.init_train_state(0, cfg, device="cpu")["params"])
    batch = TTR.on_device(_batch64(SCOPE["batches"](cfg, arch)[0]), "cpu")
    loss, _, grads = TTR.loss_and_grads(params, batch, c64)
    dims = [TT.tp_slice_dim(path, cfg) for path, _ in _leaf_items(params)]

    def rank(rules):
        local = _rebuild(params, iter(
            _rank_slice(a, d, tp, rules.tp_rank)
            for (_, a), d in zip(_leaf_items(params), dims)))
        return TTR.loss_and_grads(local, batch, c64, rules)
    sliced = 0
    for r, (loss_r, _, grads_r) in enumerate(
            _on_thread_ranks(tp, rank, monkeypatch)):
        assert abs(float(loss_r) - float(loss)) <= FLOAT64_TOL * abs(
            float(loss))
        for (path, want), d, (_, got) in zip(
                _leaf_items(grads), dims, _leaf_items(grads_r)):
            sliced += got.shape != want.shape
            want = _rank_slice(want, d, tp, r)
            err = float((got - want).abs().max()
                        / want.abs().max().clamp_min(1e-300))
            assert err <= FLOAT64_TOL, (path, err)
    assert sliced


@pytest.mark.parametrize("arch,kind", BLOCKS[:2])
def test_sum_tp_is_needed_both_ways(monkeypatch, arch, kind):
    """The mLSTM's sum of squares over inner and the SSM's x_proj product
    feed work of each rank's own: with ``sum_tp`` (all-reduce forward and
    backward) every gradient at tp 2 is the whole block's; with
    ``reduce_tp`` alone in its place (identity backward) the output is the
    same and the gradients of the input and of the leaves before the sum
    are wrong."""
    cfg = SCOPE["config"](get_config, arch)
    p, prefix, x, src, w = _block(kind, cfg, 7)
    y, grads = _output_and_grads(kind, p, x, src, w, cfg)
    dims = [TT.tp_slice_dim(prefix + path, cfg, L.AxisRules())
            for path, _ in _leaf_items(p)]

    def rank(rules):
        local = _rebuild(p, iter(
            _rank_slice(a, d, 2, rules.tp_rank)
            for (_, a), d in zip(_leaf_items(p), dims)))
        return _output_and_grads(kind, local, x, src, w, cfg, rules)

    def worst(results):
        out = 0.0
        for r, (y_r, g_r) in enumerate(results):
            torch.testing.assert_close(y_r, y, **BLOCK_TOL)
            for d, got, want in zip([None, None] + dims, g_r, grads):
                if want is not None:
                    want = _rank_slice(want, d, 2, r)
                    out = max(out, float((got - want).abs().max()
                                         / want.abs().max().clamp_min(1e-30)))
        return out
    assert worst(_on_thread_ranks(2, rank, monkeypatch)) < 1e-4
    monkeypatch.setattr(L, "sum_tp", L.reduce_tp)
    assert worst(_on_thread_ranks(2, rank, monkeypatch)) > 1e-2


def test_mlstm_heads_that_do_not_split_compute_whole():
    """An mLSTM of 2 heads over tp 4: the specs place wq on its columns
    (inner = 128 divides 4: 32-column slices, half a head each), but
    ``tp_slice_dim`` names no dim for it, so the working copy holds it
    whole, the block computes whole under the rules (posting nothing) and
    its cache holds both heads; a wq slice that cuts a head raises."""

    class Stand:                     # a ("model",) axis of 4, no group
        mesh_dim_names = ("model",)

        def size(self, i):
            return 4

        def get_local_rank(self, name):
            return 1

        def get_group(self, name):
            raise AssertionError("a whole block posts no collective")
    cfg = dataclasses.replace(SCOPE["config"](get_config, "xlstm-350m"),
                              num_heads=2)
    rules = L.AxisRules(tp="model", mesh=Stand())
    params = TT.init_params(0, cfg, device="cpu")
    i = cfg.block_pattern.index(MLSTM)
    specs = S.param_specs(params, cfg, rules)
    assert specs["layers"][i]["wq"] == S.Spec(None, "model")
    for name in ("wq", "wk", "wv", "down"):
        assert TT.tp_slice_dim(("layers", i, name), cfg, rules) is None
        assert TT.tp_slice_dim(("layers", i, name), cfg) is not None
    p = TT.cast_params(params, cfg)["layers"][i]
    x = torch.randn((2, 7, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole, cache = TT.apply_mlstm_block(p, x, cfg)
        got, got_cache = TT.apply_mlstm_block(p, x, cfg, rules=rules)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    assert got_cache["C"].shape[1] == 2
    caches = TT.init_caches(cfg, 2, 8, device="cpu", rules=rules)
    assert caches[i]["C"].shape == (2, 2, 64, 64)
    with pytest.raises(ValueError, match="do not split"):
        TT.apply_mlstm_block(dict(p, wq=p["wq"][:, 32:64]), x, cfg,
                             rules=rules)
