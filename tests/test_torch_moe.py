"""repro_torch.models.moe and the MoE model (granite-moe-3b-a800m) against
the JAX reference repro.models.moe / repro.models.transformer, on the CPU.

* Dispatch: ``_capacity``, ``expert_store_count`` and
  ``_dispatch_indices`` equal the reference's, exactly (integers), on the
  reference's own cases and on random ones with drops; top-k ties go to
  the lower index, as ``lax.top_k`` sends them.
* The dense ``_moe_local`` in float32 on the same weights (the reference's
  through ``params_from_numpy``): y, moe_aux and moe_z within atol = rtol =
  1e-5, at capacity factor 1.25 (drops) and 8.0 (none).
* The expert-parallel path on a (2, 4) ("data", "model") DeviceMesh of 8
  gloo ranks: against the port's dense path at capacity factor 8.0
  (nothing dropped) within rtol 2e-4 / atol 2e-5, as tests/test_moe.py
  holds the reference; against the reference's EP path on 8 forced host
  devices at capacity factor 1.25 (per-shard capacities drop the same
  tokens) within the same tolerance; gradients finite.  The reduced
  granite with ``rules=AxisRules(dp=("data",), tp="model", mesh)`` and
  ``expert_shard`` params on the same mesh: prefill, a decode step and
  ServingEngine's greedy tokens against the dense model on each data
  shard's requests, within the same tolerance.
* The reduced granite (4 layers, 8 experts, top-2) in float32: prefill and
  decode logits and k/v caches against the reference with
  ``attention_impl="reference"`` (ROADMAP C4), atol 1e-4; ServingEngine's
  greedy tokens equal the reference engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jax_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import AxisRules as JRules
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine

from repro_torch.models import (AxisRules, expert_shard, get_config,
                                params_from_numpy)
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.serving import Request, ServingEngine

from test_torch_collectives import (join_ranks, join_reference, start_ranks,
                                    start_reference)

ARCH = "granite-moe-3b-a800m"
TOL = dict(rtol=1e-5, atol=1e-5)
EP_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_ATOL = 1e-4


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tiny(cls, num_experts=8, top_k=2, pad=1, cf=2.0, mlp="swiglu"):
    return cls(name="tiny-moe", family="moe", num_layers=1, d_model=32,
               num_heads=4, num_kv_heads=2, d_ff=16, vocab_size=64,
               num_experts=num_experts, top_k=top_k, expert_pad_to=pad,
               capacity_factor=cf, mlp=mlp)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Config and dispatch.
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    """configs/granite_moe_3b_a800m.py is the reference's, field for field,
    full and reduced; its parameter count is the reference's."""
    for j, t in ((jax_get_config(ARCH), get_config(ARCH)),
                 (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    full = get_config(ARCH)
    assert (full.num_experts, TM.expert_store_count(full)) == (40, 48)


@pytest.mark.parametrize("tokens", [1, 4, 7, 64, 2048])
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_capacity_and_store_count_equal_reference(tokens, cf):
    for e, k, pad in ((8, 2, 1), (40, 8, 16), (6, 2, 4)):
        cj = _tiny(JModelConfig, e, k, pad, cf)
        ct = _tiny(ModelConfig, e, k, pad, cf)
        assert TM._capacity(tokens, ct) == JM._capacity(tokens, cj)
        assert TM.expert_store_count(ct) == JM.expert_store_count(cj)


def _dispatch_pair(eidx, num_experts, capacity):
    sj, vj = JM._dispatch_indices(jnp.asarray(eidx, jnp.int32), num_experts,
                                  capacity)
    st, vt = TM._dispatch_indices(torch.from_numpy(np.asarray(eidx)),
                                  num_experts, capacity)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    return st.numpy(), vt.numpy()


def test_dispatch_indices_rank_within_expert():
    """The reference's own case (tests/test_moe.py)."""
    slot, valid = _dispatch_pair([3, 1, 3, 3, 0, 1], 4, 2)
    assert slot[4] == 0 and (slot[1], slot[5]) == (2, 3)
    assert (slot[0], slot[2]) == (6, 7) and not valid[3]


@pytest.mark.parametrize("seed", range(4))
def test_dispatch_indices_equal_reference_with_drops(seed):
    rng = np.random.default_rng(seed)
    n, e = int(rng.integers(1, 300)), int(rng.integers(1, 48))
    eidx = rng.integers(0, e, n)
    cap = int(rng.integers(1, max(2, n // e + 2)))
    _, valid = _dispatch_pair(eidx, e, cap)
    if n > e * cap:
        assert not valid.all()


def test_top_k_ties_go_to_the_lower_index():
    """Equal router probabilities: the port picks what lax.top_k picks."""
    probs = np.full((5, 40), 0.01, np.float32)
    probs[0, [3, 17, 30]] = 0.2                      # a three-way tie for top-2
    probs[1, :] = 0.025                              # all tied
    probs[2, [39, 0]] = 0.3
    probs[3, [5, 6, 7, 8]] = [0.1, 0.2, 0.2, 0.1]
    probs[4, ::-1] = np.repeat(np.arange(8, dtype=np.float32), 5) / 100
    for k in (1, 2, 8):
        gj, ej = jax.lax.top_k(jnp.asarray(probs), k)
        gt, et = TM._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


# ---------------------------------------------------------------------------
# The dense layer.
# ---------------------------------------------------------------------------

def _granite_layer(cf):
    """The reduced granite's first MoE layer in float32, reference and port
    (the port's through params_from_numpy), with 64 tokens that share an
    offset, so that the router crowds some experts past capacity."""
    cj = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype="float32",
                             capacity_factor=cf)
    ct = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                             capacity_factor=cf)
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    mj = jax.tree_util.tree_map(lambda a: a[0], pj["stack"][0]["moe"])
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, cj.d_model))
         + 2 * rng.normal(size=cj.d_model)).astype(np.float32)
    return cj, ct, mj, pt["layers"][0]["moe"], x


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_dense_moe_local_equals_reference(cf):
    cj, ct, mj, mt, x = _granite_layer(cf)
    yj, auxj, zj = JM._moe_local(mj, jnp.asarray(x), cj, None, None)
    yt, auxt, zt = TM._moe_local(mt, torch.from_numpy(x), ct, None, None)
    np.testing.assert_allclose(_f32(yt), _f32(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)
    np.testing.assert_allclose(float(zt), float(zj), **TOL)
    dropped = 64 * ct.top_k - int(TM._route(
        mt, torch.from_numpy(x), ct, 8, TM._capacity(64, ct))[5].sum())
    assert (dropped > 0) == (cf == 1.25)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_apply_moe_every_ffn_kind_equals_reference(mlp):
    """apply_moe's dense path (B, T, d) and init_moe's tree, each FFN kind,
    with a padded store (6 experts stored as 8)."""
    cj, ct = _tiny(JModelConfig, 6, 2, 4, 1.25, mlp), _tiny(ModelConfig, 6, 2,
                                                           4, 1.25, mlp)
    pj = JM.init_moe(jax.random.PRNGKey(1), cj, jnp.float32)
    pt = _to_torch(pj)
    mine = TM.init_moe(torch.Generator().manual_seed(1), ct, torch.float32)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in pj.items()}
    x = np.random.default_rng(4).normal(size=(2, 9, 32)).astype(np.float32)
    yj, auxj = JM.apply_moe(pj, jnp.asarray(x), cj, JRules())
    yt, auxt = TM.apply_moe(pt, torch.from_numpy(x), ct, AxisRules())
    np.testing.assert_allclose(_f32(yt), _f32(yj), **TOL)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]), **TOL)


def test_expert_slice_pads_an_off_spec_store():
    """The reference's fallback (moe.py:185-191): a store that does not
    divide the shards is zero-padded before it is cut."""
    ct = _tiny(ModelConfig, 6, 2, 1)
    p = TM.init_moe(torch.Generator().manual_seed(0), ct, torch.float32)
    parts = [TM.expert_slice(p, r, 4) for r in range(4)]
    assert [q["wi"].shape[0] for q in parts] == [2] * 4
    torch.testing.assert_close(torch.cat([q["wo"] for q in parts])[:6],
                               p["wo"], rtol=0, atol=0)
    assert not torch.cat([q["wg"] for q in parts])[6:].any()
    assert all(q["router"] is p["router"] for q in parts)
    with pytest.raises(ValueError, match="slice"):
        TM.apply_moe(p, torch.zeros(1, 2, 32), ct,
                     AxisRules(tp="model", mesh=_FakeMesh(model=4)))


class _FakeMesh:
    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]


# ---------------------------------------------------------------------------
# The expert-parallel path (gloo, 8 ranks) against dense and the reference.
# ---------------------------------------------------------------------------

#: (name, num_experts, capacity factor): 8.0 drops nothing, so EP equals
#: dense; at 1.25 each data shard's capacity drops tokens, as the
#: reference's EP does.  6 experts over 4 shards take the padding fallback.
EP_CASES = (("even_cf8", 8, 8.0), ("even_cf125", 8, 1.25),
            ("offspec_cf8", 6, 8.0))

_EP_INPUTS = r"""
import numpy as np
EP_CASES = (("even_cf8", 8, 8.0), ("even_cf125", 8, 1.25),
            ("offspec_cf8", 6, 8.0))
X = np.random.default_rng(5).normal(size=(4, 8, 32)).astype(np.float32)
#: The reduced granite over the same mesh: prompts of 9 tokens and a cache
#: of 16 for prefill and one decode step; four prompts of unequal length
#: for the serving engine, 4 greedy tokens each.  Data shard i takes rows
#: (requests) 2i and 2i + 1.
MODEL_SEED, MODEL_T, MODEL_SEQ = 0, 9, 16
MODEL_TOKENS = np.random.default_rng(11).integers(0, 256, (4, MODEL_T))
ENGINE_PROMPTS = [np.random.default_rng(12 + n).integers(0, 256, n,
                                                         dtype=np.int32)
                  for n in (5, 9, 3, 7)]
ENGINE_NEW, ENGINE_SEQ = 4, 24
"""

_EP_REF = _EP_INPUTS + r"""
import sys
import jax, jax.numpy as jnp
from repro._compat.jaxapi import make_auto_mesh, set_mesh
from repro.models.config import ModelConfig
from repro.models.layers import AxisRules
from repro.models.moe import apply_moe, init_moe

mesh = make_auto_mesh((2, 4), ("data", "model"))
rules = AxisRules(dp=("data",), tp="model", mesh=mesh)
out = {}
for name, e, cf in EP_CASES:
    cfg = ModelConfig(name="tiny-moe", family="moe", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=16, vocab_size=64,
                      num_experts=e, top_k=2, expert_pad_to=1,
                      capacity_factor=cf)
    p = init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    with set_mesh(mesh):
        y, aux = jax.jit(lambda p_, x_: apply_moe(p_, x_, cfg, rules))(p, X)
    out[name + "_y"] = np.asarray(y)
    out[name + "_aux"] = np.asarray(aux["moe_aux"])
    out[name + "_z"] = np.asarray(aux["moe_z"])
    for k, v in p.items():
        out[f"{name}_p_{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""

_EP_RANK = _EP_INPUTS + r"""
import datetime, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.core import collectives as C
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import AxisRules
from repro_torch.models import (cast_params, decode_step, expert_shard,
                                get_config, init_params, prefill)
from repro_torch.models.moe import apply_moe, expert_slice
from repro_torch.serving import Request, ServingEngine

mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
rules = AxisRules(dp=("data",), tp="model", mesh=mesh)
i, j = mesh.get_coordinate()
weights = np.load(f"{outdir}/../ref.npz")
out = {}
for name, e, cf in EP_CASES:
    cfg = ModelConfig(name="tiny-moe", family="moe", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=16, vocab_size=64,
                      num_experts=e, top_k=2, expert_pad_to=1,
                      capacity_factor=cf)
    full = {k: torch.from_numpy(weights[f"{name}_p_{k}"])
            for k in ("router", "wi", "wo", "wg")}
    p = {k: v.requires_grad_(True)
         for k, v in expert_slice(full, j, 4).items()}
    x = torch.from_numpy(X[2 * i:2 * i + 2])
    before = C.exchanges
    y, aux = apply_moe(p, x, cfg, rules)
    (y ** 2).sum().backward()
    out[name + "_exchanges"] = np.int64(C.exchanges - before)
    out[name + "_y"] = y.detach().numpy()
    out[name + "_aux"] = aux["moe_aux"].detach().numpy()
    out[name + "_z"] = aux["moe_z"].detach().numpy()
    out[name + "_grads_finite"] = np.bool_(all(
        torch.isfinite(v.grad).all() for v in p.values()))

# The reduced granite, this rank's token shard and expert slice.
import dataclasses
mcfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                           dtype="float32")
pm = expert_shard(cast_params(init_params(MODEL_SEED, mcfg, device="cpu"),
                              mcfg), j, 4)
before = C.exchanges
with torch.no_grad():
    logits, caches = prefill(
        pm, {"tokens": torch.from_numpy(MODEL_TOKENS[2 * i:2 * i + 2])},
        mcfg, MODEL_SEQ, rules=rules)
    step, _ = decode_step(pm, logits.argmax(-1), caches, MODEL_T, mcfg,
                          MODEL_SEQ, rules=rules)
out["model_exchanges"] = np.int64(C.exchanges - before)
out["model_prefill"] = logits.numpy()
out["model_step"] = step.numpy()
eng = ServingEngine(mcfg, pm, slots=2, max_seq=ENGINE_SEQ, rules=rules,
                    device="cpu")
for r in (2 * i, 2 * i + 1):
    eng.submit(Request(rid=r, prompt=ENGINE_PROMPTS[r],
                       max_new_tokens=ENGINE_NEW))
out["engine_tokens"] = np.array([req.out_tokens for req in
                                 sorted(eng.run(), key=lambda q: q.rid)])
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", **out)
"""


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """The reference's EP outputs and weights, then the port's 8 ranks on
    those weights."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    ref = join_reference(start_reference(_EP_REF, tmp / "ref.npz"))
    return ref, join_ranks(start_ranks(_EP_RANK, 8, tmp / "ranks"))


def _ep_output(outs, name):
    """y over the whole batch from the ranks of each data shard, which
    must agree within their model group."""
    ys = []
    for i in range(2):
        group = [outs[4 * i + j][name + "_y"] for j in range(4)]
        for y in group[1:]:
            np.testing.assert_array_equal(y, group[0])
        ys.append(group[0])
    return np.concatenate(ys)


@pytest.mark.parametrize("name,e,cf", EP_CASES)
def test_ep_equals_reference_ep(ep_runs, name, e, cf):
    """LACIN-EP over the (2, 4) DeviceMesh: y, moe_aux and moe_z equal the
    reference's EP on the same mesh shape, weights and tokens; every rank
    posts the dispatch's and the combine's 3 + 3 exchanges, and in backward
    the combine's 3 inverses (the tokens carry no gradient, so the
    dispatch's are not run); gradients are finite."""
    ref, outs = ep_runs
    np.testing.assert_allclose(_ep_output(outs, name), ref[name + "_y"],
                               **EP_TOL)
    for o in outs:
        for key in ("_aux", "_z"):
            np.testing.assert_allclose(o[name + key], ref[name + key],
                                       **EP_TOL)
        assert int(o[name + "_exchanges"]) == 9
        assert bool(o[name + "_grads_finite"])


@pytest.mark.parametrize("name", ["even_cf8", "offspec_cf8"])
def test_ep_equals_dense(ep_runs, name):
    """With nothing dropped, EP equals the port's own dense path."""
    ref, outs = ep_runs
    _, e, cf = dict((c[0], c) for c in EP_CASES)[name]
    cfg = dataclasses.replace(_tiny(ModelConfig, e, 2, 1, cf),
                              moe_impl="dense")
    p = {k: torch.from_numpy(ref[f"{name}_p_{k}"])
         for k in ("router", "wi", "wo", "wg")}
    x = np.random.default_rng(5).normal(size=(4, 8, 32)).astype(np.float32)
    y, _ = TM.apply_moe(p, torch.from_numpy(x), cfg, AxisRules())
    np.testing.assert_allclose(_ep_output(outs, name), _f32(y), **EP_TOL)


def _model_shards():
    """The reduced granite as every EP rank initialises it, and data
    shard i's inputs."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    params = TT.cast_params(TT.init_params(0, cfg, device="cpu"), cfg)
    g = {}
    exec(_EP_INPUTS, g)
    return cfg, params, g


def test_ep_model_prefill_and_decode_equal_dense(ep_runs):
    """The reduced granite's prefill and one decode step with
    ``rules=AxisRules(dp=("data",), tp="model", mesh)`` and
    ``expert_shard`` params on the (2, 4) mesh equal the dense model on
    each data shard's tokens (so the per-shard capacity drops the same
    assignments); each rank posts 3 + 3 exchanges a MoE layer a call."""
    _, outs = ep_runs
    cfg, params, g = _model_shards()
    for i in range(2):
        toks = torch.from_numpy(g["MODEL_TOKENS"][2 * i:2 * i + 2])
        logits, caches = TT.prefill(params, {"tokens": toks}, cfg,
                                    g["MODEL_SEQ"])
        step, _ = TT.decode_step(params, logits.argmax(-1), caches,
                                 g["MODEL_T"], cfg, g["MODEL_SEQ"])
        for j in range(4):
            o = outs[4 * i + j]
            np.testing.assert_allclose(o["model_prefill"], _f32(logits),
                                       **EP_TOL)
            np.testing.assert_allclose(o["model_step"], _f32(step), **EP_TOL)
            assert int(o["model_exchanges"]) == 2 * cfg.num_layers * 6


def test_ep_serving_engine_equals_dense(ep_runs):
    """ServingEngine with the EP rules on every rank (2 slots, each data
    shard its own 2 requests) gives the dense engine's greedy tokens."""
    _, outs = ep_runs
    cfg, params, g = _model_shards()
    for i in range(2):
        eng = ServingEngine(cfg, params, slots=2, max_seq=g["ENGINE_SEQ"],
                            device="cpu")
        for r in (2 * i, 2 * i + 1):
            eng.submit(Request(rid=r, prompt=g["ENGINE_PROMPTS"][r],
                               max_new_tokens=g["ENGINE_NEW"]))
        want = [q.out_tokens for q in sorted(eng.run(), key=lambda q: q.rid)]
        for j in range(4):
            assert outs[4 * i + j]["engine_tokens"].tolist() == want


# ---------------------------------------------------------------------------
# The reduced model and the serving engine.
# ---------------------------------------------------------------------------

def _models():
    cj = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype="float32",
                             attention_impl="reference")
    ct = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    return cj, ct, pj, pt


def test_reduced_granite_prefill_and_decode_equal_reference():
    cj, ct, pj, pt = _models()
    assert set(pt["layers"][0]) == {"ln1", "attn", "ln2", "moe"}
    assert tuple(pt["layers"][0]["moe"]["wi"].shape) == (8, 64, 128)
    pt = TT.cast_params(pt, ct)
    seq_len, t = 24, 11
    tokens = np.random.default_rng(9).integers(0, cj.vocab_size, (2, t))
    lj, cache_j = JT.prefill(pj, {"tokens": jnp.asarray(tokens, jnp.int32)},
                             cj, JRules(), seq_len)
    lt, cache_t = TT.prefill(pt, {"tokens": torch.from_numpy(tokens)}, ct,
                             seq_len, rules=AxisRules())
    np.testing.assert_allclose(_f32(lt), _f32(lj), rtol=0, atol=MODEL_ATOL)
    nxt = np.array(jnp.argmax(lj[:, -1], -1))[:, None]
    for pos in (t, t + 1):
        lj, cache_j = JT.decode_step(pj, jnp.asarray(nxt, jnp.int32), cache_j,
                                     jnp.asarray(pos, jnp.int32), cj,
                                     JRules(), seq_len)
        lt, cache_t = TT.decode_step(pt, torch.from_numpy(nxt), cache_t, pos,
                                     ct, seq_len)
        np.testing.assert_allclose(_f32(lt), _f32(lj), rtol=0,
                                   atol=MODEL_ATOL)
        for layer, c in enumerate(cache_t):
            for n in ("k", "v"):
                np.testing.assert_allclose(_f32(c[n]),
                                           _f32(cache_j[0][n][layer]),
                                           rtol=0, atol=MODEL_ATOL)
        nxt = (nxt + 7) % cj.vocab_size


def test_stack_returns_the_summed_moe_losses():
    """apply_stack sums every layer's [moe_aux, moe_z], as the reference's
    apply_stack does in train mode."""
    cj, ct, pj, pt = _models()
    pt = TT.cast_params(pt, ct)
    tokens = np.random.default_rng(2).integers(0, cj.vocab_size, (2, 9))
    xj = jnp.take(pj["embed"]["table"], jnp.asarray(tokens), axis=0)
    pos = jnp.arange(9, dtype=jnp.int32)
    _, _, auxj = JT.apply_stack(pj["stack"], xj, cj, JRules(),
                                JT.build_runs(cj), q_pos=pos, kv_pos=pos)
    xt = pt["embed"]["table"][torch.from_numpy(tokens)]
    post = torch.arange(9, dtype=torch.int32)
    _, _, auxt = TT.apply_stack(pt, xt, ct, q_pos=post, kv_pos=post)
    np.testing.assert_allclose(_f32(auxt), _f32(auxj), rtol=1e-5, atol=1e-5)


def test_greedy_tokens_equal_reference_engine():
    """ServingEngine, 4 slots, prompts of unequal length (left-padded, so
    the pads route through the MoE with the rest of the batch), 8 greedy
    tokens each: the reference engine's tokens."""
    cj, ct, pj, pt = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cj.vocab_size, n, dtype=np.int32)
               for n in (5, 9, 3, 7)]
    outs = []
    for eng, cls in ((JServingEngine(cj, pj, slots=4, max_seq=32), JRequest),
                     (ServingEngine(ct, pt, slots=4, max_seq=32,
                                    device="cpu"), Request)):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == 4
        outs.append({r.rid: r.out_tokens for r in done})
    assert outs[1] == outs[0]
    assert all(len(t) == 8 for t in outs[1].values())


def test_expert_shard_cuts_every_moe_layer():
    _, ct, _, pt = _models()
    shards = [expert_shard(pt, r, 4) for r in range(4)]
    for layer in range(ct.num_layers):
        parts = [s["layers"][layer]["moe"]["wi"] for s in shards]
        assert [tuple(w.shape) for w in parts] == [(2, 64, 128)] * 4
        torch.testing.assert_close(torch.cat(parts),
                                   pt["layers"][layer]["moe"]["wi"],
                                   rtol=0, atol=0)
        assert shards[1]["layers"][layer]["attn"] is pt["layers"][layer]["attn"]
