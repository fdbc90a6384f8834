"""repro_torch.models against the JAX reference repro.models, on the CPU.

Same inputs (numpy, from a seed) and same weights (the reference's
``init_params(PRNGKey(0))`` through ``params_from_numpy``) go through both.
Tolerances: float32 atol 1e-5; bfloat16 atol 2e-2 (a few bf16 ulps of
logits of magnitude about 1).  bfloat16 k/v caches reach |4|, where one
bf16 ulp is 2**-5, and later layers inherit the residual stream's rounding
differences: atol 6.25e-2, two ulps there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.layers import AxisRules

from repro_torch.models import get_config, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ARCHS = ["llama3.2-3b", "lacin-demo"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=0, atol=2e-2)}
CACHE_TOL = dict(TOL, bfloat16=dict(rtol=0, atol=6.25e-2))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(x, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), dtype), t


def _configs(arch, dtype):
    j = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    t = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return j, t


def _models(arch, dtype):
    cj, ct = _configs(arch, dtype)
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    """repro_torch.models.config is a copy of repro.models.config."""
    for j, t in ((jax_get_config(arch), get_config(arch)),
                 (jax_get_config(arch).reduced(), get_config(arch).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert [dataclasses.astuple(r) for r in JT.build_runs(j)] == \
            [dataclasses.astuple(r) for r in TT.build_runs(t)]


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_norm_matches_reference(norm, dtype):
    """repro.models.layers.apply_norm / rms_norm_head."""
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)) * 3, dtype)
    scale = rng.normal(size=(64,)) * 0.1
    bias = rng.normal(size=(64,)) * 0.1
    pj = {"scale": jnp.asarray(scale, dtype)}
    pt = {"scale": torch.from_numpy(scale).to(getattr(torch, dtype))}
    if norm == "layernorm":
        pj["bias"] = jnp.asarray(bias, dtype)
        pt["bias"] = torch.from_numpy(bias).to(getattr(torch, dtype))
    np.testing.assert_allclose(_f32(TL.apply_norm(pt, xt)),
                               _f32(JL.apply_norm(pj, xj)), **TOL[dtype])
    np.testing.assert_allclose(_f32(TL.rms_norm_head(xt)),
                               _f32(JL.rms_norm_head(xj)), **TOL[dtype])


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_matches_reference(theta, dtype):
    """repro.models.layers.rope_cos_sin / apply_rope, prefill and decode
    positions."""
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(size=(2, 6, 3, 32)), dtype)
    for pos in (np.arange(6), np.arange(1000, 1006)):
        cj, sj = JL.rope_cos_sin(jnp.asarray(pos, jnp.int32), 32, theta)
        ct, st = TL.rope_cos_sin(torch.from_numpy(pos).int(), 32, theta)
        np.testing.assert_allclose(_f32(ct), _f32(cj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_f32(st), _f32(sj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_f32(TL.apply_rope(xt, ct, st)),
                                   _f32(JL.apply_rope(xj, cj, sj)),
                                   **TOL[dtype])


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "squared_relu", "gelu"])
@pytest.mark.parametrize("bias", [False, True])
def test_apply_mlp_matches_reference(mlp, bias):
    """repro.models.layers.apply_mlp, all four kinds (float32)."""
    cfg = dataclasses.replace(get_config("lacin-demo").reduced(), mlp=mlp,
                              mlp_bias=bias)
    pj = JL.init_mlp(jax.random.PRNGKey(3), cfg, jnp.float32)
    if bias:
        rng = np.random.default_rng(4)
        pj = dict(pj, bi=jnp.asarray(rng.normal(size=pj["bi"].shape), jnp.float32),
                  bo=jnp.asarray(rng.normal(size=pj["bo"].shape), jnp.float32))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = np.random.default_rng(5).normal(size=(2, 7, cfg.d_model))
    xj, xt = _pair(x, "float32")
    np.testing.assert_allclose(_f32(TL.apply_mlp(pt, xt, cfg)),
                               _f32(JL.apply_mlp(pj, xj, cfg, AxisRules())),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_projections_match_reference(dtype):
    """repro.models.layers.qkv_proj / out_proj (GQA layouts kept)."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype=dtype)
    pj = JL.init_attention(jax.random.PRNGKey(6), cfg, jnp.float32)
    pj = {k: v.astype(dtype) for k, v in pj.items()}
    pt = {k: torch.from_numpy(np.array(v, np.float32)).to(getattr(torch, dtype))
          for k, v in pj.items()}
    xj, xt = _pair(np.random.default_rng(7).normal(size=(2, 5, cfg.d_model)),
                   dtype)
    for a, b in zip(TL.qkv_proj(pt, xt, cfg), JL.qkv_proj(pj, xj, cfg,
                                                         AxisRules())):
        np.testing.assert_allclose(_f32(a), _f32(b), **TOL[dtype])
    oj, ot = _pair(np.random.default_rng(8).normal(
        size=(2, 5, cfg.num_heads, cfg.head_dim)), dtype)
    np.testing.assert_allclose(_f32(TL.out_proj(pt, ot)),
                               _f32(JL.out_proj(pj, oj, AxisRules())),
                               **TOL[dtype])


def _stack_caches(port_caches):
    """Port per-layer caches -> the reference's single stacked run."""
    return {n: np.stack([_f32(c[n]) for c in port_caches]) for n in ("k", "v")}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(arch, dtype):
    """repro.models.transformer.prefill and decode_step
    (attention_impl="reference"): logits and caches."""
    cj, ct, pj, pt = _models(arch, dtype)
    pt = TT.cast_params(pt, ct)
    seq_len, t = 24, 11
    tokens = np.random.default_rng(9).integers(0, cj.vocab_size, (2, t))
    lj, cache_j = JT.prefill(pj, {"tokens": jnp.asarray(tokens, jnp.int32)},
                             cj, AxisRules(), seq_len)
    lt, cache_t = TT.prefill(pt, {"tokens": torch.from_numpy(tokens)}, ct,
                             seq_len)
    assert lt.shape == lj.shape == (2, 1, cj.vocab_padded)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **TOL[dtype])
    (run_j,) = cache_j
    for n, a in _stack_caches(cache_t).items():
        np.testing.assert_allclose(a, _f32(run_j[n]), **CACHE_TOL[dtype])

    nxt = np.array(jnp.argmax(lj[:, -1], -1))[:, None]
    for pos in (t, t + 1):
        lj, cache_j = JT.decode_step(pj, jnp.asarray(nxt, jnp.int32), cache_j,
                                     jnp.asarray(pos, jnp.int32), cj,
                                     AxisRules(), seq_len)
        lt, cache_t = TT.decode_step(pt, torch.from_numpy(nxt), cache_t, pos,
                                     ct, seq_len)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **TOL[dtype])
        (run_j,) = cache_j
        for n, a in _stack_caches(cache_t).items():
            np.testing.assert_allclose(a, _f32(run_j[n]), **CACHE_TOL[dtype])
        nxt = (nxt + 7) % cj.vocab_size


def test_decode_past_the_cache_raises():
    """Where the reference clamps the cache write, the port raises."""
    _, ct, _, pt = _models("llama3.2-3b", "float32")
    caches = TT.init_caches(ct, 1, 8, device="cpu")
    with pytest.raises(IndexError):
        TT.decode_step(pt, torch.zeros((1, 1), dtype=torch.int64), caches, 8,
                       ct, 8)


def test_params_are_cast_once_where_they_enter():
    """cast_params casts what the reference casts at use, in every layer
    and the embedding, and keeps the final norm's dtype, as
    repro.models.transformer does; prefill refuses parameters not cast."""
    _, ct, _, pt = _models("llama3.2-3b", "bfloat16")
    tokens = {"tokens": torch.zeros((1, 3), dtype=torch.int64)}
    with pytest.raises(TypeError, match="cast_params"):
        TT.prefill(pt, tokens, ct, 8)
    cast = TT.cast_params(pt, ct)
    assert cast["final_norm"]["scale"].dtype == torch.float32
    assert {a.dtype for layer in cast["layers"]
            for a in jax.tree_util.tree_leaves(layer)} == {torch.bfloat16}
    assert cast["embed"]["table"].dtype == torch.bfloat16
    assert TT.cast_params(cast, ct)["layers"][0]["attn"]["wq"] is \
        cast["layers"][0]["attn"]["wq"]
    logits, _ = TT.prefill(cast, tokens, ct, 8)
    assert logits.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """repro.models.transformer.init_params: same leaves, shapes, dtypes and
    scales (the draws differ: torch.Generator vs jax.random)."""
    cj, ct, pj, pt = _models(arch, "bfloat16")
    ours = TT.init_params(0, ct, device="cpu")
    assert set(ours) == set(pt)
    assert len(ours["layers"]) == len(pt["layers"]) == ct.num_layers
    for mine, conv in zip(ours["layers"] + [ours["embed"], ours["final_norm"]],
                          pt["layers"] + [pt["embed"], pt["final_norm"]]):
        flat_m = jax.tree_util.tree_leaves_with_path(mine)
        flat_c = jax.tree_util.tree_leaves_with_path(conv)
        assert [p for p, _ in flat_m] == [p for p, _ in flat_c]
        for (_, a), (_, b) in zip(flat_m, flat_c):
            assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
            np.testing.assert_allclose(a.std().item(), b.std().item(),
                                       rtol=0.2, atol=1e-6)
    again = TT.init_params(0, ct, device="cpu")
    assert torch.equal(again["layers"][0]["attn"]["wq"],
                       ours["layers"][0]["attn"]["wq"])


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("lacin-demo").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_caches(cfg, 1, 8)


def test_unported_parts_raise():
    base = get_config("llama3.2-3b").reduced()
    for cfg in (dataclasses.replace(base, num_experts=4, top_k=2),
                dataclasses.replace(base, block_pattern=("attn", "mlstm") * 2),
                dataclasses.replace(base, num_meta_tokens=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TT.init_params(0, cfg, device="cpu")
