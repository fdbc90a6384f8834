"""repro_torch.models against the JAX reference repro.models, on the CPU.

Same inputs (numpy, from a seed) and same weights (the reference's
``init_params(PRNGKey(0))`` through ``params_from_numpy``) go through both.
Tolerances: float32 atol 1e-5; bfloat16 atol 2e-2 (a few bf16 ulps of
logits of magnitude about 1).  bfloat16 k/v caches reach |4|, where one
bf16 ulp is 2**-5, and later layers inherit the residual stream's rounding
differences: atol 6.25e-2, two ulps there.  The xLSTM's recurrent caches
(mLSTM C, n, m and the conv inputs; sLSTM h, c, n, m) carry the whole
prompt: C, n and m sum terms of it, in float32 in both configurations, and
the conv inputs have passed through earlier layers' state.  They round
relative to the leaf's scale.  In float32 each element is held to 1e-5 of
the leaf's largest magnitude (C and n reach 20, where an fp32 ulp is 2e-6).
In bfloat16 they are driven by bf16 activations, where one ulp of a gate
pre-activation moves the stabilizer m and rescales C and n with it, so
each leaf is held in relative L2 to 5e-2, the measure chip_smoke.py holds
bf16 logits to.
"""
import dataclasses
import functools
import importlib.util
import os

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama3.2-3b", "lacin-demo", "xlstm-350m", "gemma3-1b",
         "starcoder2-3b"]
#: Configs with a prefix or an encoder: hymba-1.5b (hymba blocks, meta
#: tokens), whisper-base (encoder, cross-attention), internvl2-26b (patch
#: prefixes).
PREFIX_ARCHS = ["hymba-1.5b", "whisper-base", "internvl2-26b"]
#: nemotron-4-15b (layernorm, squared-ReLU MLP, untied head) and
#: qwen3-moe-30b-a3b (qk-norm, every layer a MoE).
SERVED_ARCHS = ["nemotron-4-15b", "qwen3-moe-30b-a3b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=0, atol=2e-2)}
CACHE_TOL = dict(TOL, bfloat16=dict(rtol=0, atol=6.25e-2))
STATE_TOL = 1e-5
STATE_REL_L2 = 5e-2
#: whisper-base's bf16 logits.  Its untied head gives logits up to 3.8,
#: where one bf16 ulp is 2**-6, so TOL's 2e-2 is 1.3 ulps there; and its
#: encoder is non-causal over the frames, whose output every decoder
#: position reads through the cross K/V: one element of the encoder's
#: attention that rounds to the other bf16 neighbour (an fp32 sum of 16
#: terms in another order: 1 of 2,048 in layer 0 at the test's seed) moves
#: 195 of 512 prefill logits, by up to 0.03125 (2 ulps at 2-4).  Over the
#: five draws of test_prefix_and_encoder_models_match_reference and
#: test_whisper_bf16_matches_reference_at_other_seeds no logit moves by
#: more (one draw matches bit for bit): held to 3 ulps there.
ENCODER_BF16_TOL = dict(rtol=0, atol=4.6875e-2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small models run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them made these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(x, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), dtype), t


def _configs(arch, dtype, **kw):
    j = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype, **kw)
    t = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **kw)
    return j, t


def _models(arch, dtype, seed=0, **kw):
    cj, ct = _configs(arch, dtype, **kw)
    pj = JT.init_params(jax.random.PRNGKey(seed), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("arch", ARCHS + PREFIX_ARCHS + SERVED_ARCHS)
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
def test_gelu_rounds_as_the_reference(dtype):
    """layers.gelu_tanh against jax.nn.gelu(approximate=True), which the
    reference's gelu and geglu MLPs apply: bit for bit in bfloat16 (where
    F.gelu's single rounding differs by an ulp), 1e-6 in float32."""
    x = np.random.default_rng(6).normal(size=(4096,)) * 3
    xj, xt = _pair(x, dtype)
    got, want = _f32(TL.gelu_tanh(xt)), _f32(jax.nn.gelu(xj, approximate=True))
    tol = dict(rtol=0, atol=0) if dtype == "bfloat16" else dict(rtol=0,
                                                                  atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_rounds_as_the_reference_on_the_cpu(dtype):
    """layers.silu on a CPU tensor against jax.nn.silu, which the
    reference's swiglu MLPs, SSM and xLSTM blocks apply: bit for bit in
    bfloat16 (where F.silu's single rounding differs by an ulp), 1e-6 in
    float32.  (On the card it is F.silu.)"""
    x = np.random.default_rng(7).normal(size=(4096,)) * 3
    xj, xt = _pair(x, dtype)
    got, want = _f32(TL.silu(xt)), _f32(jax.nn.silu(xj))
    tol = dict(rtol=0, atol=0) if dtype == "bfloat16" else dict(rtol=0,
                                                                  atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)


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


@functools.cache
def _chip_smoke():
    """chip_smoke.py as a module: its model_extras draws the stub frames
    and patch embeddings, for the card's run and these tests alike."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch_pair(cfg, tokens, seed=10):
    """The reference's and the port's prefill batch: ``tokens``, with the
    encoder's frames and the patch embeddings where ``cfg`` takes them
    (chip_smoke.model_extras: seeded, x 0.02, as tests/test_smoke_archs.py
    draws them)."""
    bt = {"tokens": torch.from_numpy(tokens),
          **_chip_smoke().model_extras(cfg, tokens.shape[0],
                                       np.random.default_rng(seed), "cpu")}
    bj = {name: jnp.asarray(x.numpy()) for name, x in bt.items()}
    bj["tokens"] = jnp.asarray(tokens, jnp.int32)
    return bj, bt


def _stack_caches(port_caches, cfg):
    """Port per-layer caches -> the reference's per-run stacks: one
    {leaf: (run.count, ...) float32 array} per run, and the leaves' dtypes."""
    runs, i = [], 0
    for run in TT.build_runs(cfg):
        layers = port_caches[i:i + run.count]
        i += run.count
        runs.append({n: (np.stack([_f32(c[n]) for c in layers]),
                         str(layers[0][n].dtype).removeprefix("torch."))
                     for n in layers[0]})
    assert i == len(port_caches)
    return runs


def _assert_caches_match(port_caches, ref_caches, cfg, dtype):
    stacked = _stack_caches(port_caches, cfg)
    assert len(stacked) == len(ref_caches)
    for run_t, run_j in zip(stacked, ref_caches):
        assert set(run_t) == set(run_j)
        for n, (a, a_dtype) in run_t.items():
            want = _f32(run_j[n])
            assert a.shape == want.shape and a_dtype == str(run_j[n].dtype), n
            if n in ("k", "v", "ck", "cv"):
                np.testing.assert_allclose(a, want, **CACHE_TOL[dtype])
            elif dtype == "float32":
                np.testing.assert_allclose(
                    a, want, rtol=0, atol=STATE_TOL * np.abs(want).max())
            else:
                rel = np.linalg.norm(a - want) / np.linalg.norm(want)
                assert rel <= STATE_REL_L2, (n, rel)


def _check_prefill_and_decode(arch, dtype, t, seq_len, logits_tol=None,
                              seeds=(0, 9, 10), **kw):
    """``seeds``: of the parameters, the tokens and the frames or
    patches."""
    logits_tol = logits_tol or TOL[dtype]
    cj, ct, pj, pt = _models(arch, dtype, seed=seeds[0], **kw)
    pt = TT.cast_params(pt, ct)
    tokens = np.random.default_rng(seeds[1]).integers(0, cj.vocab_size,
                                                      (2, t))
    bj, bt = _batch_pair(cj, tokens, seed=seeds[2])
    lj, cache_j = JT.prefill(pj, bj, cj, AxisRules(), seq_len)
    lt, cache_t = TT.prefill(pt, bt, ct, seq_len)
    assert lt.shape == lj.shape == (2, 1, cj.vocab_padded)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **logits_tol)
    _assert_caches_match(cache_t, cache_j, ct, dtype)

    # decode goes on where the prompt's prefix and tokens end
    start = t + TT.prefix_len(ct, bt)
    nxt = np.array(jnp.argmax(lj[:, -1], -1))[:, None]
    for pos in (start, start + 1):
        lj, cache_j = JT.decode_step(pj, jnp.asarray(nxt, jnp.int32), cache_j,
                                     jnp.asarray(pos, jnp.int32), cj,
                                     AxisRules(), seq_len)
        lt, cache_t = TT.decode_step(pt, torch.from_numpy(nxt), cache_t, pos,
                                     ct, seq_len)
        np.testing.assert_allclose(_f32(lt), _f32(lj), **logits_tol)
        _assert_caches_match(cache_t, cache_j, ct, dtype)
        nxt = (nxt + 7) % cj.vocab_size


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "starcoder2-3b"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(arch, dtype):
    """repro.models.transformer.prefill and decode_step
    (attention_impl="reference"): logits and caches.  T = 11 takes the
    mLSTM's sequential path."""
    _check_prefill_and_decode(arch, dtype, t=11, seq_len=24)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_served_archs_prefill_and_decode_match_reference(arch, dtype):
    """nemotron-4-15b and qwen3-moe-30b-a3b reduced: logits and caches of
    repro.models.transformer.prefill and decode_step; in bf16 against the
    reference with its layers unrolled, as starcoder2-3b's (its
    ``lax.scan`` over layers rounds bf16 otherwise, C17)."""
    _check_prefill_and_decode(arch, dtype, t=11, seq_len=24,
                              scan_layers=dtype == "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_starcoder2_prefill_and_decode_match_reference(dtype):
    """starcoder2-3b reduced (layernorm, gelu and biases; 4 query heads a KV
    head): the same, against the reference with its layers unrolled
    (``scan_layers=False``: the same model, layer after layer, as the
    port's loop runs it).  In bf16 the port's logits then equal the
    reference's bit for bit; the reference's ``lax.scan`` over layers
    rounds bf16 otherwise inside its fused body, by up to 1.5 ulps of the
    largest logit (0.0234 at 3.67) at 4 layers, which no layer loop
    reproduces."""
    _check_prefill_and_decode("starcoder2-3b", dtype, t=11, seq_len=24,
                              scan_layers=False)


@pytest.mark.parametrize("arch", PREFIX_ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefix_and_encoder_models_match_reference(arch, dtype):
    """hymba-1.5b (4 meta tokens; windows of 8 that bind), whisper-base (a
    2-layer encoder over 16 seeded frames, cross-attention in every
    decoder layer) and internvl2-26b (8 seeded patch embeddings), reduced:
    repro.models.transformer.prefill, then decode_step at T + prefix
    (where the prefill left the caches, as the reference's
    tests/test_smoke_archs.py calls it): logits and caches (the SSM's conv
    and state, the cross K/V).  Against the reference unrolled
    (``scan_layers=False``), as starcoder2-3b is: in bf16 hymba and
    internvl then equal it bit for bit.  whisper's bf16 logits are held to
    :data:`ENCODER_BF16_TOL`."""
    tol = ENCODER_BF16_TOL if (arch, dtype) == ("whisper-base",
                                                "bfloat16") else None
    _check_prefill_and_decode(arch, dtype, t=11, seq_len=40,
                              logits_tol=tol, scan_layers=False)


@pytest.mark.parametrize("seeds", [(1, 9, 10), (0, 19, 20), (2, 29, 30),
                                   (3, 39, 40)])
def test_whisper_bf16_matches_reference_at_other_seeds(seeds):
    """whisper-base reduced in bf16, as in
    test_prefix_and_encoder_models_match_reference, at other draws of its
    parameters, tokens and frames: its logits stay within
    :data:`ENCODER_BF16_TOL` of the reference's."""
    _check_prefill_and_decode("whisper-base", "bfloat16", t=11, seq_len=40,
                              logits_tol=ENCODER_BF16_TOL, seeds=seeds,
                              scan_layers=False)


def test_hymba_bf16_drift_at_depth_is_the_references():
    """hymba-1.5b at its published 32 layers and window pattern (windows
    of 1024 cut to 8), the reduced config's width, a 32-token prompt: in
    fp32 the port's prefill logits are the reference's (relative L2 1e-4);
    in bf16 the reference's own logits are further from its fp32 ones
    than chip_smoke.py's logit tolerance, 5e-2, and the port's are as far
    from the port's fp32 ones, within a factor 1.5.  Rounding to bf16
    grows with hymba's depth in the reference as in the port, which is why
    chip_smoke.py holds hymba's bf16 prefill layer by layer."""
    full = get_config("hymba-1.5b")
    kw = dict(num_layers=full.num_layers, windows=tuple(
        min(w, 8) for w in full.windows), block_pattern=full.block_pattern)
    tokens = np.random.default_rng(9).integers(0, 256, (2, 32))
    got = {}
    for dtype in DTYPES:
        cj, ct, pj, pt = _models("hymba-1.5b", dtype, **kw)
        lj, _ = JT.prefill(pj, {"tokens": jnp.asarray(tokens, jnp.int32)},
                           cj, AxisRules(), 40)
        lt, _ = TT.prefill(TT.cast_params(pt, ct),
                           {"tokens": torch.from_numpy(tokens)}, ct, 40)
        got[dtype] = [_f32(lj)[..., :cj.vocab_size],
                      _f32(lt)[..., :cj.vocab_size]]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    (ref32, port32), (ref16, port16) = got["float32"], got["bfloat16"]
    drift = {"reference": rel(ref16, ref32), "port": rel(port16, port32)}
    print(f"hymba-1.5b, 32 layers, bf16 against fp32: {drift}; fp32 port "
          f"against reference: {rel(port32, ref32)}")
    assert rel(port32, ref32) <= 1e-4
    assert drift["reference"] > 5e-2
    assert 1 / 1.5 <= drift["port"] / drift["reference"] <= 1.5, drift


def test_prefill_past_the_cache_raises():
    """A prompt whose prefix and tokens are more positions than the cache
    holds raises, as the reference's pad of the caches does; the port's
    pad cropped them without a word."""
    _, ct, _, pt = _models("hymba-1.5b", "float32")
    tokens = {"tokens": torch.zeros((1, 6), dtype=torch.int64)}
    TT.prefill(pt, tokens, ct, 10)        # 4 meta tokens + 6 fill 10
    with pytest.raises(ValueError, match="positions"):
        TT.prefill(pt, tokens, ct, 9)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunkwise_prefill_and_decode_match_reference(dtype):
    """The same at T = 256, a multiple of the mLSTM chunk: prefill takes
    the chunkwise path (ops.mlstm_scan) on both sides, then two decode
    steps continue from its state."""
    _check_prefill_and_decode("xlstm-350m", dtype, t=256, seq_len=264)


def test_head_dim_256_prefill_and_decode_match_reference():
    """The reduced gemma3-1b at its published head dim, 256 (the reduced
    config's is 16): the D = 256 path of the attention kernels' plain
    version, with the local layers' window (8 reduced) passed by the
    decode steps at T = 11."""
    _check_prefill_and_decode("gemma3-1b", "float32", t=11, seq_len=24,
                              head_dim=256)


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


def test_cast_params_keeps_what_the_reference_cast_keeps():
    """repro.models.transformer._cast leaves A_log, D and dt_bias as they
    are; cast_params does the same wherever they sit in a layer."""
    cfg = get_config("lacin-demo").reduced()
    layer = {"ssm": {n: torch.ones(3) for n in ("A_log", "D", "dt_bias",
                                                "in_proj")}}
    params = {"embed": {"table": torch.ones(4, 2)}, "layers": [layer],
              "final_norm": {"scale": torch.ones(2)}}
    cast = TT.cast_params(params, cfg)["layers"][0]["ssm"]
    ref = JT._cast(jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()),
                                          layer), cfg.dtype)["ssm"]
    assert {n: str(a.dtype).removeprefix("torch.") for n, a in cast.items()} \
        == {n: str(a.dtype) for n, a in ref.items()} \
        == {"A_log": "float32", "D": "float32", "dt_bias": "float32",
            "in_proj": "bfloat16"}


@pytest.mark.parametrize("arch", ARCHS + PREFIX_ARCHS + SERVED_ARCHS)
def test_init_params_matches_reference_tree(arch):
    """repro.models.transformer.init_params: same leaves, shapes, dtypes and
    scales (the draws differ: torch.Generator vs jax.random), the
    encoder's, its norm and the meta tokens too; the SSM's A_log and D are
    float32 and equal."""
    cj, ct, pj, pt = _models(arch, "bfloat16")
    ours = TT.init_params(0, ct, device="cpu")
    assert set(ours) == set(pt)
    assert len(ours["layers"]) == len(pt["layers"]) == ct.num_layers
    assert len(ours.get("encoder", ())) == ct.encoder_layers
    flat_m = jax.tree_util.tree_leaves_with_path(ours)
    flat_c = jax.tree_util.tree_leaves_with_path(pt)
    assert [p for p, _ in flat_m] == [p for p, _ in flat_c]
    for (path, a), (_, b) in zip(flat_m, flat_c):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        if path[-1].key in ("A_log", "D"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1.2e-7)
        else:
            np.testing.assert_allclose(a.std().item(), b.std().item(),
                                       rtol=0.2, atol=1e-6)
    again = TT.init_params(0, ct, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(again["layers"]),
        jax.tree_util.tree_leaves(ours["layers"])))


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("lacin-demo").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_caches(cfg, 1, 8)


@pytest.mark.parametrize("part", ["encoder", "hymba", "meta_tokens",
                                  "patches"])
def test_parts_that_raised_now_serve(part):
    """The parts the port raised for before (an encoder, hymba blocks, meta
    tokens; and patch prefixes) on the reduced llama3.2-3b: init_params,
    prefill and a decode step at T + prefix run, give finite logits and the
    reference's cache leaves."""
    base = get_config("llama3.2-3b").reduced()
    cfg = {"encoder": dataclasses.replace(base, encoder_layers=2,
                                          encoder_seq_len=6),
           "hymba": dataclasses.replace(base, block_pattern=("attn", "hymba")
                                        * 2, ssm_state=4),
           "meta_tokens": dataclasses.replace(base, num_meta_tokens=2),
           "patches": dataclasses.replace(base, num_patch_tokens=3)}[part]
    params = TT.cast_params(TT.init_params(0, cfg, device="cpu"), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5))
    _, batch = _batch_pair(cfg, tokens)
    logits, caches = TT.prefill(params, batch, cfg, 16)
    pos = 5 + TT.prefix_len(cfg, batch)
    assert pos == 5 + {"meta_tokens": 2, "patches": 3}.get(part, 0)
    step, caches = TT.decode_step(params, logits.argmax(-1), caches, pos,
                                  cfg, 16)
    assert torch.isfinite(torch.cat([logits, step], 1)).all()
    want = {"k", "v", "conv", "state"} if part == "hymba" else {"k", "v"}
    assert set().union(*caches) == want
