"""The port's training path against the JAX reference, on the CPU:
``models.transformer.forward_train`` (loss, metrics, every gradient),
``runtime.trainer.make_train_step``, the train state across packages
(``models.convert``), and the crash-only loop ``runtime.loop``.

The same weights (the reference's ``init_params(PRNGKey(0))`` through
``params_from_numpy``) and the same numpy batches go through both, in
fp32; a VLM's batch carries seeded patch embeddings and an encoder-decoder's
seeded frames, each x 0.02, as tests/test_smoke_archs.py makes them.  Tolerances: the loss and every gradient leaf rtol 1e-4, atol 1e-5
(fp32 sums in other orders through a few layers).  Train steps: losses
rtol 1e-5, m and v rtol 1e-3 atol 1e-7 (sums of gradients), and the
parameters after 3 AdamW steps of lr 1e-3 within atol 1e-4, a tenth of
what one step can move an entry: AdamW moves an entry by lr * m / sqrt(v),
a ratio of gradients, and for the few entries whose gradient is near 0 the
two packages' rounding moves that ratio by percents (the largest
difference scales with lr); 99.9% of the entries are held to 1e-6.  Conversions are exact.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JData
from repro.models import get_config as jax_get_config
from repro.models import transformer as JT
from repro.models.layers import AxisRules as JRules
from repro.optim import OptConfig as JOpt
from repro.runtime import loop as JL
from repro.runtime import trainer as JTR

from repro_torch.data import DataConfig
from repro_torch.models import (get_config, numpy_from_params,
                                params_from_numpy, train_state_from_numpy,
                                train_state_to_numpy)
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.optim import OptConfig
from repro_torch.runtime import loop as TL
from repro_torch.runtime import trainer as TTR

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m", "lacin-demo", "xlstm-350m",
         "starcoder2-3b", "hymba-1.5b", "whisper-base", "internvl2-26b"]
#: The models with a prefix or an encoder.
PREFIXED = ["hymba-1.5b", "whisper-base", "internvl2-26b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small models run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them made these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _reference_params(arch, **kw):
    cj, _ = _configs(arch, **kw)
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), cj))


def _batch(vocab, b=2, t=24, seed=0, cfg=None):
    """Tokens and labels; with ``cfg``, also its patch embeddings and
    frames (seeded, x 0.02) where it takes them."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, t)).astype(np.int32)
    lab = rng.integers(0, vocab, (b, t)).astype(np.int32)
    lab[0, :3] = -100                                 # ignored labels
    out = {"tokens": tok, "labels": lab}
    if cfg is not None and cfg.num_patch_tokens:
        out["patch_embeds"] = (rng.normal(size=(
            b, cfg.num_patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg is not None and cfg.is_encdec:
        out["frames"] = (rng.normal(size=(
            b, cfg.encoder_seq_len, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _leaves_close(got, want, **tol):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@functools.lru_cache(maxsize=None)
def _reference_forward_train(arch, t=24, **kw):
    """(loss, metrics, grads) of jax.value_and_grad of the reference's
    forward_train on ``_batch`` of length ``t``, jitted once per config
    and length: a remat policy changes what is recomputed, not the value,
    so the port's three policies are held to the one reference."""
    cj, _ = _configs(arch, **kw)
    batch = {k: jnp.asarray(v) for k, v in _batch(cj.vocab_size, t=t,
                                                  cfg=cj).items()}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: JT.forward_train(p, b, cj, JRules()), has_aux=True))(
        _reference_params(arch, **kw), batch)
    return lj, mj, gj


def _check_forward_train(arch, remat, t=24, **kw):
    _, ct = _configs(arch, remat=remat, **kw)
    pn = _reference_params(arch, **kw)
    batch = _batch(ct.vocab_size, t=t, cfg=ct)
    lj, mj, gj = _reference_forward_train(arch, t, **kw)
    pt = params_from_numpy(pn, ct, device="cpu")
    lt, mt, gt = TTR.loss_and_grads(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()}, ct)
    np.testing.assert_allclose(float(lt), float(lj), **GRAD_TOL)
    assert set(mt) == set(mj) == {"ce_loss", "aux_loss", "tokens"}
    assert int(mt["tokens"]) == int(mj["tokens"]) == 2 * t - 3
    for k in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), **GRAD_TOL)
    if ct.is_moe:
        assert float(mt["aux_loss"]) > 0
    got = numpy_from_params(gt, ct)
    assert all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(got))
    _leaves_close(got, gj, **GRAD_TOL)


@pytest.mark.parametrize("arch,remat,t", [
    pytest.param(arch, remat, t, id=f"{arch}-{remat}" + (
        f"-t{t}" if t != 24 else "")) for arch, remat, t in [
        ("llama3.2-3b", "none", 24), ("llama3.2-3b", "full", 24),
        ("llama3.2-3b", "dots", 24), ("granite-moe-3b-a800m", "full", 24),
        ("granite-moe-3b-a800m", "dots", 24), ("gemma3-1b", "full", 24),
        ("starcoder2-3b", "full", 24), ("nemotron-4-15b", "full", 24),
        ("qwen3-moe-30b-a3b", "full", 24),
        ("hymba-1.5b", "none", 24), ("hymba-1.5b", "full", 24),
        ("hymba-1.5b", "none", 252), ("hymba-1.5b", "full", 252),
        ("whisper-base", "none", 24), ("whisper-base", "full", 24),
        ("internvl2-26b", "none", 24), ("internvl2-26b", "full", 24)]])
def test_forward_train_matches_reference(arch, remat, t):
    """Loss, metrics and every gradient against jax.value_and_grad of
    repro.models.transformer.forward_train, under each remat policy.
    hymba-1.5b (4 meta tokens) at 24 text tokens runs its SSM's flat scan
    over 28 positions, at 252 its chunked scan over 256; whisper-base
    trains its encoder over 16 frames through the cross-attention's K/V,
    internvl2-26b reads 8 patch embeddings; the loss skips the prefix."""
    _check_forward_train(arch, remat, t)


def test_meta_tokens_train_and_match_reference():
    """llama3.2-3b with two meta tokens in front of its text: the meta
    tokens' gradient and every other against the reference's."""
    _check_forward_train("llama3.2-3b", "full", num_meta_tokens=2)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("t", [32, 256])
def test_xlstm_forward_train_matches_reference(t, remat):
    """The reduced xlstm-350m (mLSTM, mLSTM, sLSTM, mLSTM): loss, metrics
    and every gradient against jax.value_and_grad of the reference's
    forward_train, at T = 32 (the mLSTM layers' sequential path under
    autograd) and T = 256 (one chunk: the scan's Function, whose backward
    recomputes the chunkwise scan), under each remat policy."""
    before = TX.backward_calls
    _check_forward_train("xlstm-350m", remat, t)
    mlstm = get_config("xlstm-350m").reduced().block_pattern.count("mlstm")
    assert TX.backward_calls - before == (mlstm if t == 256 else 0)


def _check_train_steps(arch, grad_accum, steps=3, t=24):
    cj, ct = _configs(arch)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JTR.make_train_step(cj, JRules(), JOpt(
        **dataclasses.asdict(opt)), grad_accum=grad_accum))
    tstep = TTR.make_train_step(ct, TTR.make_rules(None), opt,
                                grad_accum=grad_accum)
    pn = _reference_params(arch)
    jst = {"params": pn, "opt": jax.tree_util.tree_map(
        np.asarray, JTR.init_opt_state(pn)), "step": np.int32(0)}
    tst = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), ct,
                                 device="cpu")
    for i in range(steps):
        batch = _batch(cj.vocab_size, b=4, t=t, seed=i, cfg=cj)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tm = tstep(tst, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(tst["step"]) == int(tst["opt"]["step"]) == steps
    got = train_state_to_numpy(tst, ct)
    _leaves_close(got["params"], jst["params"], rtol=0, atol=1e-4)
    diff = np.concatenate([np.abs(a - np.asarray(b)).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(got["params"]),
        jax.tree_util.tree_leaves(jst["params"]))])
    assert np.mean(diff > 1e-6) < 1e-3, np.mean(diff > 1e-6)
    _leaves_close(got["opt"], jst["opt"], rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("arch,grad_accum", [
    ("llama3.2-3b", 1), ("llama3.2-3b", 2), ("granite-moe-3b-a800m", 1),
    ("nemotron-4-15b", 1), ("whisper-base", 2)])
def test_make_train_step_matches_reference(arch, grad_accum):
    """3 steps of make_train_step against the reference's on the same
    weights and batches: losses, then every parameter, m and v."""
    _check_train_steps(arch, grad_accum)


#: Where a step's gradient entry is below this fraction of its leaf's
#: largest, the two packages' fp32 gradients (which agree to about 1e-5 of
#: the leaf's largest) differ by a large part of the entry itself, and
#: AdamW's normalised step lr * m_hat / (sqrt(v_hat) + eps) is a ratio of
#: that rounding: such entries are held only to what a step can move them.
SMALL_GRAD = 1e-4


def test_xlstm_train_steps_match_reference():
    """Two steps of make_train_step on the reduced xlstm-350m at T = 256 (the
    scan's Function in every mLSTM layer) against the reference's.

    Chained (each package steps its own state): the losses, rtol 1e-5.
    Each step from one state (the reference's, crossed by
    train_state_from_numpy, which is exact): m and v rtol 1e-3 atol 1e-7;
    the parameters within 1e-4 (a tenth of lr) wherever the step's
    gradient is at least SMALL_GRAD of its leaf's largest, and within 2 lr
    elsewhere.  Chained parameters are not compared: AdamW's second step
    divides sums of two gradients that nearly cancel in a few percent of
    the entries, and there it turns the first step's rounding (1e-5 of a
    leaf) into differences of up to 1.6 lr while the loss agrees to 1e-7."""
    cj, ct = _configs("xlstm-350m")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JTR.make_train_step(cj, JRules(), JOpt(
        **dataclasses.asdict(opt))))
    tstep = TTR.make_train_step(ct, TTR.make_rules(None), opt)
    pn = _reference_params("xlstm-350m")
    jst = {"params": pn, "opt": jax.tree_util.tree_map(
        np.asarray, JTR.init_opt_state(pn)), "step": np.int32(0)}
    chained = train_state_from_numpy(jst, ct, device="cpu")
    for i in range(2):
        batch = _batch(cj.vocab_size, t=256, seed=i)
        from_ref = train_state_from_numpy(jst, ct, device="cpu")
        jnext, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        jnext = jax.tree_util.tree_map(np.asarray, jnext)
        chained, cm = tstep(chained, batch)
        np.testing.assert_allclose(float(cm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        got = train_state_to_numpy(tstep(from_ref, batch)[0], ct)
        _leaves_close(got["opt"], jnext["opt"], rtol=1e-3, atol=1e-7)
        # the step's (clipped) gradient, from the reference's m
        m0, m1 = (jax.tree_util.tree_leaves(st["opt"]["m"])
                  for st in (jst, jnext))
        for a, b, m_in, m_out in zip(
                jax.tree_util.tree_leaves(got["params"]),
                jax.tree_util.tree_leaves(jnext["params"]), m0, m1):
            g = np.abs(m_out - opt.beta1 * m_in) / (1 - opt.beta1)
            tol = np.where(g >= SMALL_GRAD * g.max(), 1e-4, 2 * opt.lr)
            assert (np.abs(a - b) <= tol).all(), np.abs(a - b).max()
        jst = jnext


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_round_trip_is_exact(arch):
    """reference -> port -> reference, parameters and AdamW state (random
    m and v), leaf for leaf, dtype and shape."""
    cj, ct = _configs(arch)
    pn = _reference_params(arch)
    rng = np.random.default_rng(1)
    noise = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.normal(size=a.shape).astype(np.float32), pn)
    state = {"params": pn, "opt": {"m": noise(), "v": noise(),
                                   "step": np.asarray(5, np.int32)},
             "step": np.asarray(5, np.int32)}
    ported = train_state_from_numpy(state, ct, device="cpu")
    assert len(ported["params"]["layers"]) == ct.num_layers
    back = train_state_to_numpy(ported, ct)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    stack0 = numpy_from_params(ported["params"], ct)["stack"][0]
    for a, b in zip(jax.tree_util.tree_leaves(stack0),
                    jax.tree_util.tree_leaves(pn["stack"][0])):
        assert np.array_equal(a, b)


def test_untrainable_configs_raise():
    """What cannot train raises: an encoder-decoder's batch without its
    frames, an unknown remat policy, a batch entry no model reads; a step
    on a mesh, with ``grad_specs``, builds (it is held on gloo ranks in
    tests/test_torch_sharding.py)."""
    base = get_config("llama3.2-3b").reduced()
    _, whisper = _configs("whisper-base")
    params = TT.init_params(0, whisper, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(whisper.vocab_size, cfg=whisper).items()}
    with pytest.raises(ValueError, match="frames"):
        TT.forward_train(params, {k: batch[k] for k in ("tokens", "labels")},
                         whisper)
    with pytest.raises(ValueError, match="remat"):
        TT.forward_train(params, batch,
                         dataclasses.replace(whisper, remat="some"))
    with pytest.raises(ValueError, match="unknown batch entries"):
        TT.forward_train(params, dict(batch, pixels=batch["frames"]),
                         whisper)

    class OneRankMesh:
        """A (1, 1) mesh's names, sizes and this rank's coordinate."""
        mesh_dim_names, ndim = ("data", "model"), 2

        def size(self, i=None):
            return 1

        def get_coordinate(self):
            return [0, 0]
    rules = TTR.make_rules(OneRankMesh())
    assert rules.dp == ("data",) and rules.tp == "model"
    assert callable(TTR.make_train_step(base, rules, OptConfig(),
                                        grad_specs={}))


@pytest.mark.parametrize("arch", PREFIXED)
def test_init_train_state_builds_prefixed_models(arch):
    """init_train_state builds hymba-1.5b, whisper-base and internvl2-26b:
    their meta tokens, encoder and SSM leaves among the parameters, m and
    v zeros of the parameters' shapes, and a step of the train step runs
    on it with a finite loss."""
    _, ct = _configs(arch)
    state = TTR.init_train_state(0, ct, device="cpu")
    params = state["params"]
    assert ("meta_tokens" in params) == bool(ct.num_meta_tokens)
    assert ("encoder" in params) == ct.is_encdec == ("enc_norm" in params)
    if arch == "hymba-1.5b":
        assert params["layers"][0]["ssm"]["A_log"].dtype == torch.float32
    leaves = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=torch.is_tensor)
    assert [a.shape for a in leaves(state["opt"]["m"])] == \
        [a.shape for a in leaves(params)]
    assert not any(a.any() for a in leaves(state["opt"]["v"]))
    step = TTR.make_train_step(ct, TTR.make_rules(None), OptConfig())
    state, m = step(state, _batch(ct.vocab_size, t=8, cfg=ct))
    assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1


def test_decode_with_a_cross_source_matches_reference():
    """whisper-base's decode_fn with ``cross_src`` (the encoder's output)
    on caches whose cross-attention layers hold no ``ck``/``cv``: the
    logits and every cache equal the reference's decode_step with the same
    source on the same caches, and the returned caches hold the cross K/V
    prefill would have left."""
    cj, ct = _configs("whisper-base")
    pn = _reference_params("whisper-base")
    batch = _batch(ct.vocab_size, t=8, cfg=ct)
    pt = TT.cast_params(params_from_numpy(pn, ct, device="cpu"), ct)
    prefill_fn, decode_fn = TTR.make_serve_steps(ct, TTR.make_rules(None), 16)
    inputs = {"tokens": torch.from_numpy(batch["tokens"]),
              "frames": torch.from_numpy(batch["frames"])}
    logits, caches = prefill_fn(pt, inputs)
    src = TT.encode_frames(pt, inputs["frames"], ct)
    tok = logits.argmax(-1)
    bare = [{k: v.clone() for k, v in c.items() if k not in ("ck", "cv")}
            for c in caches]
    got, got_caches = decode_fn(pt, tok, bare, 8, cross_src=src)
    want_read, _ = decode_fn(pt, tok, [{k: v.clone() for k, v in c.items()}
                                       for c in caches], 8)
    np.testing.assert_allclose(got.numpy(), want_read.numpy(), rtol=0,
                               atol=1e-5)
    jprefill = jax.jit(lambda p, b: JT.prefill(p, b, cj, JRules(), 16))
    _, jcaches = jprefill(pn, {k: jnp.asarray(v) for k, v in batch.items()
                               if k != "labels"})
    jsrc = JT.encode_frames(pn, jnp.asarray(batch["frames"]), cj, JRules())
    jbare = [{k: v for k, v in c.items() if k not in ("ck", "cv")}
             for c in jcaches]
    jlogits, jnew = JT.decode_step(pn, jnp.asarray(tok.numpy()), jbare,
                                   jnp.int32(8), cj, JRules(), 16,
                                   cross_src=jsrc)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    i = 0
    for run, run_want in zip(TT.build_runs(ct), jnew):
        group = got_caches[i:i + run.count]
        i += run.count
        assert set(group[0]) == set(run_want) >= {"ck", "cv"}
        for k, want in run_want.items():
            np.testing.assert_allclose(
                torch.stack([c[k] for c in group]).float().numpy(),
                np.asarray(want, np.float32), rtol=0, atol=1e-5, err_msg=k)


def test_train_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTR.init_train_state(0, get_config("lacin-demo").reduced())


@pytest.mark.parametrize("arch,batch,seq", [("llama3.2-3b", 256, 4096),
                                            ("granite-moe-3b-a800m", 64,
                                             4096), ("lacin-demo", 8, 1024)])
def test_suggest_grad_accum_matches_reference(arch, batch, seq):
    for dp in (1, 8):
        assert TTR.suggest_grad_accum(get_config(arch), batch, seq, dp) == \
            JTR.suggest_grad_accum(jax_get_config(arch), batch, seq, dp)


def test_serve_steps_are_prefill_and_decode():
    _, ct = _configs("lacin-demo")
    params = TT.cast_params(TT.init_params(0, ct, device="cpu"), ct)
    prefill_fn, decode_fn = TTR.make_serve_steps(ct, TTR.make_rules(None), 16)
    tokens = torch.from_numpy(_batch(ct.vocab_size, t=8)["tokens"])
    logits, caches = prefill_fn(params, {"tokens": tokens})
    want, _ = TT.prefill(params, {"tokens": tokens}, ct, 16)
    assert torch.equal(logits, want)
    step, _ = decode_fn(params, logits.argmax(-1), caches, 8)
    assert step.shape == (2, 1, ct.vocab_padded)


# -- the crash-only loop ------------------------------------------------------

def _loop_setup(tmp_path, name, **kw):
    _, ct = _configs("lacin-demo")
    data = DataConfig(vocab_size=ct.vocab_size, seq_len=16, global_batch=4)
    loop = TL.LoopConfig(ckpt_dir=str(tmp_path / name), log_every=1, **kw)
    return ct, data, loop


def test_injected_failures_give_the_uninterrupted_losses(tmp_path):
    """Two injected crashes: the run restarts from the checkpoints of
    steps 4 and 8 and logs the same losses, bit for bit, as a run without
    failures (the data is a function of the step)."""
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    ct, data, loop = _loop_setup(tmp_path, "fail", total_steps=12,
                                 ckpt_every=4, fail_at_steps=(6, 9))
    report = TL.run_training(ct, opt, loop, data, device="cpu")
    ct, data, clean = _loop_setup(tmp_path, "clean", total_steps=12,
                                  ckpt_every=4)
    base = TL.run_training(ct, opt, clean, data, device="cpu")
    assert report.restarts == 2 and report.restored_from == [4, 8]
    assert base.restarts == 0 and base.steps_run == 12
    assert report.steps_run == 12 + 2 + 1      # steps 4-5 and 8 run twice
    steps = dict(report.losses)
    assert sorted(steps) == list(range(12))
    assert all(steps[s] == loss for s, loss in base.losses)
    assert TL.CheckpointManager(clean.ckpt_dir).steps() == [4, 8, 12]


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A reference run of 4 steps, its checkpoint directory cut back to
    step 2: the port resumes from step 2 and logs steps 2-3 within rtol
    1e-4 of the reference's."""
    cj, _ = _configs("lacin-demo")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    jdata = JData(vocab_size=cj.vocab_size, seq_len=16, global_batch=4)
    jloop = JL.LoopConfig(total_steps=4, ckpt_every=2, log_every=1,
                          ckpt_dir=str(tmp_path / "ref"))
    ref = JL.run_training(cj, JOpt(**opt), jloop, jdata)
    shutil.rmtree(tmp_path / "ref" / "step_00000004")
    ct, data, loop = _loop_setup(tmp_path, "ref", total_steps=4,
                                 ckpt_every=2)
    report = TL.run_training(ct, OptConfig(**opt), loop, data, device="cpu")
    assert report.restored_from == [2] and report.steps_run == 2
    want = dict(ref.losses)
    for step, loss in report.losses:
        np.testing.assert_allclose(loss, want[step], rtol=1e-4)
    assert [s for s, _ in report.losses] == [2, 3]
