"""repro_torch.serving.ServingEngine against the JAX reference
repro.serving.engine.ServingEngine, on the CPU.

Both engines serve the reduced llama3.2-3b, xlstm-350m, nemotron-4-15b and
qwen3-moe-30b-a3b, in a float32 config with the same weights (the reference's
``init_params(PRNGKey(0))`` through ``params_from_numpy``).  Prompts of
unequal length exercise the left-pad path; greedy tokens must be equal, and
for the xLSTM the sampled ones too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine

from repro_torch.models import get_config, init_params, params_from_numpy
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These small models run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them made such tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(cls, vocab, lengths, temperatures, max_new):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n, dtype=np.int32),
                max_new_tokens=max_new, temperature=temp)
            for i, (n, temp) in enumerate(zip(lengths, temperatures))]


def test_greedy_tokens_equal_reference_engine():
    """Greedy out_tokens equal repro.serving.engine.ServingEngine's; a
    sampled request returns max_new_tokens valid ids."""
    cj = dataclasses.replace(jax_get_config("llama3.2-3b").reduced(),
                             dtype="float32")
    ct = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                             dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    lengths, temps, max_new = [5, 9, 3, 7], [0.0, 0.0, 0.0, 0.8], 6
    outs = []
    for eng, cls in ((JServingEngine(cj, pj, slots=4, max_seq=32), JRequest),
                     (ServingEngine(ct, pt, slots=4, max_seq=32, device="cpu"),
                      Request)):
        reqs = _requests(cls, cj.vocab_size, lengths, temps, max_new)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == len(reqs)
        assert eng.pos == max(lengths) + max_new
        outs.append({r.rid: r.out_tokens for r in done})
    want, got = outs
    for rid in (0, 1, 2):
        assert got[rid] == want[rid]
    assert len(got[3]) == max_new
    assert all(0 <= t < cj.vocab_size for t in got[3])


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "qwen3-moe-30b-a3b"])
def test_served_archs_tokens_equal_reference_engine(arch):
    """nemotron-4-15b and qwen3-moe-30b-a3b reduced, in float32: greedy
    out_tokens equal repro.serving.engine.ServingEngine's, the sampled
    request valid ids."""
    cj = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    ct = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    lengths, temps, max_new = [5, 9, 3, 7], [0.0, 0.0, 0.0, 0.8], 6
    outs = []
    for eng, cls in ((JServingEngine(cj, pj, slots=4, max_seq=32), JRequest),
                     (ServingEngine(ct, pt, slots=4, max_seq=32, device="cpu"),
                      Request)):
        reqs = _requests(cls, cj.vocab_size, lengths, temps, max_new)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == len(reqs)
        outs.append({r.rid: r.out_tokens for r in done})
    want, got = outs
    for rid in (0, 1, 2):
        assert got[rid] == want[rid]
    assert len(got[3]) == max_new
    assert all(0 <= t < cj.vocab_size for t in got[3])


def test_xlstm_tokens_equal_reference_engine():
    """Greedy and temperature out_tokens of the reduced xlstm-350m equal
    repro.serving.engine.ServingEngine's: both engines draw from a numpy
    Generator of the same seed, so equal logits give equal samples.  The
    longest prompt is 256 tokens, a multiple of the mLSTM chunk, so the
    prefill takes ops.mlstm_scan; decode takes the sequential step.  With
    no attention layer, max_seq only bounds the fill position."""
    cj = dataclasses.replace(jax_get_config("xlstm-350m").reduced(),
                             dtype="float32")
    ct = dataclasses.replace(get_config("xlstm-350m").reduced(),
                             dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    lengths, temps, max_new = [256, 200, 97, 31], [0.0, 0.8, 0.0, 0.8], 6
    outs = []
    for eng, cls in ((JServingEngine(cj, pj, slots=4, max_seq=272), JRequest),
                     (ServingEngine(ct, pt, slots=4, max_seq=272,
                                    device="cpu"), Request)):
        reqs = _requests(cls, cj.vocab_size, lengths, temps, max_new)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        assert len(done) == len(reqs)
        assert eng.pos == max(lengths) + max_new
        outs.append({r.rid: r.out_tokens for r in done})
    want, got = outs
    assert got == want
    assert all(len(toks) == max_new and all(0 <= t < cj.vocab_size
                                            for t in toks)
               for toks in got.values())


def test_stop_rule_at_the_end_of_the_cache():
    """Requests retire once the fill position reaches max_seq - 1."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32")
    eng = ServingEngine(cfg, init_params(0, cfg, device="cpu"), slots=2,
                        max_seq=12, device="cpu")
    for r in _requests(Request, cfg.vocab_size, [8, 4], [0.0, 0.0], 50):
        eng.submit(r)
    done = eng.run()
    assert len(done) == 2 and eng.pos == 11
    assert all(len(r.out_tokens) == 3 for r in done)


def test_serving_engine_completes_requests():
    """Twin of tests/test_substrates.py::test_serving_engine_completes_requests
    (lacin-demo, reduced)."""
    cfg = get_config("lacin-demo").reduced()
    params = init_params(0, cfg, device="cpu")
    eng = ServingEngine(cfg, params, slots=2, max_seq=48, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8,
                                               dtype=np.int32),
                    max_new_tokens=5) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 2
    for r in done:
        assert len(r.out_tokens) == 5
        assert all(0 <= t < cfg.vocab_padded for t in r.out_tokens)


def test_engine_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("lacin-demo").reduced()
    params = init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)


def test_oversubscribed_run_returns_what_reference_returns():
    """More requests than slots: each run() of the port returns the requests
    that repro.serving.engine.ServingEngine.run returns, with the same
    greedy tokens, and the queued one waits for the next run.  The
    reference steps its empty slot until max_steps, past the cache, where
    its cache write clamps; the port stops once every slot is empty."""
    cj = dataclasses.replace(jax_get_config("llama3.2-3b").reduced(),
                             dtype="float32")
    ct = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                             dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    runs, clocks = [], []
    for eng, cls in ((JServingEngine(cj, pj, slots=1, max_seq=12), JRequest),
                     (ServingEngine(ct, pt, slots=1, max_seq=12, device="cpu"),
                      Request)):
        for r in _requests(cls, cj.vocab_size, [4, 6], [0.0, 0.0], 3):
            eng.submit(r)
        runs.append([{r.rid: r.out_tokens for r in eng.run(max_steps=20)}
                     for _ in range(2)])
        late = cls(rid=2, prompt=np.array([1], np.int32))
        eng.submit(late)
        clocks.append((eng.steps_total, late.arrived))
    want, got = runs
    # the arrival clock advances as the reference's: 20 steps in the run
    # that left a request queued, 3 in the one that did not
    assert clocks[1] == clocks[0] == (23, 23)
    assert got == want
    assert [sorted(r) for r in got] == [[0], [1]]
    assert all(len(toks) == 3 for r in got for toks in r.values())


def test_serving_engine_arrival_trace():
    """Port of tests/test_workload.py::test_serving_engine_arrival_trace:
    submitted requests record their decode-step arrival and export a
    replayable trace-kind ArrivalSpec, whose arrays equal the
    reference's."""
    from repro.models import ModelConfig as JModelConfig
    from repro_torch.models import ModelConfig
    kw = dict(name="t", family="dense", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=32)
    cfg = ModelConfig(**kw)
    traces = []
    for eng, cls in ((JServingEngine(JModelConfig(**kw), None, slots=2,
                                     max_seq=16), JRequest),
                     (ServingEngine(cfg, init_params(0, cfg, device="cpu"),
                                    slots=2, max_seq=16, device="cpu"),
                      Request)):
        eng.submit(cls(0, np.array([1, 2], np.int32)), at=3)
        eng.submit(cls(1, np.array([1], np.int32)))        # clock is 0
        traces.append(eng.arrival_trace())
    want, got = traces
    assert got.kind == "trace" and got.times == (0, 3)
    assert got.to_dict() == want.to_dict()
    for n, horizon, seed in ((4, 8, 0), (16, 40, 3)):
        for a, b in zip(got.arrivals(n=n, horizon=horizon, seed=seed),
                        want.arrivals(n=n, horizon=horizon, seed=seed)):
            np.testing.assert_array_equal(a, b)
    src, gen = got.arrivals(n=4, horizon=8, seed=0)
    assert gen.size == 2 and src.size == 2
    with pytest.raises(ValueError, match="submit"):
        ServingEngine(cfg, init_params(0, cfg, device="cpu"), slots=2,
                      max_seq=16, device="cpu").arrival_trace()


def _reduced_pair(arch):
    cj = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    ct = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    pj = jax_init_params(jax.random.PRNGKey(0), cj)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), ct,
                           device="cpu")
    return cj, ct, pj, pt


def _reference_greedy(pj, cj, batch, start, steps, seq_len):
    """Greedy tokens of the reference's prefill, then decode_step at
    ``start``, ``start + 1``, ...: what an engine decoding from ``start``
    returns."""
    import jax.numpy as jnp
    from repro.models.layers import AxisRules
    from repro.models.transformer import decode_step, prefill
    logits, caches = prefill(pj, batch, cj, AxisRules(), seq_len)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = []
    for i in range(steps):
        logits, caches = decode_step(pj, tok, caches,
                                     jnp.asarray(start + i, jnp.int32), cj,
                                     AxisRules(), seq_len)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(int(tok[0, 0]))
    return out


def test_hymba_engine_decodes_after_the_meta_tokens():
    """The reduced hymba-1.5b (4 meta tokens), one prompt of 8: the port's
    engine decodes from 8 + 4, where the reference's prefill left the
    caches, and gives the tokens of the reference's prefill followed by
    decode_step at T + prefix (the positions tests/test_smoke_archs.py
    decodes at).  The reference's engine decodes from T = 8 (ROADMAP C19):
    its tokens are those of decode_step at T, and differ."""
    import jax.numpy as jnp
    cj, ct, pj, pt = _reduced_pair("hymba-1.5b")
    prompt = np.random.default_rng(1).integers(0, cj.vocab_size, 8,
                                                dtype=np.int32)
    batch = {"tokens": jnp.asarray(prompt[None])}
    new, seq = 4, 32
    want = _reference_greedy(pj, cj, batch, 8 + 4, new, seq)
    at_t = _reference_greedy(pj, cj, batch, 8, new, seq)
    outs = []
    for eng, cls in ((JServingEngine(cj, pj, slots=1, max_seq=seq), JRequest),
                     (ServingEngine(ct, pt, slots=1, max_seq=seq,
                                    device="cpu"), Request)):
        eng.submit(cls(rid=0, prompt=prompt, max_new_tokens=new))
        [done] = eng.run()
        outs.append((done.out_tokens, eng.pos))
    (ref_tokens, ref_pos), (got, pos) = outs
    assert (got, pos) == (want, 8 + 4 + new)
    assert (ref_tokens, ref_pos) == (at_t, 8 + new)
    assert got != ref_tokens


def test_engine_stops_with_the_prefix_in_the_cache():
    """The stop rule counts the meta tokens: a request retires once the
    fill position, prefix included, reaches max_seq - 1."""
    _, ct, _, pt = _reduced_pair("hymba-1.5b")
    eng = ServingEngine(ct, pt, slots=1, max_seq=16, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                       max_new_tokens=50))
    [done] = eng.run()
    assert eng.pos == 15 and len(done.out_tokens) == 15 - (8 + 4)


def test_whisper_engine_tokens_equal_reference_engine():
    """The reduced whisper-base (encoder over zero frames, as both engines
    pass them; cross-attention in every decoder layer): greedy tokens of
    unequal prompts equal the reference's engine's, and the reference's
    prefill and decode_step at T (no prefix)."""
    import jax.numpy as jnp
    cj, ct, pj, pt = _reduced_pair("whisper-base")
    lengths, temps, new = [6, 9], [0.0, 0.0], 5
    outs = []
    for eng, cls in ((JServingEngine(cj, pj, slots=2, max_seq=24), JRequest),
                     (ServingEngine(ct, pt, slots=2, max_seq=24,
                                    device="cpu"), Request)):
        reqs = _requests(cls, cj.vocab_size, lengths, temps, new)
        for r in reqs:
            eng.submit(r)
        outs.append({r.rid: r.out_tokens for r in eng.run()})
        assert eng.pos == 9 + new
    want, got = outs
    assert got == want
    prompt = _requests(Request, cj.vocab_size, lengths, temps, new)[1].prompt
    frames = jnp.zeros((1, cj.encoder_seq_len, cj.d_model), jnp.float32)
    assert got[1] == _reference_greedy(
        pj, cj, {"tokens": jnp.asarray(prompt[None]), "frames": frames}, 9,
        new, 24)
