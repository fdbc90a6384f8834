#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  -- the card, its power limit (nvidia-smi) and the software;
2. build   -- compiles every CUDA source under src/repro_torch/kernels/csrc;
3. kernels -- holds each kernel against its plain PyTorch version on the
   hazard cases (fp32 tol 2e-5, bf16 tol 2e-2) and at the serving shapes,
   and times kernel, plain version and the library call beside its bound;
4. serve   -- llama3.2-3b at full width and depth, random weights from a
   seed, through ServingEngine: 4 requests (prompts 512/384/256/128, one
   sampled at temperature 0.8) x 32 new tokens, with the kernel launch
   counts of that run; the prefill logits against the same model with
   attention swapped for the plain version; the reduced model on the card
   against the CPU; prefill ms, decode tokens/s and peak memory;
5. profile -- device time by kernel over prefills and decode steps
   (torch.profiler), and the share of the time the device is idle.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that last line; so does a machine without CUDA.  Imports only torch,
numpy and repro_torch.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import reference_attention  # noqa: E402
from repro_torch.models import get_config, init_params  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor cores
              torch.float32: 67e12}        # fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# name: (b, t, s, h, kvh, d, q_pos, causal, window); q_pos None = arange(t),
# "tail" = the last t of s positions.
HAZARDS = {
    "gqa3_d128_odd_t_s": (2, 131, 131, 6, 2, 128, None, True, 0),
    "gqa3_d16_odd_tail": (2, 37, 101, 6, 2, 16, "tail", True, 0),
    "gqa2_d32": (2, 100, 100, 4, 2, 32, None, True, 0),
    "mqa_d64_tail": (1, 200, 333, 4, 1, 64, "tail", True, 0),
    "window7_d64": (2, 150, 150, 6, 2, 64, None, True, 7),
    "window64_d128": (2, 150, 150, 6, 2, 128, None, True, 64),
    "noncausal_d128": (1, 70, 190, 6, 2, 128, None, False, 0),
    "noncausal_window": (1, 70, 190, 3, 1, 64, "tail", False, 33),
    "decode_t1_s1024": (4, 1, 1024, 24, 8, 128, [700], True, 0),
    "decode_window": (4, 1, 1024, 24, 8, 128, [700], True, 100),
    "fully_masked_rows": (1, 16, 40, 6, 2, 128, [-5] * 16, True, 0),
    "some_rows_masked": (2, 80, 80, 6, 2, 64, list(range(-40, 40)), True, 0),
}

# The serving run: 4 slots, prompts left-padded to 512, a 1024-slot cache.
PROMPTS = (512, 384, 256, 128)
MAX_SEQ, NEW_TOKENS = 1024, 32
DECODE_POS = 527                           # a fill position the run decodes at


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(b, t, s, h, kvh, d, q_pos, dtype, seed, copies=1):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device="cuda", dtype=dtype)
    q = draw(b, t, h, d)
    kvs = [(draw(b, s, kvh, d), draw(b, s, kvh, d)) for _ in range(copies)]
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    if q_pos is None:
        q_pos = list(range(t))
    return q, kvs, torch.tensor(q_pos, dtype=torch.int32, device="cuda")


def visible(q_pos, kv_pos, causal, window):
    ok = (kv_pos[None, :] >= 0).expand(len(q_pos), -1)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    return ok


def bound(q, k, q_pos, kv_pos, causal, window):
    """Least time the card could take: each input byte the data needs read
    once (K/V rows some query sees), the output written once, and the
    multiply-adds of the visible (query, key) pairs at the type's peak."""
    ok = visible(q_pos, kv_pos, causal, window)
    b, _, h, d = q.shape
    kvh = k.shape[2]
    rows = int(ok.any(dim=0).sum())
    pairs = int(ok.sum())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * b * rows * kvh * d * k.element_size()
              + 4 * (q_pos.numel() + kv_pos.numel()))
    flops = 4 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, dtype):
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    worst = float((err - tol * want.float().abs()).max())
    if not worst <= tol:
        raise AssertionError(f"{name} {dtype}: kernel and plain version differ "
                             f"by up to {float(err.max())} (atol = rtol = {tol})")
    return float(err.max())


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


def phase_build():
    t0 = time.perf_counter()
    reports = _build.build_all()
    fa._library()
    ptxas = [line.strip() for text in reports.values()
             for line in text.splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(reports),
         ptxas=ptxas)


def phase_hazards():
    worst = {}
    for name, (b, t, s, h, kvh, d, q_pos, causal, window) in HAZARDS.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, [(k, v)], qp = make_inputs(b, t, s, h, kvh, d, q_pos, dtype,
                                          seed=sum(map(ord, name)))
            kw = dict(q_pos=qp, causal=causal, window=window)
            before = fa.launches
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.launches != before + 1:
                raise AssertionError("the wrapper did not count its launch")
            err = check_close(name, got, reference_attention(q, k, v, **kw),
                              dtype)
            if name == "fully_masked_rows" and got.any():
                raise AssertionError("fully masked rows are not zeros")
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst.get(key, 0.0), err)
            emit("kernel_case", kernel="flash_attention", case=name,
                 dtype=key, max_abs_err=err, tol=TOL[dtype])
    emit("kernel_hazards", kernel="flash_attention", cases=len(HAZARDS) * 2,
         max_abs_err=worst)


def time_attention(label, b, t, s, h, kvh, d, q_pos, copies):
    """Kernel, plain version and SDPA at one serving shape (bf16).  With
    ``copies`` > 1 the calls cycle over that many K/V caches, so that they
    find the cache in device memory and not in the 50 MB L2, as each layer
    of a decode step does."""
    dtype = torch.bfloat16
    q, kvs, qp = make_inputs(b, t, s, h, kvh, d, q_pos, dtype, seed=t + s,
                             copies=copies)
    kp = torch.arange(s, dtype=torch.int32, device="cuda")
    k, v = kvs[0]
    kw = dict(q_pos=qp, kv_pos=kp, causal=True, window=0)
    err = check_close(label, fa.flash_attention(q, k, v, **kw),
                      reference_attention(q, k, v, **kw), dtype)
    mask = visible(qp, kp, True, 0)
    turn = [0]

    def cycle(fn):
        def call():
            k_, v_ = kvs[turn[0] % copies]
            turn[0] += 1
            return fn(q, k_, v_)
        return call

    def sdpa(q_, k_, v_):
        sdpa_kw = dict(is_causal=True) if t == s else dict(attn_mask=mask)
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            enable_gqa=True, **sdpa_kw)

    iters = 50
    ms = cuda_ms(cycle(lambda *a: fa.flash_attention(*a, **kw)), iters)
    plain_ms = cuda_ms(cycle(lambda *a: reference_attention(*a, **kw)), iters)
    library_ms = cuda_ms(cycle(sdpa), iters)
    ms_again = cuda_ms(cycle(lambda *a: fa.flash_attention(*a, **kw)), iters)
    bound_ms, bound_by = bound(q, k, qp, kp, True, 0)
    out = dict(shape=f"B{b} T{t} S{s} H{h} KV{kvh} D{d} bf16 causal",
               max_abs_err=err, tol=TOL[dtype], ms=ms, ms_repeat=ms_again,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    emit("kernel_timing", kernel="flash_attention", case=label, **out)
    return out


def phase_serve():
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device="cuda")
    eng = ServingEngine(cfg, params, slots=len(PROMPTS), max_seq=MAX_SEQ,
                        seed=SEED, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n,
                                                dtype=np.int32),
                    max_new_tokens=NEW_TOKENS,
                    temperature=0.8 if i == 1 else 0.0)
            for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = cfg.num_layers * (1 + NEW_TOKENS)
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, not {want}")
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out_tokens) != NEW_TOKENS or not all(
                0 <= tok < cfg.vocab_size for tok in r.out_tokens):
            raise AssertionError(f"request {r.rid}: bad tokens {r.out_tokens}")

    # The same prefill with attention through the plain version instead.
    toks = np.zeros((len(PROMPTS), max(PROMPTS)), np.int64)
    for i, r in enumerate(reqs):
        toks[i, -len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    logits, caches = TT.prefill(eng.params, batch, cfg, MAX_SEQ)
    kernel_fn = ops.flash_attention
    ops.flash_attention = reference_attention
    try:
        plain_logits, _ = TT.prefill(eng.params, batch, cfg, MAX_SEQ)
    finally:
        ops.flash_attention = kernel_fn
    a, b = logits.float(), plain_logits.float()
    if not torch.isfinite(a).all():
        raise AssertionError("prefill logits are not finite")
    rel = float((a - b).norm() / b.norm())
    same_argmax = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    logits_tol = 5e-2
    if not rel <= logits_tol:
        raise AssertionError(f"prefill logits with the kernel and with the "
                             f"plain version differ: relative L2 {rel}")

    prefill_ms = cuda_ms(lambda: TT.prefill(eng.params, batch, cfg, MAX_SEQ),
                         iters=5, warmup=1)
    nxt = logits.argmax(-1)
    step_ms = cuda_ms(lambda: TT.decode_step(eng.params, nxt, caches,
                                             DECODE_POS, cfg, MAX_SEQ),
                      iters=20)
    emit("serve", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads, vocab=cfg.vocab_size,
         dtype=cfg.dtype, slots=len(PROMPTS), prompts=list(PROMPTS),
         new_tokens=NEW_TOKENS, max_seq=MAX_SEQ, init_s=init_s,
         run_s=run_s, generated_tokens=sum(len(r.out_tokens) for r in done),
         launches=launches, launches_expected=want,
         prefill_logits_rel_l2_vs_plain=rel, logits_tol_rel_l2=logits_tol,
         prefill_logits_max_abs_diff=float((a - b).abs().max()),
         prefill_logits_max_abs=float(b.abs().max()),
         prefill_argmax_agreement=same_argmax, prefill_ms=prefill_ms,
         decode_step_ms=step_ms,
         decode_tokens_per_s=len(PROMPTS) / step_ms * 1e3,
         peak_memory_gb=peak_gb,
         tokens={r.rid: r.out_tokens[:8] for r in done})
    phase_profile("prefill", lambda: TT.prefill(eng.params, batch, cfg,
                                                MAX_SEQ), prefill_ms, calls=2)
    phase_profile("decode step", lambda: TT.decode_step(
        eng.params, nxt, caches, DECODE_POS, cfg, MAX_SEQ), step_ms, calls=5)
    return launches


def phase_profile(what, fn, call_ms, calls):
    """Device time by kernel over a few calls of ``fn`` (torch.profiler), and
    the share of the time in which the device ran no kernel: under the
    profiler, and against ``call_ms`` measured without it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only: an aten op's row repeats its kernels' time
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(t for _, t, _ in dev)
    attn_us = sum(t for k, t, _ in dev if "flash_attention" in k)
    top = sorted(dev, key=lambda e: -e[1])[:8]
    emit("profile", what=what, calls=calls, wall_us=wall_us,
         device_busy_us=busy_us, device_idle_share=1 - busy_us / wall_us,
         device_idle_share_unprofiled=1 - busy_us / calls / (call_ms * 1e3),
         attention_kernel_us=attn_us,
         attention_share_of_device=attn_us / busy_us if busy_us else None,
         top=[{"kernel": k[:80], "us": t, "calls": c} for k, t, c in top])


def phase_small_model():
    """The reduced model in float32 on the card (kernel) against the CPU
    (plain version): logits of prefill and one decode step, atol 1e-4."""
    worst = 0.0
    for arch in ("llama3.2-3b", "lacin-demo"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        params = init_params(SEED, cfg, device="cpu")
        tokens = torch.from_numpy(
            np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 70)))
        out = {}
        for dev in ("cpu", "cuda"):
            p = TT.cast_params(params, cfg, dev)
            logits, caches = TT.prefill(p, {"tokens": tokens.to(dev)}, cfg, 96)
            step, _ = TT.decode_step(p, logits.argmax(-1), caches, 70, cfg, 96)
            out[dev] = torch.cat([logits, step], 1).cpu()
        err = float((out["cuda"] - out["cpu"]).abs().max())
        if not (torch.isfinite(out["cuda"]).all() and err <= 1e-4):
            raise AssertionError(f"{arch} reduced: card and CPU differ by {err}")
        worst = max(worst, err)
    emit("small_model_vs_cpu", max_abs_err=worst, tol=1e-4)


def main():
    smi = phase_device()
    phase_build()
    phase_hazards()
    b, h, kvh, d = len(PROMPTS), 24, 8, 128
    pre = time_attention("prefill", b, max(PROMPTS), max(PROMPTS), h, kvh, d,
                         None, copies=1)
    dec = time_attention("decode", b, 1, MAX_SEQ, h, kvh, d, [DECODE_POS],
                         copies=8)
    phase_small_model()
    launches = phase_serve()
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:39",
        "launches": launches["flash_attention"],
        "max_abs_err": max(pre["max_abs_err"], dec["max_abs_err"]),
        "tol": TOL[torch.bfloat16], "kernel_ms": pre["ms"],
        **{key: pre[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "shape")},
        "decode": dec}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
