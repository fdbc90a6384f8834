"""Traffic kind ``train``: the port's train step, dispatched back to back.

Set-up makes the weights on the device from the seed (``weights.py``, the
port's layout, float32), AdamW's state as zeros, and every batch from the
seed as host arrays, ``{"tokens", "labels"}`` int32 (B, T), as the port's
data pipeline hands them to the step: token ids Zipf over the vocabulary
with the mix's exponent, labels the next ids, every position labelled.
It builds the step of ``repro_torch.runtime.trainer.make_train_step`` with
``AxisRules()`` and the mix's optimizer and drives that one state through
the reference's steps (the mix's ``reference_steps``), reading the loss of
each, the first step's gradient norm a leaf from AdamW's first moment,
after the last the parameters' change a leaf, and in a MoE the share of
expert assignments that the capacity dispatch dropped.  These steps warm every shape
the window uses; the later ones are timed, and the window's step count is
the one that fills ``--seconds`` at that time a step.

The window: that many steps on new batches, no host synchronise until the
last has been dispatched, then one.  ``train_tokens_per_s`` is the
labelled tokens of the window's steps over the time from the first
dispatch to that synchronise.  With ``trace`` the window runs under
``torch.profiler`` (device and host activity) and CUDA events time each
call of ``loss_and_grads`` and ``adamw_update`` inside the step.

After the window: the peak memory is read, the program's state freed, and
the plain reference (``reference/<family>.py``) runs the same steps from
the same weights, drawn again from the seed, on the same batches
(``check.py`` compares).
"""
from __future__ import annotations

import gc
import math
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import check, harness, weights
from portbench.yardstick import trace as T

ANNOTATION = "portbench.window"
SPANNED = ("loss_and_grads", "adamw_update")


def zipf_ids(rng, vocab: int, s: float, shape):
    """Ids 0 .. vocab-1 with P(id) proportional to (id + 1)^-s."""
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -s)
    u = rng.random(shape) * cdf[-1]
    return np.minimum(np.searchsorted(cdf, u, side="right"), vocab - 1)


def make_batch(mix, vocab: int, seed: int, index: int) -> dict:
    """Batch ``index`` of a run of ``seed``, the same for any step count."""
    rng = np.random.default_rng([seed, index])
    ids = zipf_ids(rng, vocab, mix["zipf_s"], (mix["batch"], mix["seq"] + 1))
    return {"tokens": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Device time of each call of a wrapped function: CUDA events on the
    card (read after the window), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.calls = {}

    def wrap(self, name, fn):
        calls = self.calls.setdefault(name, [])

        def spanned(*args, **kwargs):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                calls.append((start, end))
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                calls.append(time.perf_counter() - t0)
            return out
        return spanned

    def seconds(self) -> dict:
        """{name: [seconds of each call]}; on the card, after a
        synchronise."""
        if not self.cuda:
            return {n: list(c) for n, c in self.calls.items()}
        return {n: [s.elapsed_time(e) / 1e3 for s, e in c]
                for n, c in self.calls.items()}


@contextmanager
def spanned_trainer(spans: Spans):
    """The trainer's calls of ``loss_and_grads`` and ``adamw_update``
    timed by ``spans`` (the step looks both up in its module)."""
    from repro_torch.runtime import trainer
    saved = {n: getattr(trainer, n) for n in SPANNED}
    try:
        for n in SPANNED:
            setattr(trainer, n, spans.wrap(n, saved[n]))
        yield
    finally:
        for n, fn in saved.items():
            setattr(trainer, n, fn)


@contextmanager
def counted_drops():
    """Count the expert assignments that the port's capacity dispatch
    (``models/moe.py`` ``_dispatch_indices``) keeps and drops, on the
    device, with no synchronise.  Yields [dropped, all] (tensors, or
    None where no dispatch ran); where the port has no such function,
    [None, None]: nothing to read."""
    from repro_torch.models import moe
    counts = [None, None]
    saved = getattr(moe, "_dispatch_indices", None)
    if saved is None:
        yield counts
        return

    def counting(eidx, *args, **kwargs):
        slot, valid = saved(eidx, *args, **kwargs)
        dropped, n = (~valid).sum(), valid.numel()
        counts[0] = dropped if counts[0] is None else counts[0] + dropped
        counts[1] = n if counts[1] is None else counts[1] + n
        return slot, valid
    moe._dispatch_indices = counting
    try:
        yield counts
    finally:
        moe._dispatch_indices = saved


def frozen_step(cfg):
    """A step that returns its state unchanged (a fault, for the tests and
    the readings): the loss and gradient norm of the batch, no update."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime import trainer

    def step(state, batch):
        device = state["params"]["embed"]["table"].device
        loss, _, grads = trainer.loss_and_grads(
            state["params"], trainer.on_device(batch, device), cfg)
        return state, {"loss": loss, "grad_norm": global_norm(grads)}
    return step


def half_batch(batch: dict) -> dict:
    """Half of the rows left out (a fault): the mean over the rest."""
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


@dataclass
class Program:
    """The program's state after the reference's steps, its step and the
    readings of those steps."""
    state: dict
    step: object
    readings: dict
    step_s: list = field(default_factory=list)
    parts: dict = field(default_factory=dict)


def check_layout(params, cfg):
    """The benchmark's tree has the port's layout: paths, shapes, dtypes
    (``param_shapes`` draws nothing)."""
    from repro_torch.models.transformer import param_shapes
    want = [(p, tuple(t.shape), t.dtype)
            for p, t in weights.leaves(param_shapes(cfg))]
    got = [(p, tuple(t.shape), t.dtype) for p, t in weights.leaves(params)]
    if got != want:
        diff = [(a, b) for a, b in zip(got, want) if a != b][:3]
        raise ValueError(f"the weights' layout is not the port's "
                         f"({len(got)} leaves, {len(want)} in the port; "
                         f"first differences {diff})")


def run_program(cell, sizes, seed, device, batches, fault=None) -> Program:
    """Build the state and step and run the reference's steps on
    ``batches``, reading them."""
    from repro_torch.models.layers import AxisRules
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime.trainer import make_train_step
    t0 = time.perf_counter()
    cfg = harness.port_config(cell.config)
    t1 = time.perf_counter()
    params = weights.make(sizes, seed, device)
    check_layout(params, cfg)
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    opt = OptConfig(**cell.mix["optimizer"])
    step = (frozen_step(cfg) if fault == "frozen"
            else make_train_step(cfg, AxisRules(), opt))
    feed = half_batch if fault == "half_batch" else (lambda b: b)
    sync(device)
    t2 = time.perf_counter()
    dropped = [0, 0]
    losses, norms, times = [], None, []
    for i, batch in enumerate(batches):
        sync(device)
        start = time.perf_counter()
        with counted_drops() as drops:
            state, metrics = step(state, feed(batch))
        sync(device)
        times.append(time.perf_counter() - start)
        if drops[1]:
            dropped[0] += int(drops[0])
            dropped[1] += drops[1]
        losses.append(float(metrics["loss"]))
        if i == 0:
            gnorm = float(metrics["grad_norm"])
            scale = min(1.0, opt.clip_norm / max(gnorm, 1e-9))
            m = weights.leaves(state["opt"]["m"])
            got = torch.stack([t.double().norm() for _, t in m])
            norms = {weights.path_name(p): float(n) / ((1 - opt.beta1) * scale)
                     for (p, _), n in zip(m, got)}
    t3 = time.perf_counter()
    changes = weights.change_norms(sizes, seed, state["params"])
    parts = {"port_config_s": t1 - t0, "weights_and_state_s": t2 - t1,
             "steps_s": t3 - t2, "change_norms_s": time.perf_counter() - t3}
    readings = {"losses": losses, "grad_norms": norms, "changes": changes}
    if dropped[1]:
        readings["dropped_share"] = dropped[0] / dropped[1]
    return Program(state, step, readings, times, parts)


def reference_readings(cell, sizes, seed, device, batches,
                       precision="float32") -> dict:
    """The plain reference's readings of the same steps from the same
    weights (drawn again from the seed)."""
    ref = harness.load_module("reference", sizes["family"])
    from portbench.reference import dense
    dense.exact_float32()
    params = weights.make(sizes, seed, device)
    out = ref.train(params, batches, sizes, cell.mix["optimizer"],
                    precision=precision)
    out["changes"] = weights.change_norms(sizes, seed, params)
    del params
    free(device)
    return out


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def window_steps(seconds: float, step_s: list) -> int:
    """Steps that fill ``seconds`` at the warm steps' time a step."""
    warm = step_s[1:] or step_s
    return max(1, round(seconds / (sum(warm) / len(warm))))


def run(ctx) -> dict:
    """One run of a ``train`` cell (``ctx``: harness.RunContext)."""
    cell, mix, device = ctx.cell, ctx.cell.mix, ctx.device
    sizes = harness.model_sizes(cell.config, mix["seq"])
    vocab = sizes["vocab_size"]
    first = [make_batch(mix, vocab, ctx.seed, i)
             for i in range(mix["reference_steps"])]
    started_s = time.perf_counter() - ctx.t0
    prog = run_program(cell, sizes, ctx.seed, device, first, ctx.fault)
    prog_ready_s = time.perf_counter() - ctx.t0
    steps = window_steps(ctx.seconds, prog.step_s)
    feed = half_batch if ctx.fault == "half_batch" else (lambda b: b)
    window = [feed(make_batch(mix, vocab, ctx.seed, len(first) + i))
              for i in range(steps)]
    tokens = sum(int((b["labels"] >= 0).sum()) for b in window)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans = Spans(device)
    state, step, losses = prog.state, prog.step, []
    sync(device)
    setup_s = time.perf_counter() - ctx.t0
    trace = None
    with _profiled(ctx.trace, device) as prof, (
            spanned_trainer(spans) if ctx.trace else nullcontext()):
        with torch.profiler.record_function(ANNOTATION):
            t0 = time.perf_counter()
            for batch in window:
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
            sync(device)
            window_s = time.perf_counter() - t0
    if ctx.trace and prof is not None:
        trace = T.from_profile(prof, ANNOTATION)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device.type == "cuda" else 0)
    failed = sum(not math.isfinite(float(x)) for x in losses)
    span_s = spans.seconds()
    del state, step, prog.state, metrics, losses
    free(device)
    got = prog.readings
    t_ref = time.perf_counter()
    want = reference_readings(cell, sizes, ctx.seed, device, first)
    reference_s = time.perf_counter() - t_ref
    numbers = check.gaps(got, want)
    correct, compared = check.judge(numbers, cell.spec["limits"])
    return {
        "correct": correct and failed == 0, "attempted": steps,
        "failed": failed, "check": compared, "numbers": numbers,
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "setup_s": setup_s},
        "memory_peak_bytes": memory_peak,
        "recorded": harness.Recorded(
            cell=cell.name, sizes=sizes, batch=mix["batch"], seq=mix["seq"],
            steps=steps, window_s=window_s, trace=trace, spans=span_s,
            n_params=weights.n_params(sizes)),
        "notes": {"window_steps": steps, "warm_step_s": prog.step_s,
                  "losses": got["losses"], "reference_losses":
                  want["losses"], "reference_s": reference_s,
                  "driver_started_s": started_s,
                  "program_ready_s": prog_ready_s, **prog.parts},
    }


@contextmanager
def _profiled(on: bool, device):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
