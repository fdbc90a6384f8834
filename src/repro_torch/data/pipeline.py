"""Deterministic synthetic token pipeline with sharded, restartable loading.

A numpy copy of ``repro.data.pipeline``: the same (seed, step) gives the
same batch, bit for bit, in both packages.

Design goals (the ones that matter at 1000+ nodes):

* **Determinism keyed on (seed, step)** — any host can regenerate any
  microbatch, so a restarted or replacement worker needs no data-state
  handoff (straggler mitigation: work stealing is trivial when data is a
  pure function of the step).
* **Host-sharded**: each host materializes only its slice of the global
  batch (``host_index`` / ``num_hosts``).
* **Double-buffered prefetch** via a background thread.

The generator is a mixture of Zipf-distributed unigrams and a Markov-ish
repeated-ngram process — enough structure that a model's loss decreases,
while remaining fully synthetic and offline.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3      # probability of copying an earlier token
    ignore_index: int = -100


def _batch_rng(cfg: DataConfig, step: int, host_index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_index]))


def host_batch(cfg: DataConfig, step: int, host_index: int = 0,
               num_hosts: int = 1) -> dict:
    """This host's slice of the global batch for ``step`` (pure function)."""
    b = cfg.global_batch // num_hosts
    rng = _batch_rng(cfg, step, host_index)
    # Zipf unigrams, clipped to vocab.
    toks = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1)).astype(np.int64)
    toks = (toks - 1) % cfg.vocab_size
    # repeated-ngram structure: with prob repeat_p, copy token from lag.
    lag = rng.integers(1, 64, size=(b, 1))
    idx = np.arange(cfg.seq_len + 1)[None, :]
    src = np.maximum(idx - lag, 0)
    copy = rng.random((b, cfg.seq_len + 1)) < cfg.repeat_p
    toks = np.where(copy, np.take_along_axis(toks, src, axis=1), toks)
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


class Prefetcher:
    """Background-thread double buffering over ``host_batch``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 host_index: int = 0, num_hosts: int = 1, depth: int = 2):
        self.cfg = cfg
        self.host_index = host_index
        self.num_hosts = num_hosts
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = host_batch(self.cfg, step, self.host_index,
                               self.num_hosts)
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                if self._stop.is_set():
                    return
                self._q.put((step, batch))
                step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
