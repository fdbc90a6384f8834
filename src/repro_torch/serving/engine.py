"""Batched serving engine: prefill + lockstep decode over a KV cache.

Port of ``repro.serving.engine`` with the same semantics: requests queue
up, are admitted into fixed slots, prefilled together (prompts left-padded
with token 0, and the pads attended, as in the reference), then decoded in
lockstep at one shared fill position with greedy or temperature sampling.
An encoder-decoder config gets zero frames, as in the reference.

One deliberate difference (ROADMAP C19): decoding starts at the prompt's
length plus its prefix (a hymba config's meta tokens), where prefill left
the caches; the reference starts at the prompt's length alone, over the
cache's last prefix positions.
Greedy argmax runs on the device; temperature sampling draws from the
engine's numpy ``Generator`` exactly as the reference does, so the same
logits give the same tokens.

On a mesh (``rules`` with one), every rank runs the same requests: given
parameters placed by ``runtime.sharding.param_specs`` (DTensors, or their
local tensors), each computes prefill and decode on its ``tp`` slices
(``models/layers.py``) with head-local caches (its KV heads, SSM channels
and mLSTM heads: ``init_caches(rules=)``), gets the whole logits, and so
the same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import AxisRules
from repro_torch.models.transformer import (cast_params, decode_step,
                                            init_caches, prefill, prefix_len,
                                            resolve_device)
from repro_torch.runtime.sharding import working_copy


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: list = field(default_factory=list)
    done: bool = False
    arrived: int | None = None         # decode step at submit time


class ServingEngine:
    """Fixed-slot continuous batching engine (one model, one device)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 256, rules: AxisRules = AxisRules(),
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rules = rules
        # compute-dtype copies on the device (each rank's working copy on a
        # mesh), made once here
        self.params = cast_params(working_copy(params, cfg, rules), cfg,
                                  self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.caches = init_caches(cfg, slots, max_seq, device=self.device,
                                  rules=rules)
        self.pos = 0                      # lockstep fill position
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.rng = np.random.default_rng(seed)
        self.steps_total = 0              # decode steps across all runs
        self._last_tok = torch.zeros((slots, 1), dtype=torch.int64,
                                     device=self.device)

    # -- request management ---------------------------------------------------
    def submit(self, req: Request, *, at: int | None = None):
        """Queue a request.  ``at`` overrides the recorded arrival step
        (defaults to the engine's decode-step clock) so replayed logs
        keep their original timestamps."""
        req.arrived = self.steps_total if at is None else int(at)
        self.queue.append(req)

    def arrival_trace(self, requests=None):
        """The submitted requests' arrival times as a replayable
        ``kind="trace"`` :class:`repro_torch.workload.ArrivalSpec` — feed
        it to :func:`repro_torch.workload.serving_traffic` (or a
        ``"serving"`` study spec) to drive a fabric simulation with this
        engine's real admission timing.  Sources are left empty: the
        fabric draws them uniformly at replay, since engine slots are not
        switch ids.

        ``requests`` defaults to everything queued or active now; pass
        the list :meth:`run` returned to trace a completed batch.
        """
        from repro_torch.workload import ArrivalSpec
        if requests is None:
            requests = [r for r in self.active if r is not None] + self.queue
        times = tuple(int(r.arrived) for r in requests
                      if r.arrived is not None)
        if not times:
            raise ValueError("no requests with recorded arrival steps; "
                             "submit() some first")
        return ArrivalSpec(kind="trace", times=times)

    def _admit(self):
        """Lockstep admission: fill empty slots at a batch boundary."""
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.pop(0)

    # -- stepping ---------------------------------------------------------------
    def _prefill_all(self):
        """Prefill all admitted prompts (left-padded to a common length)."""
        reqs = [r for r in self.active if r is not None]
        if not reqs:
            return
        tlen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.slots, tlen), np.int64)
        for i, r in enumerate(self.active):
            if r is not None:
                toks[i, -len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.cfg.is_encdec:
            batch["frames"] = torch.zeros(
                (self.slots, self.cfg.encoder_seq_len, self.cfg.d_model),
                dtype=torch.float32, device=self.device)
        logits, self.caches = prefill(self.params, batch, self.cfg,
                                      self.max_seq, rules=self.rules)
        self.pos = tlen + prefix_len(self.cfg, batch)
        # the first token is fed to the next step, not appended
        self._last_tok = torch.from_numpy(self._sample(logits[:, -1])).to(
            self.device)

    def _sample(self, logits):
        """logits: (slots, Vp) on the device -> (slots, 1) numpy tokens."""
        greedy = logits.argmax(dim=-1).cpu().numpy()
        hot = [i for i, r in enumerate(self.active)
               if r is not None and r.temperature > 0]
        rows = logits[hot].float().cpu().numpy() if hot else None
        out = np.zeros((self.slots, 1), np.int64)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            if r.temperature > 0:
                row = rows[hot.index(i)]
                p = np.exp((row - row.max()) / r.temperature)
                p = p / p.sum()
                out[i, 0] = self.rng.choice(len(row), p=p)
            else:
                out[i, 0] = int(greedy[i])
        return out

    def step(self):
        """One decode step for the whole batch."""
        logits, self.caches = decode_step(
            self.params, self._last_tok, self.caches, self.pos, self.cfg,
            self.max_seq, rules=self.rules)
        self.pos += 1
        self.steps_total += 1
        tok = self._sample(logits[:, 0])
        self._last_tok = torch.from_numpy(tok).to(self.device)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.out_tokens.append(int(tok[i, 0]))
            if len(r.out_tokens) >= r.max_new_tokens \
                    or self.pos >= self.max_seq - 1:
                r.done = True
                self.active[i] = None

    def run(self, max_steps: int = 512) -> list[Request]:
        """Run the admitted requests to completion; returns those finished.

        As in the reference, requests queued beyond the slots are admitted
        only by a later run: a prefill mid-run would desynchronise the
        shared position.  The reference goes on stepping empty slots until
        ``max_steps`` while requests wait in the queue, which changes
        nothing it returns; the loop here stops once every slot is empty,
        and advances :attr:`steps_total`, the arrival clock, by the steps
        the reference would have taken.
        """
        self._admit()
        self._prefill_all()
        steps = 0
        all_reqs = [r for r in self.active if r is not None] + self.queue
        while any(r is not None for r in self.active) and steps < max_steps:
            self.step()
            steps += 1
        if any(not r.done for r in all_reqs):
            self.steps_total += max_steps - steps
        return [r for r in all_reqs if r.done]
