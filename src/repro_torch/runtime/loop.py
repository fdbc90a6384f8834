"""Fault-tolerant training loop: checkpoint/restart, failure injection,
deterministic data.

Port of ``repro.runtime.loop``.  The loop is crash-only software: *any*
failure path (injected or real) is handled by the same mechanism, a
restart from the latest atomic checkpoint.  Because the data pipeline is a
pure function of (seed, step), a restarted job replays the exact token
stream with no data-state handoff.  Checkpoints hold the reference's
layout (``models.convert.train_state_to_numpy``), so a run of either
package resumes in the other.  With a mesh, every rank runs the loop: the
fresh or restored state is placed on the mesh by
``runtime.sharding.state_specs``, the step is sharded, and a checkpoint is
the gathered state (``CheckpointManager.save`` of DTensors), which a
restart restores onto the mesh with ``shardings=``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import ModelConfig
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_from_reference,
                                        train_state_like,
                                        train_state_to_numpy,
                                        train_state_to_reference)
from repro_torch.optim import OptConfig
from repro_torch.runtime.sharding import (checkpoint_shardings, shard_tree,
                                          state_specs)
from repro_torch.runtime.trainer import (init_train_state, make_rules,
                                         make_train_step)


class InjectedFailure(RuntimeError):
    """Raised by the failure-injection hook to simulate a node crash."""


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "results/ckpt"
    keep: int = 3
    log_every: int = 10
    fail_at_steps: tuple[int, ...] = ()       # failure injection (tests)
    max_restarts: int = 8


@dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    losses: list = field(default_factory=list)
    restored_from: list = field(default_factory=list)


def _attempt(cfg: ModelConfig, opt: OptConfig, loop: LoopConfig,
             data: DataConfig, mesh, report: LoopReport, fail_once: set,
             mgr: CheckpointManager, device) -> bool:
    """One run attempt; returns True when training completed."""
    rules = make_rules(mesh)
    step_fn = make_train_step(cfg, rules, opt)
    start = mgr.latest_step()
    state = init_train_state(data.seed, cfg, device=device)
    specs = None if mesh is None else state_specs(state["params"], cfg,
                                                  rules)
    if start is not None:
        like = train_state_like(state, cfg)
        del state
        if mesh is None:
            state = train_state_from_numpy(mgr.restore(start, like), cfg,
                                           device)
        else:
            state = train_state_from_reference(mgr.restore(
                start, like, shardings=checkpoint_shardings(specs, cfg,
                                                            mesh)), cfg)
        report.restored_from.append(start)
        first = start
    else:
        if mesh is not None:
            state = shard_tree(state, specs, mesh)
        first = 0
    snapshot = train_state_to_numpy if mesh is None \
        else train_state_to_reference

    for step in range(first, loop.total_steps):
        if step in fail_once:
            fail_once.discard(step)
            raise InjectedFailure(f"injected failure at step {step}")
        state, metrics = step_fn(state, host_batch(data, step))
        report.steps_run += 1
        if step % loop.log_every == 0 or step == loop.total_steps - 1:
            report.losses.append((step, float(metrics["loss"])))
        if (step + 1) % loop.ckpt_every == 0:
            mgr.save(step + 1, snapshot(state, cfg))
    mgr.save(loop.total_steps, snapshot(state, cfg), blocking=True)
    return True


def run_training(cfg: ModelConfig, opt: OptConfig, loop: LoopConfig,
                 data: DataConfig, mesh=None, *,
                 device="cuda") -> LoopReport:
    """Crash-only training on ``device``: restart from the latest
    checkpoint on failure.  Each attempt starts from ``init_train_state
    (data.seed, ...)`` or the latest checkpoint.  ``mesh``: a
    ``DeviceMesh`` on ``device``'s type, every rank calling this, to train
    sharded (the module docstring)."""
    report = LoopReport()
    fail_once = set(loop.fail_at_steps)
    # One manager across attempts: its wait() must cover writes that were
    # still in flight when the failure hit (async-save / crash race).
    mgr = CheckpointManager(loop.ckpt_dir, keep=loop.keep)
    for _ in range(loop.max_restarts + 1):
        try:
            _attempt(cfg, opt, loop, data, mesh, report, fail_once, mgr,
                     device)
            return report
        except InjectedFailure:
            report.restarts += 1
            mgr.wait()
            continue
    raise RuntimeError(f"exceeded {loop.max_restarts} restarts")
