"""Fault-tolerant checkpointing: atomic, async, self-validating.

Port of ``repro.checkpoint.manager``, with its on-disk format: a
checkpoint is ``step_KKKKKKKK/`` holding ``data.npz`` (arrays ``a0``,
``a1``, ... in the order of the tree's leaves, dict keys sorted as
``jax.tree_util`` sorts them) and ``MANIFEST.json`` (the step, each
array's path name such as ``params/stack/0/attn/wq``, shape and dtype, and
the sha256 of ``data.npz``).  So a checkpoint written by either package
restores in the other, given the same tree: the port's train state goes
through ``repro_torch.models.convert.train_state_to_numpy`` into the
reference's stacked layout first.

* **Atomic**: write to ``step_K.tmp/`` then ``os.rename``; a crash
  mid-save never corrupts the latest checkpoint.
* **Async**: the copy to host memory happens on the caller's thread;
  serialization and fsync on a background thread, one write in flight.
* **Self-validating**: ``restore`` checks the sha256; ``latest_step``
  only reports checkpoints whose manifest reads back.

Leaves may be numpy arrays or torch tensors.  A bf16 leaf raises in
``save``: numpy has no bf16 (the reference's needs ``ml_dtypes``), and a
train state is fp32.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch


def _flatten_with_names(tree, prefix=()):
    """(names, leaves) in ``jax.tree_util``'s order: dict keys sorted,
    list items in order; a name joins the path with ``/``.  Anything else,
    a tuple such as ``ShapeDtype`` included, is a leaf."""
    if isinstance(tree, dict):
        pairs = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        pairs = list(enumerate(tree))
    else:
        return ["/".join(map(str, prefix))], [tree]
    names, leaves = [], []
    for k, sub in pairs:
        n, lv = _flatten_with_names(sub, prefix + (k,))
        names += n
        leaves += lv
    return names, leaves


def _unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, in flatten
    order) in place of its leaves."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_unflatten(x, leaves) for x in tree]
    return next(leaves)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf cannot be saved: numpy has no "
                            "bfloat16; checkpoint the fp32 train state")
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _numpy_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = False):
        """Snapshot ``state`` at ``step``.  Copies to host memory now;
        writes on a background thread unless ``blocking``.  A write that
        failed raises from the next ``save`` or ``wait``."""
        names, leaves = _flatten_with_names(state)
        host_leaves = [_to_host(x) for x in leaves]

        def _write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            with open(tmp / "data.npz", "wb") as f:
                np.savez(f, **{f"a{i}": a for i, a in enumerate(host_leaves)})
                f.flush()
                os.fsync(f.fileno())
            digest = hashlib.sha256(
                (tmp / "data.npz").read_bytes()).hexdigest()
            manifest = {"step": step, "arrays": {
                f"a{i}": {"name": n, "shape": list(a.shape),
                          "dtype": str(a.dtype)}
                for i, (n, a) in enumerate(zip(names, host_leaves))},
                "sha256": digest}
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

        def _run():
            try:
                _write()
            except BaseException as e:     # handed to the caller's thread
                self._error = e

        with self._lock:
            self._join()                   # one in flight at a time
            t = threading.Thread(target=_run, daemon=True)
            t.start()
            self._pending = t
        if blocking:
            self.wait()

    def _join(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a checkpoint write failed") from err

    def wait(self):
        with self._lock:
            self._join()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- load ---------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "MANIFEST.json").exists():
                continue
            try:
                man = json.loads((p / "MANIFEST.json").read_text())
                out.append(int(man["step"]))
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like):
        """The checkpoint of ``step`` in the structure of ``like``, whose
        leaves give each array's shape and dtype (numpy arrays, torch
        tensors or ``convert.ShapeDtype``); numpy leaves."""
        path = self.dir / f"step_{step:08d}"
        man = json.loads((path / "MANIFEST.json").read_text())
        blob = (path / "data.npz").read_bytes()
        if hashlib.sha256(blob).hexdigest() != man["sha256"]:
            raise IOError(f"checksum mismatch in {path}")
        names, leaves = _flatten_with_names(like)
        by_name = {v["name"]: k for k, v in man["arrays"].items()}
        out = []
        with np.load(path / "data.npz") as data:
            for n, leaf in zip(names, leaves):
                arr = data[by_name[n]]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{n}: ckpt shape {arr.shape} != "
                                     f"{tuple(leaf.shape)}")
                out.append(arr.astype(_numpy_dtype(leaf.dtype)))
        return _unflatten(like, iter(out))
