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
train state is fp32.  ``data.npz`` is written with fixed zip timestamps,
so its bytes depend on the arrays alone.

* **Mesh-agnostic**, as the reference's: a tree with DTensor leaves (a
  sharded train state through ``models.convert.train_state_to_reference``)
  is saved whole.  Every rank calls ``save``, which gathers each leaf (a
  collective); rank 0 alone writes, and every rank waits for the publish
  in its next ``save`` or ``wait`` (a barrier), so its bytes are an
  unsharded save's.  ``restore(..., shardings=)`` places each array on a
  mesh, whatever mesh wrote it: every rank reads the file and keeps its
  own slice (``runtime.sharding.place``), the elastic-restart hook.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.runtime.sharding import place


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
    if isinstance(x, DTensor):
        x = x.full_tensor()
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


def _write_npz(f, arrays: dict):
    """``np.savez``'s format (stored, zip64 entries ``<name>.npy``) with a
    fixed timestamp on every entry, where ``np.savez`` stamps the time."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0,
                                                             0, 0))
            with zf.open(info, "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, np.asanyarray(a),
                                          allow_pickle=False)


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = False):
        """Snapshot ``state`` at ``step``.  Copies to host memory now (a
        DTensor leaf gathered: every rank calls ``save`` then); writes on a
        background thread unless ``blocking``, on rank 0 alone for a
        sharded state.  A write that failed raises from the next ``save``
        or ``wait``."""
        names, leaves = _flatten_with_names(state)
        sharded = any(isinstance(x, DTensor) for x in leaves)
        host_leaves = [_to_host(x) for x in leaves]
        writer = not sharded or dist.get_rank() == 0

        def _write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            with open(tmp / "data.npz", "wb") as f:
                _write_npz(f, {f"a{i}": a for i, a in enumerate(host_leaves)})
                f.flush()
                os.fsync(f.fileno())
            digest = _sha256(tmp / "data.npz")
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
            if writer:
                t = threading.Thread(target=_run, daemon=True)
                t.start()
                self._pending = t
            self._barrier = sharded and dist.get_world_size() > 1
        if blocking:
            self.wait()

    def _join(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._barrier:                  # rank 0 has published
            self._barrier = False
            dist.barrier()
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

    def restore(self, step: int, like, *, shardings=None):
        """The checkpoint of ``step`` in the structure of ``like``, whose
        leaves give each array's shape and dtype (numpy arrays, torch
        tensors or ``convert.ShapeDtype``); numpy leaves.  ``shardings``: a
        matching tree of ``(mesh, spec)`` (a ``runtime.sharding.Spec``) or
        ``(mesh, placements)`` pairs, which makes each leaf a DTensor on its
        mesh, this rank's slice read from the file: whatever mesh wrote
        it."""
        path = self.dir / f"step_{step:08d}"
        man = json.loads((path / "MANIFEST.json").read_text())
        if _sha256(path / "data.npz") != man["sha256"]:
            raise IOError(f"checksum mismatch in {path}")
        names, leaves = _flatten_with_names(like)
        places = ([None] * len(leaves) if shardings is None
                  else _flatten_with_names(shardings)[1])
        if len(places) != len(leaves):
            raise ValueError(f"{len(places)} shardings for {len(leaves)} "
                             "leaves")
        by_name = {v["name"]: k for k, v in man["arrays"].items()}
        out = []
        with np.load(path / "data.npz") as data:
            for n, leaf, where in zip(names, leaves, places):
                arr = data[by_name[n]]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{n}: ckpt shape {arr.shape} != "
                                     f"{tuple(leaf.shape)}")
                arr = arr.astype(_numpy_dtype(leaf.dtype))
                if where is not None:
                    mesh, how = where
                    arr = place(arr, how, mesh)
                out.append(arr)
        return _unflatten(like, iter(out))
