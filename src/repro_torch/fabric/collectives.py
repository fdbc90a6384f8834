"""Mesh-aware LACIN collectives, flat and hierarchical.

Port of ``repro.fabric.collectives``.  :class:`LacinCollectives` binds the
paper's 1-factor step schedules to a ``torch.distributed`` ``DeviceMesh``:
every axis size is read from the mesh (``mesh.size(dim)``) and every axis's
process group is ``mesh.get_group(name)``, so the schedule can never
disagree with the mesh shape.  Without a mesh (``mesh=None``) the axis is a
``ProcessGroup`` itself, and its size is the group's.

On top of the single-axis matching chains from
:mod:`repro_torch.core.collectives`, two *hierarchical* schedules express
what the flat API cannot:

* :func:`all_to_all_grid` — personalized all-to-all over a HyperX-shaped
  mesh (a Cartesian product of CINs, paper §5): one LACIN schedule per
  mesh dimension, composed dimension-order.  A ``(K_a, K_b, ...)`` mesh
  runs ``sum_d (K_d - 1)`` matching steps instead of ``prod_d K_d - 1``,
  and every step stays inside one dimension's CIN rows.
* :func:`all_reduce_two_level` — two-level Dragonfly all-reduce: local
  reduce-scatter (inside the group's CIN) -> global all-reduce of the
  scattered shards (one flow per group pair on the global CIN) -> local
  all-gather.  Global traffic is ``1/a`` of a flat all-reduce's.

Both are held to the JAX reference and to ``dist.all_to_all_single`` /
``dist.all_reduce`` in ``tests/test_torch_collectives.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.collectives import (all_gather_lacin, all_reduce_lacin,
                                          all_to_all_lacin,
                                          library_all_reduce,
                                          reduce_scatter_lacin, tree_map)
from repro_torch.core.schedule import LacinSchedule, make_schedule


# ---------------------------------------------------------------------------
# Hierarchical schedules (free functions; groups explicit).
# ---------------------------------------------------------------------------

def all_to_all_grid(x: torch.Tensor, groups: Sequence,
                    sizes: Sequence[int] | None = None, *,
                    instance: str | Sequence[str] = "auto") -> torch.Tensor:
    """Personalized all-to-all over the product of ``groups`` (one process
    group per mesh axis, outermost first).

    ``x`` has leading dim ``prod(sizes)``; ``x[j]`` is this rank's chunk
    for rank ``j``, with ``j`` the row-major index over the axes.  Composed
    dimension-order: one LACIN matching schedule per mesh axis, innermost
    axis first.  ``instance`` may be a single name or one per axis; each
    of ``sizes`` must equal its group's size.
    """
    groups = tuple(groups)
    if sizes is None:
        sizes = tuple(dist.get_world_size(g) for g in groups)
    else:
        sizes = tuple(int(s) for s in sizes)
    insts = ((instance,) * len(groups) if isinstance(instance, str)
             else tuple(instance))
    if len(insts) != len(groups):
        raise ValueError(f"got {len(insts)} instances for {len(groups)} axes")
    total = math.prod(sizes)
    if x.shape[0] != total:
        raise ValueError(f"leading dim {x.shape[0]} != prod{sizes} = {total}")
    rest = tuple(x.shape[1:])
    x = x.reshape(sizes + rest)          # per-axis destination coordinates
    for d in reversed(range(len(groups))):
        x = torch.movedim(x, d, 0)
        x = all_to_all_lacin(x, groups[d], axis_size=sizes[d],
                             instance=insts[d])
        x = torch.movedim(x, 0, d)       # coord d now indexes the *source*
    return x.reshape((total,) + rest)


def all_reduce_two_level(x: torch.Tensor, local_group, global_group, *,
                         local_size: int | None = None,
                         global_size: int | None = None,
                         local_instance: str = "auto",
                         global_instance: str = "auto") -> torch.Tensor:
    """Two-level Dragonfly all-reduce (sum) over ``local x global``.

    Local reduce-scatter -> global all-reduce of the 1/a-sized shards ->
    local all-gather.  Equals a sum over both groups; 2(a-1) local +
    2(g-1) global matching steps, with every global step carrying shards of
    ``1/a`` of the payload.
    """
    a = (int(local_size) if local_size is not None
         else dist.get_world_size(local_group))
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    pad = (-flat.numel()) % a
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    shard = reduce_scatter_lacin(flat.reshape(a, -1), local_group,
                                 axis_size=a, instance=local_instance)
    shard = all_reduce_lacin(shard, global_group, axis_size=global_size,
                             instance=global_instance)
    flat = all_gather_lacin(shard, local_group, axis_size=a,
                            instance=local_instance).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# The mesh-bound front-end.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LacinCollectives:
    """LACIN collectives bound to a ``DeviceMesh``: axis sizes and groups
    come from the mesh.

    ``mesh=None`` is allowed — each method then takes a ``ProcessGroup`` in
    place of the axis name.  ``instance`` picks the schedule per axis
    (``'auto'`` = XOR for power-of-two sizes, else Circle);
    ``axis_instances`` overrides it per axis (how ``DragonflyFabric`` binds
    its local/global instances).  ``impl='xla'`` keeps the reference's name
    for the library's own all-reduce: :meth:`psum` then calls
    ``dist.all_reduce`` for A/B comparisons.  Obtain one via
    ``fabric.collectives(mesh, ...)`` to also get the fabric-vs-mesh shape
    check.
    """
    mesh: object | None = None
    instance: str = "auto"
    impl: str = "lacin"
    axis_instances: tuple[tuple[object, str], ...] = ()

    # -- mesh introspection --------------------------------------------------
    def _dim(self, axis_name: str) -> int:
        names = tuple(self.mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise ValueError(f"bound mesh has no axis {axis_name!r} (axes: "
                             f"{names})")
        return names.index(axis_name)

    def axis_size(self, axis) -> int:
        if self.mesh is not None:
            return int(self.mesh.size(self._dim(axis)))
        return dist.get_world_size(axis)

    def group(self, axis):
        """The process group of ``axis`` (the axis itself without a mesh)."""
        if self.mesh is not None:
            self._dim(axis)
            return self.mesh.get_group(axis)
        return axis

    def axis_instance(self, axis) -> str:
        return dict(self.axis_instances).get(axis, self.instance)

    def schedule(self, axis) -> LacinSchedule:
        """The static step schedule this object uses on ``axis``."""
        return make_schedule(self.axis_instance(axis), self.axis_size(axis))

    def _kw(self, axis) -> dict:
        return dict(axis_size=self.axis_size(axis),
                    instance=self.axis_instance(axis))

    # -- flat (single-axis) collectives --------------------------------------
    def all_to_all(self, x, axis):
        return all_to_all_lacin(x, self.group(axis), **self._kw(axis))

    def all_gather(self, x, axis, *, tiled: bool = False):
        return all_gather_lacin(x, self.group(axis), tiled=tiled,
                                **self._kw(axis))

    def reduce_scatter(self, x, axis):
        return reduce_scatter_lacin(x, self.group(axis), **self._kw(axis))

    def all_reduce(self, x, axis):
        return all_reduce_lacin(x, self.group(axis), **self._kw(axis))

    def psum(self, x, axis):
        """All-reduce; ``impl='xla'`` defers to ``dist.all_reduce``."""
        if self.impl == "xla":
            return library_all_reduce(x, self.group(axis))
        return self.all_reduce(x, axis)

    def tree_all_reduce(self, tree, axis):
        """All-reduce every tensor leaf (DP gradient reduction)."""
        return tree_map(lambda g: self.all_reduce(g, axis), tree)

    # -- hierarchical collectives ---------------------------------------------
    def all_to_all_grid(self, x, axes: Sequence):
        """Multi-axis dimension-order all-to-all (HyperX-shaped mesh)."""
        axes = tuple(axes)
        return all_to_all_grid(
            x, tuple(self.group(a) for a in axes),
            tuple(self.axis_size(a) for a in axes),
            instance=tuple(self.axis_instance(a) for a in axes))

    def all_reduce_two_level(self, x, local_axis, global_axis):
        """Two-level Dragonfly all-reduce (local RS -> global AR -> local AG)."""
        return all_reduce_two_level(
            x, self.group(local_axis), self.group(global_axis),
            local_size=self.axis_size(local_axis),
            global_size=self.axis_size(global_axis),
            local_instance=self.axis_instance(local_axis),
            global_instance=self.axis_instance(global_axis))
