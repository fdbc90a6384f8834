"""Production and host meshes, and the fabric a mesh is.

Port of ``repro.launch.mesh``.  The mesh mirrors the paper's §5
deployment: each axis is a radix-16 XOR CIN (16 = 2^4, so the XOR LACIN
instance applies), giving a 16x16 HyperX single pod (256 devices) and a
2x16x16 multi-pod system (512) whose "pod" axis is the Dragonfly-style
global CIN.

The meshes are ``torch.distributed`` ``DeviceMesh`` objects over the
current process group, built by functions, so importing this module
touches no device state and needs no group.  :func:`production_mesh_shape`
gives the production mesh's names and sizes alone (a :class:`MeshShape`),
which is all the spec functions of ``runtime.sharding`` and
:func:`describe_mesh` read, on any world.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.port_matrix import is_power_of_two
from repro_torch.models.transformer import resolve_device


def _production_axes(multi_pod: bool) -> dict:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


class MeshShape:
    """A mesh's axis names and sizes, no devices and no process group:
    ``mesh_dim_names``, ``size(i)`` and ``shape`` (name -> size)."""

    def __init__(self, axes: dict):
        self.mesh_dim_names = tuple(axes)
        self.shape = dict(axes)

    def size(self, i: int) -> int:
        return self.shape[self.mesh_dim_names[i]]

    def __repr__(self):
        return f"MeshShape({self.shape})"


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's (16, 16) ("data", "model") or (2, 16, 16)
    ("pod", "data", "model") shape, for specs and :func:`describe_mesh`."""
    return MeshShape(_production_axes(multi_pod))


def _mesh(device, shape: tuple, names: tuple) -> DeviceMesh:
    device = resolve_device(device)
    return DeviceMesh(device.type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh as a ``DeviceMesh`` over the
    current process group, which must hold its 256 or 512 ranks; raises on
    any other world (:func:`production_mesh_shape` is the shape alone)."""
    axes = _production_axes(multi_pod)
    need = math.prod(axes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                         f"production mesh needs {need} ranks, the process "
                         f"group has {world}")
    return _mesh(device, tuple(axes.values()), tuple(axes))


def make_host_mesh(model: int = 2, *, device="cuda") -> DeviceMesh:
    """A small (world // model, model) ("data", "model") mesh over the
    current process group, ``model`` capped at the world size; ranks past
    ``data * model`` are left out, as the reference leaves devices out.
    Tests and examples."""
    world = dist.get_world_size()
    model = min(model, world)
    return _mesh(device, (world // model, model), ("data", "model"))


def describe_mesh(mesh) -> dict:
    """The mesh as the paper's fabric: its axes, its device count, and each
    axis's CIN instance and 1-factor schedule length.  ``mesh``: a
    ``DeviceMesh``, a :class:`MeshShape`, or any object with
    ``mesh_dim_names`` and ``size(i)``."""
    axes = {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}
    return {
        "axes": axes,
        "devices": math.prod(axes.values()),
        "cin_instances": {name: "xor" if is_power_of_two(size) else "circle"
                          for name, size in axes.items()},
        "schedule_steps": {
            name: size - 1 if size % 2 == 0 or is_power_of_two(size)
            else size for name, size in axes.items()}}
