"""``repro_torch.fabric`` — the single entry point for every LACIN topology.

* an **instance registry** (:func:`register_instance` /
  :func:`get_instance` / :func:`instance_names`) holding the paper's
  ``swap`` / ``circle`` / ``xor`` built-ins plus anything a caller
  registers — ``mirror`` (:mod:`.mirror`) is registered below purely
  through the public API;
* the **Fabric protocol** (:class:`Fabric` with :class:`CINFabric`,
  :class:`HyperXFabric`, :class:`DragonflyFabric`, built by
  :func:`make_fabric`): ``neighbor_matrix()``, ``schedule()``,
  ``sim_topology()``, ``link_loads()``, ``deployment()``, ``verify()``
  and ``replay(collective)``, which replays the fabric's own schedule
  through the torch cycle engine;
* the **mesh-aware collectives** (:mod:`.collectives`):
  :class:`LacinCollectives` bound to a ``torch.distributed`` ``DeviceMesh``
  (``fabric.collectives(mesh, ...)`` checks the mesh against the fabric)
  and the hierarchical :func:`all_to_all_grid` /
  :func:`all_reduce_two_level`.
"""
from repro_torch._compat import LacinDeprecationWarning

from .collectives import (LacinCollectives, all_reduce_two_level,
                          all_to_all_grid)
from .registry import (InstanceSpec, get_instance, instance_names,
                       register_instance, registered_instances,
                       unregister_instance)
from . import mirror as _mirror  # registers the 'mirror' instance (public API)
from .fabric import (CINFabric, DragonflyFabric, Fabric, HyperXFabric,
                     make_fabric)

__all__ = [
    "LacinDeprecationWarning",
    "InstanceSpec", "register_instance", "unregister_instance",
    "get_instance", "instance_names", "registered_instances",
    "LacinCollectives", "all_to_all_grid", "all_reduce_two_level",
    "Fabric", "CINFabric", "HyperXFabric", "DragonflyFabric", "make_fabric",
]
