"""``repro_torch.fabric`` — the CIN instance registry.

Ported so far: the registry (:mod:`.registry`) with the paper's ``swap``
/ ``circle`` / ``xor`` built-ins and the ``mirror`` instance
(:mod:`.mirror`, registered through the public API).  The ``Fabric``
objects and the mesh-aware collectives are not ported yet (ROADMAP queue
A, items 1 and 9).
"""
from .registry import (InstanceSpec, get_instance, instance_names,
                       register_instance, registered_instances,
                       unregister_instance)
from . import mirror as _mirror  # registers the 'mirror' instance (public API)

__all__ = [
    "InstanceSpec", "register_instance", "unregister_instance",
    "get_instance", "instance_names", "registered_instances",
]
