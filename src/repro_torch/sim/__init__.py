"""``repro_torch.sim`` — the cycle-driven packet simulator for LACIN
fabrics, ported from ``repro.sim``.

The numpy layers (topologies, links, switches, policies, traffic,
metrics and the interpreted oracle :class:`Engine`) are carried as
copies; the compiled cycle engine is :mod:`.xengine`, a torch step
replayed as a CUDA graph and held bit for bit to the reference's JAX
engine.  Quickstart::

    from repro_torch import sim
    topo = sim.cin_topology("xor", 16)
    grid = sim.sweep(topo, "minimal",
                     lambda load, seed: sim.uniform(16, offered=load,
                                                    cycles=1600,
                                                    terminals=12, seed=seed),
                     [0.5, 0.7, 0.9], seeds=range(31, 39), cycles=1600,
                     warmup=400)            # device="cuda" by default
    print(grid[0][0].accepted, grid[0][0].timing)

Collective replays (:mod:`.workloads`) replay a fabric's own 1-factor
schedules through either engine (``sim.replay``, on the card by
default), and :mod:`.report` keeps the reference's deprecated sweep
shims over :mod:`repro_torch.studies`.  ``sweep(devices=)`` splits the
engine's copies over several devices, bit for bit one program.
"""
from .topology import (SimTopology, cin_topology, dragonfly_topology,
                       hyperx_topology, routed_link_loads)
from .switch import QueueFabric, arbitrate
from .link import LinkLoadCounter, LinkTable
from .policies import (AdaptivePolicy, MinimalPolicy, RoutingPolicy,
                       ValiantPolicy, make_policy)
from .traffic import (Traffic, adversarial_same_group, hotspot,
                      one_shot_all_to_all, one_shot_permutation, permutation,
                      uniform)
from .engine import Engine, simulate
from .metrics import RunStats, latency_summary
from .report import (compare_policies, format_table, saturation_point,
                     saturation_sweep, save_json, to_record)
from .workloads import Phase, Workload, collective_workload, replay
from . import xengine
from .xengine import simulate_torch, sweep
