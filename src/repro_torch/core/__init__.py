"""The paper's CIN instances, their table-free routing and the HyperX /
Dragonfly compositions, carried from ``repro.core`` (numpy), with
branchless torch twins of the reference's ``jnp`` routers.

Ported so far: ``port_matrix``, ``routing``, ``hyperx``, ``dragonfly``
and ``simulate`` (the closed-form link loads).  Factorizations, layouts,
1-factor schedules and the collectives are not ported yet (ROADMAP queue
A, items 1 and 9).
"""
from .port_matrix import (IDLE, circle_matrix, circle_neighbor,
                          is_complete, is_isoport, is_power_of_two,
                          port_matrix, swap_matrix, swap_neighbor,
                          swap_peer_port, verify_instance, xor_matrix,
                          xor_neighbor)
from .routing import (ROUTING_COST, route, route_circle,
                      route_circle_closed, route_circle_torch, route_packet,
                      route_swap, route_swap_torch, route_torch, route_xor,
                      route_xor_torch, routing_ops)
from .hyperx import (HyperXConfig, HyperXDeployment, all_pairs_max_hops,
                     fig4_4cubed, paper_16cubed)
from .dragonfly import (DragonflyConfig, PartitionedCIN, fig3_16,
                        frontier_like, hpe_dragonfly_group)
from .simulate import (all_to_all_steps, cin_link_loads,
                       dragonfly_link_loads, hyperx_link_loads,
                       schedule_hop_counts, schedule_step_report,
                       valiant_link_loads)
