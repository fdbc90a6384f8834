"""The paper's CIN instances, their table-free routing and the HyperX /
Dragonfly compositions, carried from ``repro.core`` (numpy), with
branchless torch twins of the reference's ``jnp`` routers.

Ported: ``port_matrix``, ``factorization``, ``routing``, ``layout``,
``hyperx``, ``dragonfly``, ``schedule`` (the 1-factor step schedules) and
``simulate`` (the closed-form link loads) and ``collectives`` (the
1-factor step chains over a ``torch.distributed`` process group).
"""
from .port_matrix import (IDLE, circle_matrix, circle_neighbor,
                          is_complete, is_isoport, is_power_of_two,
                          port_matrix, swap_matrix, swap_neighbor,
                          swap_peer_port, verify_instance, xor_matrix,
                          xor_neighbor)
from .factorization import (column_contention, factor, factorization,
                            factors, is_one_factorization,
                            is_perfect_matching)
from .routing import (ROUTING_COST, route, route_circle,
                      route_circle_closed, route_circle_torch, route_packet,
                      route_swap, route_swap_torch, route_torch, route_xor,
                      route_xor_torch, routing_ops)
from .layout import (circle_layout_crossings_with_rule,
                     circle_predicted_crossings, column_report,
                     factor_crossings, instance_crossings,
                     lacin_total_wire_length,
                     lacin_total_wire_length_enumerated, swap_to_lacin_ratio,
                     swap_total_wire_length, table1, wire_length_histogram)
from .hyperx import (HyperXConfig, HyperXDeployment, all_pairs_max_hops,
                     fig4_4cubed, paper_16cubed)
from .dragonfly import (DragonflyConfig, PartitionedCIN, fig3_16,
                        frontier_like, hpe_dragonfly_group)
from .schedule import (LacinSchedule, make_schedule, partner_table,
                       schedule_for_axis)
from .collectives import (all_gather_lacin, all_reduce_lacin,
                          all_to_all_lacin, psum_or_lacin,
                          reduce_scatter_lacin, tree_all_reduce_lacin)
from .simulate import (all_to_all_steps, cin_link_loads,
                       dragonfly_link_loads, hyperx_link_loads,
                       schedule_hop_counts, schedule_step_report,
                       valiant_link_loads)
