"""Input-queued switch model: vectorized VC queues + arbitration primitives.

Every (switch, input-port, VC) triple owns one fixed-capacity FIFO.  All
queues across the whole fabric live in three flat numpy arrays (a ring
buffer of packet ids plus head/occupancy counters), so a cycle's worth of
head-gathers, pushes, and pops are single fancy-indexing operations over
*all* switches at once — no per-packet or per-switch Python objects.

Credit flow control falls out of the occupancy array: a hop is feasible
iff the downstream queue's occupancy is below capacity (occupancy *is*
the credit count the upstream switch would track).
"""
from __future__ import annotations

import numpy as np


class QueueFabric:
    """``num_queues`` ring-buffer FIFOs of ``capacity`` packet ids each."""

    def __init__(self, num_queues: int, capacity: int):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.num_queues = num_queues
        self.capacity = capacity
        self.buf = np.full((num_queues, capacity), -1, dtype=np.int64)
        self.head = np.zeros(num_queues, dtype=np.int64)
        self.occ = np.zeros(num_queues, dtype=np.int64)

    # -- vectorized FIFO ops -------------------------------------------------
    def active(self) -> np.ndarray:
        """Queue indices currently holding at least one packet."""
        return np.nonzero(self.occ > 0)[0]

    def heads(self, queues: np.ndarray) -> np.ndarray:
        """Head packet id of each (non-empty) queue in ``queues``."""
        return self.buf[queues, self.head[queues] % self.capacity]

    def pop(self, queues: np.ndarray) -> None:
        """Remove the head packet of each queue (queues must be unique)."""
        self.head[queues] += 1
        self.occ[queues] -= 1

    def push(self, queues: np.ndarray, pids: np.ndarray) -> None:
        """Append packets (queues must be unique and have free space)."""
        slot = (self.head[queues] + self.occ[queues]) % self.capacity
        self.buf[queues, slot] = pids
        self.occ[queues] += 1

    def has_space(self, queues: np.ndarray) -> np.ndarray:
        return self.occ[queues] < self.capacity

    @property
    def total_occupancy(self) -> int:
        return int(self.occ.sum())


def arbitrate(group: np.ndarray, *minor_keys: np.ndarray, k: int = 1
              ) -> np.ndarray:
    """Indices of up to ``k`` winners per group value.

    Requests are grouped by ``group`` (e.g. the contended output link); ties
    within a group break by the ``minor_keys`` in order of significance
    (first key most significant).  Returns positions into the request
    arrays, winners of all groups concatenated.
    """
    if group.size == 0:
        return np.empty(0, dtype=np.int64)
    order = np.lexsort(tuple(reversed(minor_keys)) + (group,))
    g = group[order]
    first = np.searchsorted(g, g, side="left")   # index of each group's start
    rank = np.arange(g.size) - first
    return order[rank < k]
