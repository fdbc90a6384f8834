"""Step schedules for collectives, derived from CIN 1-factorizations (§2).

The paper's isoport instances are 1-factorizations of K_N: the N ports of
index ``i`` form 1-factor ``i``.  Read as a *communication schedule*, step
``i`` exchanges data along a perfect matching — every device talks to
exactly one partner, no link is shared, and both endpoints use the same
"port"/step index.  This is precisely the step-wise all-to-all discipline
of the paper's refs [8, 9]: the packet simulator replays these steps
(:mod:`repro_torch.sim.workloads`), and the LACIN-scheduled collectives
(:mod:`repro_torch.core.collectives`) execute them, one
``torch.distributed.batch_isend_irecv`` per step.

A :class:`LacinSchedule` is static (built from numpy): a ``(steps, n)``
partner table plus the per-step permutation lists.
``partner[step, s] == s`` marks an idle device (odd-N Circle only).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .port_matrix import IDLE, is_power_of_two


def partner_table(instance: str, n: int) -> np.ndarray:
    """(steps, n) table: device ``s``'s exchange partner at each step.

    Any *isoport* instance in the :mod:`repro_torch.fabric` registry yields a
    matching schedule: step ``i`` is 1-factor ``i`` (P-matrix column
    ``i``), with idle ports mapped to self.  For the paper's built-ins:

    * ``xor``    — steps = n-1, partner = s ^ (step+1); requires n = 2^k.
    * ``circle`` — steps = n-1 (even n) or n (odd n; one idle per step).

    ``cyclic`` is a schedule-only anisoport baseline (not a CIN pairing):
    partner = (s + step + 1) mod n.  Each step is a permutation but NOT a
    matching (send/recv partners differ) — the paper's anisoport case,
    kept for comparison.  Registered anisoport instances (``swap``) are
    rejected: their columns concentrate endpoints and serialize.
    """
    s = np.arange(n)
    if instance == "cyclic":
        steps = [np.mod(s + i + 1, n) for i in range(n - 1)]
        return np.stack(steps).astype(np.int64)
    from repro_torch.fabric.registry import get_instance
    try:
        spec = get_instance(instance)
    except ValueError:
        raise ValueError(f"unknown schedule instance {instance!r}") from None
    if not spec.isoport:
        raise ValueError(
            f"{instance!r} is anisoport: its P-matrix columns are not "
            f"matchings, so they cannot serve as schedule steps")
    P = spec.matrix(n)
    table = np.where(P == IDLE, s[:, None], P)  # idle -> self
    return table.T.astype(np.int64)


@dataclass(frozen=True)
class LacinSchedule:
    """A static step schedule over one mesh axis.

    ``table[step][s]`` is the device ``s`` *sends to*; ``inv_table[step][s]``
    is the device ``s`` *receives from* (the inverse permutation).  For
    isoport (matching) schedules the two coincide — every step is an
    involution; they differ only for the anisoport ``cyclic`` baseline.
    """
    instance: str
    n: int
    table: tuple[tuple[int, ...], ...]       # (steps, n) send-partner table
    inv_table: tuple[tuple[int, ...], ...]   # (steps, n) recv-source table
    perms: tuple[tuple[tuple[int, int], ...], ...]  # per-step (src, dst) pairs

    @property
    def num_steps(self) -> int:
        return len(self.table)

    def partners(self, step: int) -> np.ndarray:
        return np.asarray(self.table[step])

    def perm(self, step: int) -> list[tuple[int, int]]:
        return list(self.perms[step])

    # -- structural properties (the paper's guarantees) ---------------------
    def is_matching_per_step(self) -> bool:
        """Isoport property: each step's partner map is an involution."""
        for row in self.table:
            row = np.asarray(row)
            if not np.array_equal(row[row], np.arange(self.n)):
                return False
        return True

    def is_contention_free(self) -> bool:
        """No directed link carries two flows within a step, and no device
        sends or receives twice (permutation per step)."""
        for perm in self.perms:
            srcs = [a for a, _ in perm]
            dsts = [b for _, b in perm]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                return False
        return True

    def covers_all_pairs(self) -> bool:
        """Across steps, every device meets every other exactly once (as a
        send target)."""
        met = {s: set() for s in range(self.n)}
        for row in self.table:
            for s, t in enumerate(row):
                if t == s:
                    continue
                if t in met[s]:
                    return False
                met[s].add(int(t))
        return all(met[s] == set(range(self.n)) - {s} for s in range(self.n))


@lru_cache(maxsize=None)
def make_schedule(instance: str, n: int) -> LacinSchedule:
    """Build (and cache) the schedule for a mesh axis of size ``n``.

    ``instance='auto'`` picks XOR when n is a power of two (simplest
    routing, Table 1) else Circle (defined for any n).

    Every isoport schedule is a 1-factorization read as steps — N-1
    matchings covering all pairs, each step contention-free:

    >>> s = make_schedule("auto", 8)
    >>> s.instance, s.num_steps
    ('xor', 7)
    >>> s.is_matching_per_step() and s.is_contention_free()
    True
    >>> s.covers_all_pairs()
    True
    >>> s.partners(0).tolist()            # step 0 = 1-factor 0: s ^ 1
    [1, 0, 3, 2, 5, 4, 7, 6]
    """
    if instance == "auto":
        instance = "xor" if is_power_of_two(n) else "circle"
    table = partner_table(instance, n)
    inv = np.empty_like(table)
    for k, row in enumerate(table):
        inv[k, row] = np.arange(n)  # row is a permutation; invert it
    perms = tuple(
        tuple((s, int(t)) for s, t in enumerate(row) if int(t) != s)
        for row in table)
    return LacinSchedule(
        instance=instance, n=n,
        table=tuple(tuple(int(v) for v in row) for row in table),
        inv_table=tuple(tuple(int(v) for v in row) for row in inv),
        perms=perms)


def schedule_for_axis(mesh, axis_name: str, instance: str = "auto") -> LacinSchedule:
    """Schedule for a named axis of a ``torch.distributed`` ``DeviceMesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes: {names})")
    return make_schedule(instance, mesh.size(names.index(axis_name)))
