"""Declarative failure injection: the :class:`FailureSpec`.

A ``FailureSpec`` names *which* links and switches are dead — seeded
random fractions plus explicit lists — and *what disconnection means*
(``policy``).  It is a :class:`repro_torch.studies.spec._SpecBase`, so it
JSON-round-trips exactly and nests inside an
:class:`~repro_torch.studies.spec.ExperimentSpec` (the optional ``failures``
field), keeping failure sweeps as declarative as every other study axis.

Sampling is deterministic given ``seed``: switch failures draw first
(``round(switch_fraction * N)`` switches from one permutation), then
link failures (``round(link_fraction * L)`` of the pristine fabric's
``L`` undirected links, in canonical ``(switch, port)`` order) — so the
same spec kills the same hardware on every backend and every run.
Explicit ``dead_links`` are undirected ``(switch_a, switch_b)`` endpoint
pairs (unique per pair in all three in-repo families); explicit
``dead_switches`` are switch indices.  A dead switch takes every
incident link down with it.

``policy`` decides what happens to traffic between *surviving* switches
that the failures disconnected:

* ``"strict"`` (default) — a disconnected residual fabric is an error:
  :func:`repro_torch.faults.degrade` raises
  :class:`~repro_torch.faults.degrade.FabricDisconnectedError`.
* ``"drop"`` — unreachable surviving pairs are dropped from traffic,
  workloads, and flow demands (their packets simply never exist).

Traffic sourced at or destined to a *dead* switch is dropped under
either policy — those endpoints are gone, not merely unreachable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from repro_torch.studies.spec import _SpecBase

__all__ = ["FailureSpec", "POLICIES"]

#: Disconnection policies, in documentation order.
POLICIES = ("strict", "drop")


@dataclass(frozen=True, eq=True)
class FailureSpec(_SpecBase):
    """Which hardware is dead, and what disconnection means.

    All fields are JSON-serializable; ``FailureSpec.from_json(
    spec.to_json()) == spec`` exactly (the ``_SpecBase`` contract).
    """
    link_fraction: float = 0.0
    switch_fraction: float = 0.0
    seed: int = 0
    dead_links: tuple = ()
    dead_switches: tuple = ()
    policy: str = "strict"

    def __post_init__(self):
        super().__post_init__()
        lf, sf = float(self.link_fraction), float(self.switch_fraction)
        if not 0.0 <= lf < 1.0 or not 0.0 <= sf < 1.0:
            raise ValueError(
                f"failure fractions must lie in [0, 1); got "
                f"link_fraction={lf}, switch_fraction={sf}")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown disconnection policy "
                             f"{self.policy!r}; expected one of {POLICIES}")
        pairs = set()
        for pair in self.dead_links:
            if len(pair) != 2:
                raise ValueError(f"dead_links entries are (switch_a, "
                                 f"switch_b) pairs; got {pair!r}")
            a, b = int(pair[0]), int(pair[1])
            if a == b:
                raise ValueError(f"dead link ({a}, {b}) is a self-loop; "
                                 f"links join distinct switches")
            pairs.add((min(a, b), max(a, b)))
        object.__setattr__(self, "link_fraction", lf)
        object.__setattr__(self, "switch_fraction", sf)
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(self, "dead_links", tuple(sorted(pairs)))
        object.__setattr__(
            self, "dead_switches",
            tuple(sorted({int(s) for s in self.dead_switches})))

    @property
    def is_null(self) -> bool:
        """True when the spec kills nothing — :func:`~repro_torch.faults.degrade`
        returns the pristine topology unchanged (bit-identical results
        by construction)."""
        return (self.link_fraction == 0.0 and self.switch_fraction == 0.0
                and not self.dead_links and not self.dead_switches)

    @property
    def label(self) -> str:
        """Compact human tag (experiment names, degraded topology names)."""
        if self.is_null:
            return "f0"
        bits = []
        if self.link_fraction:
            bits.append(f"L{self.link_fraction:g}")
        if self.switch_fraction:
            bits.append(f"S{self.switch_fraction:g}")
        if self.dead_links:
            bits.append(f"dl{len(self.dead_links)}")
        if self.dead_switches:
            bits.append(f"ds{len(self.dead_switches)}")
        if self.link_fraction or self.switch_fraction:
            bits.append(f"s{self.seed}")
        if self.policy != "strict":
            bits.append(self.policy)
        return "-".join(bits)

    @classmethod
    def coerce(cls, obj) -> "FailureSpec | None":
        """``None`` | FailureSpec | its dict form -> FailureSpec | None."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, Mapping):
            return cls.from_dict(obj)
        raise TypeError(f"failures must be a FailureSpec (or its dict "
                        f"form), got {type(obj).__name__}")
