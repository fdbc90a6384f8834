"""``repro_torch.workload`` — serving workloads, ported from
``repro.workload``.

:mod:`~repro_torch.workload.arrivals` and
:mod:`~repro_torch.workload.serving` are numpy copies of the reference's:
declarative open-loop arrival processes (:class:`ArrivalSpec`: Poisson /
bursty MMPP / trace-driven) turned into timed injection schedules with
per-request latency percentiles and SLO-attainment reporting, bit for bit
the reference's arrays.  The torch cycle engine runs the resulting
traffic on the card (:func:`repro_torch.sim.sweep`).

The reference's other half, extracting a training step's collectives
from its compiled HLO (``workload_from_hlo``, ``moe_step_hlo``, ...), is
not ported yet (ROADMAP queue A, item 10(f)) and has no name here.

``python -m repro_torch.workload`` is the CLI: ``replay`` and ``slo``
(``extract`` fails, naming that item).
"""
from .arrivals import KINDS, ArrivalSpec
from .serving import serving_demands, serving_traffic

__all__ = ["ArrivalSpec", "KINDS", "serving_traffic", "serving_demands"]
