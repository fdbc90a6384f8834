"""``repro_torch.workload`` — real workloads: extracted training steps +
serving, ported from ``repro.workload``.

Two halves bridging the runtime and simulator tiers:

* **Extraction** (:mod:`~repro_torch.workload.extract`): record a
  training step's collectives as it posts them
  (:func:`repro_torch.core.collectives.record_collectives`, where the
  reference walks compiled HLO) and lower the sequence (MoE all-to-all
  dispatch/combine, DP all-reduce, pipeline point-to-point) into
  byte-accurate, phase-barriered :class:`~repro_torch.sim.workloads.
  Workload` objects replayable on both engines.
* **Serving** (:mod:`~repro_torch.workload.arrivals` /
  :mod:`~repro_torch.workload.serving`, numpy copies of the reference's):
  declarative open-loop arrival processes (:class:`ArrivalSpec`: Poisson /
  bursty MMPP / trace-driven, such as
  :meth:`repro_torch.serving.ServingEngine.arrival_trace`) turned into
  timed injection schedules with per-request latency percentiles and
  SLO-attainment reporting, bit for bit the reference's arrays.  The
  torch cycle engine runs the resulting traffic on the card
  (:func:`repro_torch.sim.sweep`).

``python -m repro_torch.workload`` exposes both as a CLI (extract /
replay / slo).
"""
from .arrivals import KINDS, ArrivalSpec
from .extract import (COLLECTIVE_TO_SCHEDULE, dp_step_ops, extract_ops,
                      moe_step_ops, pipeline_step_ops, workload_from_ops)
from .serving import serving_demands, serving_traffic

__all__ = [
    "ArrivalSpec",
    "KINDS",
    "COLLECTIVE_TO_SCHEDULE",
    "workload_from_ops",
    "extract_ops",
    "moe_step_ops",
    "dp_step_ops",
    "pipeline_step_ops",
    "serving_traffic",
    "serving_demands",
]
