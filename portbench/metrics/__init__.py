"""Per-layer metric readers, one a metric (``<metric>.py``), each with
``read(recorded) -> float | None`` (``harness.Recorded``); None where the
run recorded nothing to read, and the metric is then left out."""
