"""Training runtime: train steps, the crash-only loop and explicit data
parallelism with the LACIN gradient all-reduce (port of ``repro.runtime``;
``pipeline`` and ``sharding`` are not ported yet, ROADMAP queue A, item
10(b))."""
