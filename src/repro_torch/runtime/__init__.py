"""Training runtime: train steps, the crash-only loop, explicit data
parallelism with the LACIN gradient all-reduce and the GPipe pipeline
(port of ``repro.runtime``; ``sharding`` is not ported yet, ROADMAP queue
A, item 10(b))."""
