"""Training runtime: train steps (single-device, and sharded over a
``DeviceMesh`` by ``sharding``'s specs), the crash-only loop, explicit data
parallelism with the LACIN gradient all-reduce and the GPipe pipeline
(port of ``repro.runtime``)."""
