"""Launch-side models of a step's cost.  Port of ``repro.launch``: only
:mod:`.analytic`, the executed-FLOPs and HBM-traffic model; the
reference's mesh, spec, dry-run and hill-climb modules are JAX-specific."""
