"""Launch-side models of a step.  Port of ``repro.launch``: :mod:`.analytic`,
the executed-FLOPs and HBM-traffic model, and :mod:`.specs`, every model
input's shape and dtype without data; the reference's mesh, dry-run and
hill-climb modules are not ported yet."""
