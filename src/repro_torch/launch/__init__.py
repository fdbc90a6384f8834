"""Launch-side models of a step and the meshes.  Port of ``repro.launch``:
:mod:`.analytic`, the executed-FLOPs and HBM-traffic model; :mod:`.specs`,
every model input's shape and dtype without data; :mod:`.mesh`, the
production and host meshes as ``DeviceMesh`` objects and the fabric a mesh
is.  The reference's dry-run and hill-climb modules are not ported yet."""
