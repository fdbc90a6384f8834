"""Launch-side models of a step and the meshes.  Port of ``repro.launch``:
:mod:`.analytic`, the executed-FLOPs and HBM-traffic model; :mod:`.specs`,
every model input's shape and dtype without data; :mod:`.mesh`, the
production and host meshes as ``DeviceMesh`` objects and the fabric a mesh
is; :mod:`.hlo_analysis`, the roofline and the collectives a step
dispatches; :mod:`.dryrun`, every (architecture x shape) cell traced on
fake tensors on the production meshes; :mod:`.hillclimb`, three cells
re-traced with one change at a time."""
