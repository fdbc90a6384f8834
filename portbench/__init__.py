"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- ``configs/<config>.json``: the model as it is run, its source and cuts;
- ``traffic/<mix>.json``: a traffic mix's parameters, read by the
  driver ``traffic/<kind>.py`` that its ``kind`` names;
- ``cells/<cell>.json``: a cell's configuration, mix and the limits of
  its output check;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/<family>.py``: the plain references the output check runs;
- ``yardstick/``: frozen counts of work and bytes, the H100's peaks and
  the reduction of a profiler trace.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; the port is imported only by the traffic drivers.
"""
