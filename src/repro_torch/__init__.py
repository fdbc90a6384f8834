"""PyTorch/CUDA port of the LACIN reproduction's ``repro`` package.

Module paths mirror ``repro`` one to one.  This package imports torch and
numpy, never JAX and nothing of ``repro``.  Ported so far: the LM serving
path (``models``, ``serving``) for attention and xLSTM models, with the
hand-written Hopper kernels for flash attention and the chunkwise mLSTM
scan (``kernels``); the fabric math, schedules and ``Fabric`` objects
(``core``, ``fabric``); the packet simulator with its torch cycle engine,
collective replays, serving request metrics and graphs kept across calls
(``sim``, ``obs``); degraded fabrics and the flow tier (``faults``,
``flow``); serving arrival processes and their CLI, ``python -m
repro_torch.workload`` (``workload``); and the declarative studies with
their CLI, ``python -m repro_torch.studies`` (``studies``); the LACIN
collectives (``core.collectives``, ``fabric.collectives``); training of
every stack (``models.forward_train`` with the autograd Functions of the
kernels, ``optim``, ``data``, ``checkpoint``, ``runtime``), sharded on
``DTensor`` and tensor-parallel; and the launch side (``launch``: the cost
model, input specs, meshes, and the dry run and hill climb traced on fake
tensors).  Every module of ``repro`` has its counterpart but the JAX
shims of ``repro._compat``.
"""
