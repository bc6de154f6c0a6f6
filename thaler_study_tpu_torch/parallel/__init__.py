"""Mesh-parallel proving over the sharded hypercube.

Counterpart of ``thaler_study_tpu/parallel/``. The reference has no
parallelism; the JAX package shards the 2^n evaluation tables over a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives. The port:

- data parallel over the hypercube: the tables' trailing variables (the
  last block's) sharded over a :class:`~.sharded.Mesh` of ``torch``
  devices (``ShardedProductPoly``, ``ShardedBlockPoly``: the triangle IP
  on Z, dense GKR W on c); local folds touch no other device, and each
  round moves only its (degree + 1) sums;
- the distributed backend: ``torch.distributed`` (``nccl`` for CUDA
  tensors, ``gloo`` for CPU ones) across processes, one process per DCN row
  (``multihost``); within a process the shards of one device run in one
  launch of a kernel's batch form;
- the challenges: every process runs the same protocol loop and derives them
  itself, with no broadcast.
"""

from .multihost import (
    DCN_AXIS,
    ICI_AXIS,
    init_distributed,
    make_mesh_2d,
    mesh_axis_spec,
)
from .sharded import (
    AXIS,
    ShardedBlockPoly,
    ShardedProductPoly,
    make_mesh,
    shard_factor,
)

__all__ = [
    "AXIS",
    "DCN_AXIS",
    "ICI_AXIS",
    "ShardedBlockPoly",
    "ShardedProductPoly",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "mesh_axis_spec",
    "shard_factor",
]
