"""Parallel execution layer: device mesh, placement helpers, batch-serving
executor, the tensor-parallel train step (``tp.ShardedTrainer``) and the
multi-process tier (``distributed``); the port of ``microflow_tpu.parallel``
(``batch_spec`` is the JAX package's ``batch_sharding`` as a partition
spec)."""

from .executor import BatchServer
from .mesh import (
    Mesh,
    batch_spec,
    make_mesh,
    mesh_devices,
    replicate_params,
    shard_batch,
    shard_params,
    tp_spec,
)
from ..train.trainer import Collectives
from .tp import ShardedTrainer

__all__ = [
    "BatchServer",
    "Collectives",
    "Mesh",
    "ShardedTrainer",
    "batch_spec",
    "make_mesh",
    "mesh_devices",
    "replicate_params",
    "shard_batch",
    "shard_params",
    "tp_spec",
]
