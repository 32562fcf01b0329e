"""Parallelism: data-parallel training over ``torch.distributed`` and lanes
over a device mesh (counterpart of ``rpg_ramnet_tpu/parallel``, less its
spatial partitioning: ROADMAP queue 1, item 15)."""
from .mesh import (make_mesh, batch_sharding, replicated, shard_batch,
                   replicate, DATA_AXIS, MODEL_AXIS, Mesh, TIME_LEADING_KEYS)
from .input_pipeline import (shard_sequence_folders, per_host_batch_size,
                             make_global_batch, sharded_prefetch, local_batch)
from . import distributed

__all__ = [
    "make_mesh", "batch_sharding", "replicated", "shard_batch", "replicate",
    "DATA_AXIS", "MODEL_AXIS",
    "shard_sequence_folders", "per_host_batch_size", "make_global_batch",
    "sharded_prefetch",
]
