"""Per-rank input sharding.

Counterpart of ``rpg_ramnet_tpu/parallel/input_pipeline.py``.  JAX's
processes each load a share and assemble one global array over the mesh;
in the port each rank keeps its share (``local_batch``) and the global
batch exists only through the collectives of ``parallel.distributed``.
Under ``trainer.grad_accum n`` JAX cuts the global batch into n
contiguous micro-batches and shards each over the data axis
(train_step.py:49-56), so a rank's items are the rank's share of each
micro-batch, interleaved; the port's train step then cuts the rank's
batch into n contiguous micro-batches, which are those shares.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import distributed
from .mesh import batch_dim


def shard_sequence_folders(folders: Sequence[str],
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None) -> List[str]:
    """Round-robin split of the sorted sequence folders over the ranks
    (the process group's rank and world by default)."""
    pi = distributed.rank() if process_index is None else process_index
    pc = distributed.world() if process_count is None else process_count
    return [f for i, f in enumerate(sorted(folders)) if i % pc == pi]


def per_host_batch_size(global_batch: int,
                        process_count: Optional[int] = None) -> int:
    pc = distributed.world() if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"over {pc} ranks")
    return global_batch // pc


def local_indices(n: int, rank: int, world: int,
                  grad_accum: int = 1) -> np.ndarray:
    """The positions in a global batch of n items that rank holds: its
    share of each of the grad_accum contiguous micro-batches, in order."""
    accum = max(int(grad_accum), 1)
    if n % (accum * world):
        raise ValueError(f"a global batch of {n} does not divide into "
                         f"{accum} micro-batches over {world} ranks")
    micro, share = n // accum, n // accum // world
    return np.concatenate([np.arange(i * micro + rank * share,
                                     i * micro + (rank + 1) * share)
                           for i in range(accum)])


def local_batch(global_batch: Dict, rank: int, world: int,
                grad_accum: int = 1) -> Dict:
    """rank's items of a global host batch (numpy arrays or tensors), on
    dim 0 or dim 1 for the time-leading keys (``local_indices``)."""
    out = {}
    for k, v in global_batch.items():
        dim = batch_dim(k)
        idx = local_indices(v.shape[dim], rank, world, grad_accum)
        if grad_accum <= 1:       # contiguous: a view
            out[k] = v[(slice(None),) * dim + (slice(idx[0], idx[-1] + 1),)]
        elif isinstance(v, torch.Tensor):
            out[k] = v.index_select(dim, torch.from_numpy(idx).to(v.device))
        else:
            out[k] = np.take(v, idx, axis=dim)
    return out


def make_global_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch from every rank's local one (``local_batch`` with
    grad_accum 1): the ranks' shares concatenated in rank order, on every
    rank.  Without a process group, the batch itself."""
    n = distributed.world()
    if n == 1:
        return dict(batch)
    import torch.distributed as dist
    out = {}
    for k, v in batch.items():
        parts = [torch.empty_like(v) for _ in range(n)]
        dist.all_gather(parts, v.contiguous())
        out[k] = torch.cat(parts, dim=batch_dim(k))
    return out


def sharded_prefetch(iterator, device: torch.device,
                     rank: Optional[int] = None, world: Optional[int] = None,
                     grad_accum: int = 1, size: int = 2
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    """Global host batches in, this rank's share of each on ``device`` out,
    the next ``size`` staged (``data.device_prefetch``)."""
    from ..data.loader import device_prefetch
    r = distributed.rank() if rank is None else rank
    w = distributed.world() if world is None else world
    return device_prefetch((local_batch(b, r, w, grad_accum) for b in iterator),
                           torch.device(device), size)


Shard = Tuple[int, int, int]


def as_shard(shard) -> Optional[Shard]:
    """(rank, world, grad_accum) from a (rank, world) or (rank, world,
    grad_accum) tuple; None for none."""
    if shard is None:
        return None
    if not (isinstance(shard, (tuple, list)) and len(shard) in (2, 3)):
        raise TypeError(f"a shard is (index, count[, grad_accum]), not "
                        f"{shard!r}")
    r, w, *a = shard
    return int(r), int(w), int(a[0]) if a else 1
