"""Data-parallel training over ``torch.distributed``: one process per GPU.

Torch's side of ``jax.distributed`` plus the collectives XLA inserts under
JAX's data-parallel mesh.  ``torchrun --nproc_per_node N -m
rpg_ramnet_tpu_torch.train -c cfg.json`` starts N ranks; each calls
``init_from_env`` (NCCL on CUDA, gloo on the CPU, or the backend it is
given: gloo also takes CUDA tensors, so two ranks can share one card,
which NCCL refuses).  Each rank trains on its share of every global batch
(``input_pipeline.local_batch``) and the results are those of the global
batch, as JAX's GSPMD step computes them:

- the loss statistics (``train/losses.py``: every NaN-masked sum and
  count) and BN's training statistics (``models/layers.py::Norm``) are
  summed over the ranks inside ``sync_ranks()`` by ``global_sum``, an
  all-reduce whose backward all-reduces the cotangents.  Every rank then
  holds the global loss, and its gradients are ``world`` times its share
  of the global gradient (each rank's identical cotangent is summed once
  per rank);
- ``all_reduce_grads`` averages the gradients over the ranks in one flat
  bucket after the window's last backward, which makes them the global
  batch's gradient.

With one rank, or no process group, every function here leaves the
tensors as they are (``all_reduce_grads`` still runs its collective when
a group is up, a copy for one rank).  No fallback: asking for NCCL
without a GPU raises.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

_sync_depth = 0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_main() -> bool:
    return rank() == 0


def launched() -> bool:
    """Whether torchrun (or an equivalent environment) started this
    process as one rank of a world."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_from_env(backend: Optional[str] = None) -> None:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT).  backend None: 'nccl' where
    CUDA is available, else 'gloo'; 'nccl' without a GPU raises.  With
    NCCL the current device becomes cuda:LOCAL_RANK."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA device; "
                               "pass backend='gloo' for CPU ranks")
        torch.cuda.set_device(local_rank())
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(f"{', '.join(missing)} not set: start the ranks "
                           "with torchrun")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=600), **kw)


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def sync_ranks():
    """Within it (the train and eval steps' losses and backward), the
    loss statistics and BN's batch statistics are summed over the ranks.
    A process-wide switch: the backward's checkpoint recompute, which runs
    on autograd's device thread, must see it too."""
    global _sync_depth
    _sync_depth += 1
    try:
        yield
    finally:
        _sync_depth -= 1


def syncing() -> bool:
    """Inside ``sync_ranks`` with a process group of more than one rank."""
    return _sync_depth > 0 and world() > 1


def group_size() -> int:
    """The number of ranks a global statistic spans: world() while
    syncing, else 1."""
    return world() if syncing() else 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents over the ranks
    (every rank's loss is the global one, so each rank's parameters get
    ``world`` times their share of the global gradient)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks while ``syncing()``, else x."""
    return _AllReduceSum.apply(x) if syncing() else x


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the .grad of ``params`` over the ranks, in one flat bucket
    per dtype (a collective whenever a process group is up)."""
    if not is_initialized():
        return
    n = world()
    for flat, grads in _buckets([p.grad for p in params if p.grad is not None]):
        dist.all_reduce(flat)
        if n > 1:
            flat.div_(n)
        _unflatten(flat, grads)


def _buckets(tensors):
    """(flat, tensors) per dtype: the tensors' values in one flat tensor
    (channels_last ones in logical order)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [(torch.cat([t.reshape(-1) for t in ts]), ts)
            for ts in by_dtype.values()]


def _unflatten(flat: torch.Tensor, tensors) -> None:
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank src's."""
    if not is_initialized():
        return
    with torch.no_grad():
        for flat, ts in _buckets(list(module.parameters())
                                 + list(module.buffers())):
            dist.broadcast(flat, src)
            _unflatten(flat, ts)


def barrier() -> None:
    if is_initialized():
        dist.barrier()
