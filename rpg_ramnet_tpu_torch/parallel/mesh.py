"""Device meshes and the batch rules over them.

Counterpart of ``rpg_ramnet_tpu/parallel/mesh.py``.  JAX lays one program
over a ``Mesh`` of devices with a 'data' axis and a 'model' axis and lets
XLA insert the collectives.  The port has three mechanisms instead:

- training runs one process per GPU under ``torch.distributed``
  (``parallel.distributed``): each rank holds whole tensors for its share
  of the batch (``shard_batch``, ``input_pipeline.local_batch``), and the
  gradients, the loss statistics and BN's batch statistics are summed
  over the ranks;
- the lane engines (``eval/inference.py``) run one process over a
  ``Mesh`` of torch devices: one replica of the weights (``replicate``)
  and one lane state per device of the data axis, each stepping its share
  of the lanes;
- single-stream inference over a mesh whose model axis is above 1
  (``parallel.spatial``): H split into row bands over the model axis, one
  replica per band, the convolutions' halos copied between the bands.

Either way a kernel sees whole tensors of its rank's or device's share
(a band with its halo), so the kernels stay on, where JAX's ``auto``
gates turn the Pallas cells off under a mesh (ROADMAP queue 3).  On the
CPU a mesh of N devices is N replicas on the one CPU device, as JAX's
virtual CPU devices are.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"

# keys stored time-leading (JAX's packed training batches and chunked
# lane buffers): the batch/lane dim is axis 1 there
TIME_LEADING_KEYS = ("events_tcf", "image_tcf", "depth_events_t",
                     "depth_image_t", "times_events_t", "times_image_t",
                     "reset_t")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Torch devices laid out [data][model].  A device may appear more
    than once (the CPU mesh, or a caller that puts two replicas on one
    card on purpose)."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices),
                MODEL_AXIS: len(self.devices[0]) if self.devices else 0}

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The devices along the data axis (a mesh whose model axis is 1)."""
        return tuple(row[0] for row in self.devices)


def _all_cuda_devices() -> List[torch.device]:
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass the mesh's devices "
                           "explicitly (a CPU mesh names torch.device('cpu') "
                           "once per replica)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A [data, model] mesh over ``devices`` (every CUDA device when None),
    JAX's rule: data == -1 takes all the devices there are over model."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _all_cuda_devices())]
    model = cfg.model if cfg else 1
    data = cfg.data if cfg else -1
    if data == -1:
        if len(devices) % model:
            raise ValueError(f"{len(devices)} devices do not divide over a "
                             f"model axis of {model}")
        data = len(devices) // model
    if data * model > len(devices):
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"devices, {len(devices)} given")
    return Mesh(tuple(tuple(devices[i * model:(i + 1) * model])
                      for i in range(data)))


def batch_dim(key: Optional[str]) -> int:
    """The batch dim of a batch entry: 1 for the time-leading keys."""
    return 1 if key in TIME_LEADING_KEYS else 0


def _share(x, index: int, count: int, dim: int):
    n = x.shape[dim]
    if n % count:
        raise ValueError(f"a batch dim of {n} does not divide into {count} "
                         "equal shares")
    size = n // count
    sl = (slice(None),) * dim + (slice(index * size, (index + 1) * size),)
    return x[sl]


def shard_batch(batch, index: int, count: int):
    """The index-th of count equal shares of a host batch (numpy arrays or
    tensors): each entry cut on dim 0, or dim 1 for the time-leading keys
    (JAX ``key_sharding``); a non-dict batch (a tensor, or a list or
    tuple of them) on dim 0."""
    if isinstance(batch, dict):
        return {k: _share(v, index, count, batch_dim(k))
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_share(v, index, count, 0) for v in batch)
    return _share(batch, index, count, 0)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies over a mesh's data axis: cut on ``dim`` into one
    share per device, or whole on every device (dim None)."""
    mesh: Mesh
    dim: Optional[int] = 0

    def put(self, x) -> List[Any]:
        """x's share (or x) on each data device, in device order."""
        x = torch.as_tensor(x)
        devs = self.mesh.data_devices
        return [(x if self.dim is None else _share(x, i, len(devs), self.dim)
                 ).to(d, non_blocking=True) for i, d in enumerate(devs)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) dim over the data axis."""
    return Sharding(mesh, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def replicate(module: torch.nn.Module, mesh: Mesh) -> List:
    """One copy of ``module`` (weights, buffers, mode) on each device of
    ``mesh``: for a model axis of 1 a list in data-device order, else one
    list per data row in model-axis order (the row bands of
    ``parallel.spatial``).  Ordinary tensors even when called under
    inference_mode (the kernels' weight folds read their version
    counters)."""
    with torch.inference_mode(False):
        if mesh.shape[MODEL_AXIS] == 1:
            return [copy.deepcopy(module).to(d) for d in mesh.data_devices]
        return [[copy.deepcopy(module).to(d) for d in row]
                for row in mesh.devices]
