"""Event streams -> voxel grids, on the host (numpy) and on the device.

Counterpart of ``rpg_ramnet_tpu/ops/voxel.py``: the bilinear-in-time
voxelizer of the reference (dataset_asynchronous.py:253-298; event rows
(timestamp, x, y, polarity), polarity 0 counts as -1) and the nonzero
mean/std normalization the voxel dataset applies (event_dataset.py:
144-151).

Device entry point ``events_to_voxel_grid(events, n_valid, num_bins,
height, width, backend)`` with the JAX package's backend names:

    'sortseg'  kernel K6 (csrc/voxel.cu): one atomicAdd per bilinear
               contribution into the zeroed grid, and optionally the
               nonzero (count, sum, sum of squares); plain version
               ``events_to_voxel_grid_scatter``
    'pallas'   kernel K7 (csrc/voxel.cu): one-hot(rows)^T . (vals *
               one-hot(cols)) per chunk of events on the tensor cores;
               plain version ``events_to_voxel_grid_matmul``
    'scatter'  ``index_add_`` on the flat grid (plain PyTorch)
    'matmul'   the one-hot product per chunk of 512 (plain PyTorch)
    'auto'     'sortseg' for a CUDA tensor, 'scatter' for a CPU tensor, as
               the JAX package picks the kernel on the TPU only

Events are [N, 4] float32, zero-padded past ``n_valid``; rows at or past
n_valid add nothing.  The wrappers of K6 and K7 run their plain versions
for CPU tensors; on a CUDA tensor they launch or raise.
``<wrapper>.launches`` counts the kernel's launches.  Every device path
drops a contribution outside the grid (an x or y outside the image, or an
event more than a bin before the window's first timestamp) where the
JAX and numpy versions would wrap a negative index around the grid; a
time-sorted event stream has none.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def events_to_voxel_grid_np(events: np.ndarray, num_bins: int, height: int,
                            width: int) -> np.ndarray:
    """events: [N, 4] rows (timestamp, x, y, polarity) -> [num_bins,
    height, width] float32; polarity 0 counts as -1."""
    assert events.ndim == 2 and events.shape[1] == 4
    grid = np.zeros(num_bins * height * width, np.float32)
    if events.shape[0] == 0:
        return grid.reshape(num_bins, height, width)
    t = events[:, 0].astype(np.float64)
    dt = t[-1] - t[0]
    if dt == 0:
        dt = 1.0
    ts = ((num_bins - 1) * (t - t[0]) / dt).astype(np.float32)
    xs = events[:, 1].astype(np.int64)
    ys = events[:, 2].astype(np.int64)
    pol = np.where(events[:, 3] == 0, -1.0, events[:, 3]).astype(np.float32)
    tis = ts.astype(np.int64)
    dts = ts - tis
    base = xs + ys * width
    idx = np.concatenate([base + tis * width * height,
                          base + (tis + 1) * width * height])
    val = np.concatenate([pol * (1.0 - dts), pol * dts])
    ok = np.concatenate([tis < num_bins, (tis + 1) < num_bins])
    np.add.at(grid, idx[ok], val[ok])
    return grid.reshape(num_bins, height, width)


def normalize_voxel_grid_np(grid: np.ndarray) -> np.ndarray:
    """Nonzero mean/std normalization (event_dataset.py:144-151)."""
    mask = grid != 0
    if mask.sum() > 0:
        vals = grid[mask]
        mean, std = vals.mean(), vals.std()
        if std > 0:
            out = grid.copy()
            out[mask] = (vals - mean) / std
            return out
    return grid


# -- device: plain versions ---------------------------------------------------


def _n_valid(events: torch.Tensor, n_valid) -> int:
    n = events.shape[0]
    return n if n_valid is None else min(max(int(n_valid), 0), n)


def _contributions(events: torch.Tensor, n_valid: int, num_bins: int,
                   height: int, width: int):
    """The two bilinear contributions of every event: flat grid indices
    [2N] int64, values [2N] float32 and a mask [2N] of those that land in
    the grid (left contributions first).  The time split in float32 in the
    JAX package's order: ts = (num_bins - 1) * (t - first) / dt with
    first = t[0], last = t[n_valid - 1] and dt = 1 when they are equal."""
    n = events.shape[0]
    if n == 0:
        empty = events.new_zeros(0)
        return empty.long(), empty, empty.bool()
    t = events[:, 0]
    dt = t[max(n_valid - 1, 0)] - t[0]
    dt = torch.where(dt == 0, torch.ones_like(dt), dt)
    ts = (num_bins - 1) * (t - t[0]) / dt
    tis = ts.to(torch.int32)                      # truncation toward zero
    dts = ts - tis
    xs, ys = events[:, 1].to(torch.int64), events[:, 2].to(torch.int64)
    pol = torch.where(events[:, 3] == 0, -1.0, events[:, 3])
    ok = ((torch.arange(n, device=events.device) < n_valid) & (tis >= 0)
          & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height))
    left = tis.to(torch.int64) * (height * width) + ys * width + xs
    idx = torch.cat([left, left + height * width])
    vals = torch.cat([pol * (1.0 - dts), pol * dts])
    ok = torch.cat([ok & (tis < num_bins), ok & (tis + 1 < num_bins)])
    return idx, vals, ok


def _prepare(events, n_valid):
    events = torch.as_tensor(events)
    if events.dim() != 2 or events.shape[1] != 4:
        raise ValueError(f"events must be [N, 4], got {tuple(events.shape)}")
    return events.float(), _n_valid(events, n_valid)


def events_to_voxel_grid_scatter(events, n_valid=None, *, num_bins: int,
                                 height: int, width: int) -> torch.Tensor:
    """[num_bins, height, width] float32 by ``index_add_`` of the masked
    contributions into the zeroed flat grid (the JAX ``.at[].add``)."""
    events, n_valid = _prepare(events, n_valid)
    idx, vals, ok = _contributions(events, n_valid, num_bins, height, width)
    grid = torch.zeros(num_bins * height * width, dtype=torch.float32,
                       device=events.device)
    grid.index_add_(0, torch.where(ok, idx, 0), torch.where(ok, vals, 0.0))
    return grid.reshape(num_bins, height, width)


def events_to_voxel_grid_matmul(events, n_valid=None, *, num_bins: int,
                                height: int, width: int, chunk: int = 512,
                                factor_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """The dense formulation: per chunk of ``chunk`` contributions,
    one-hot(rows)^T @ (vals * one-hot(cols)) accumulated into the
    [num_bins*height, width] grid (rows = bin*height + y, cols = x).
    factor_dtype=bfloat16 rounds the values to bf16 first, as K7 does."""
    events, n_valid = _prepare(events, n_valid)
    idx, vals, ok = _contributions(events, n_valid, num_bins, height, width)
    idx = torch.where(ok, idx, 0)
    vals = torch.where(ok, vals, 0.0).to(factor_dtype).float()
    rows, cols = idx // width, idx % width
    acc = torch.zeros(num_bins * height, width, dtype=torch.float32,
                      device=events.device)
    for s in range(0, idx.shape[0], chunk):
        oh_rows = F.one_hot(rows[s:s + chunk], num_bins * height).float()
        p = vals[s:s + chunk, None] * F.one_hot(cols[s:s + chunk], width).float()
        acc += oh_rows.T @ p
    return acc.reshape(num_bins, height, width)


def voxel_stats(grid: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(count, sum, sum of squares) of the nonzero cells, float32."""
    mask = grid != 0
    return (mask.sum().float(), torch.where(mask, grid, 0.0).sum(),
            torch.where(mask, grid * grid, 0.0).sum())


def normalize_voxel_grid(grid: torch.Tensor, stats=None) -> torch.Tensor:
    """Nonzero mean/std normalization as a masked reduction
    (event_dataset.py:144-151 semantics, the JAX package's formula).
    stats: (count, sum, sum of squares) as K6 returns them with
    with_stats, which skips the reduction."""
    n, s, s2 = voxel_stats(grid) if stats is None else stats
    n1 = torch.clamp(n, min=1)
    mean = s / n1
    std = torch.sqrt(torch.clamp(s2 / n1 - mean * mean, min=0.0))
    ok = (n > 0) & (std > 0)
    normed = torch.where(grid != 0,
                         (grid - mean) / torch.where(ok, std, 1.0), grid)
    return torch.where(ok, normed, grid)


# -- device: the kernels --------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ramnet_voxel_scatter": (_I, (_P, _I, _I, _I, _I, _P, _P, _P)),
    "ramnet_voxel_onehot": (_I, (_P, _I, _I, _I, _I, _I, _P, _P)),
    "ramnet_cuda_error_string": (ctypes.c_char_p, (_I,)),
}
SOURCES = ("voxel",)   # csrc/<name>.cu


def library():
    """The built and loaded K6/K7 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("voxel", _SIGNATURES)


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ramnet_cuda_error_string(err).decode())


def _device_events(events: torch.Tensor) -> torch.Tensor:
    events = events.contiguous()
    if events.data_ptr() % 16:
        raise ValueError("events must be 16-byte aligned")
    return events


def events_to_voxel_grid_sortseg(events, n_valid=None, *, num_bins: int,
                                 height: int, width: int,
                                 with_stats: bool = False):
    """K6 for a CUDA tensor, ``events_to_voxel_grid_scatter`` for a CPU
    tensor: the grid, and with_stats also (count, sum, sum of squares) of
    its nonzero cells.  No sort: the TPU kernel sorts only because the TPU
    lacks a fast scatter (rpg_ramnet_tpu/ops/voxel.py:287-300)."""
    events, n_valid = _prepare(events, n_valid)
    if events.device.type == "cpu":
        grid = events_to_voxel_grid_scatter(events, n_valid, num_bins=num_bins,
                                            height=height, width=width)
        return (grid, voxel_stats(grid)) if with_stats else grid
    if events.device.type != "cuda":
        raise ValueError(f"no implementation for device {events.device}")
    with torch.cuda.device(events.device):
        events = _device_events(events)
        grid = torch.zeros(num_bins, height, width, dtype=torch.float32,
                           device=events.device)
        stats = torch.zeros(3, dtype=torch.float32, device=events.device)
        if n_valid == 0:     # nothing to add: no launch
            return (grid, tuple(stats.unbind())) if with_stats else grid
        lib = library()
        err = lib.ramnet_voxel_scatter(
            events.data_ptr(), n_valid, num_bins, height, width,
            grid.data_ptr(), stats.data_ptr() if with_stats else None,
            torch.cuda.current_stream(events.device).cuda_stream)
        _raise_on(err, lib, "voxel_scatter")
        events_to_voxel_grid_sortseg.launches += 1
    return (grid, tuple(stats.unbind())) if with_stats else grid


def events_to_voxel_grid_pallas(events, n_valid=None, *, num_bins: int,
                                height: int, width: int,
                                factor_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """K7 for a CUDA tensor, ``events_to_voxel_grid_matmul`` for a CPU
    tensor.  factor_dtype=float32 splits each value into two bf16 parts
    (hi + lo) so the sum stays float32-accurate; bfloat16 takes hi only."""
    if factor_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"factor_dtype must be float32 or bfloat16, got "
                         f"{factor_dtype}")
    events, n_valid = _prepare(events, n_valid)
    if events.device.type == "cpu":
        return events_to_voxel_grid_matmul(
            events, n_valid, num_bins=num_bins, height=height, width=width,
            factor_dtype=factor_dtype)
    if events.device.type != "cuda":
        raise ValueError(f"no implementation for device {events.device}")
    with torch.cuda.device(events.device):
        events = _device_events(events)
        grid = torch.zeros(num_bins, height, width, dtype=torch.float32,
                           device=events.device)
        if n_valid == 0:     # nothing to add: no launch
            return grid
        lib = library()
        err = lib.ramnet_voxel_onehot(
            events.data_ptr(), n_valid, num_bins, height, width,
            int(factor_dtype == torch.float32), grid.data_ptr(),
            torch.cuda.current_stream(events.device).cuda_stream)
        _raise_on(err, lib, "voxel_onehot")
        events_to_voxel_grid_pallas.launches += 1
    return grid


events_to_voxel_grid_sortseg.launches = 0
events_to_voxel_grid_pallas.launches = 0

_BACKENDS = {"sortseg": events_to_voxel_grid_sortseg,
             "pallas": events_to_voxel_grid_pallas,
             "matmul": events_to_voxel_grid_matmul,
             "scatter": events_to_voxel_grid_scatter}


def events_to_voxel_grid(events, n_valid=None, *, num_bins: int, height: int,
                         width: int, backend: str = "auto") -> torch.Tensor:
    """The voxelizer entry point: [num_bins, height, width] float32 on the
    events' device (a numpy input is taken as a CPU tensor)."""
    events = torch.as_tensor(events)
    if backend == "auto":
        backend = "sortseg" if events.is_cuda else "scatter"
    return _BACKENDS[backend](events, n_valid, num_bins=num_bins,
                              height=height, width=width)
