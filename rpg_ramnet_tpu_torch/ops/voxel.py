"""Event streams -> voxel grids, on the host (numpy) and on the device.

Counterpart of ``rpg_ramnet_tpu/ops/voxel.py``: the bilinear-in-time
voxelizer of the reference (dataset_asynchronous.py:253-298; event rows
(timestamp, x, y, polarity), polarity 0 counts as -1) and the nonzero
mean/std normalization the voxel dataset applies (event_dataset.py:
144-151).

Device entry point ``events_to_voxel_grid(events, n_valid, num_bins,
height, width, backend)`` with the JAX package's backend names:

    'sortseg'  kernel K6 (csrc/voxel.cu): the grid by one atomic add per
               contribution into the zeroed grid (one-pass path), or,
               for batches of windows whose grids exceed L2, accumulated
               tile by tile in shared memory and written once (tiled
               path); optionally the nonzero (count, sum, sum of
               squares); plain version ``events_to_voxel_grid_scatter``
    'pallas'   kernel K7: the same kernel, the values optionally rounded
               to bf16 first (bfloat16 factors); plain version
               ``events_to_voxel_grid_matmul``, the one-hot product
    'scatter'  ``index_add_`` on the flat grid (plain PyTorch)
    'matmul'   the one-hot product per chunk of 512 (plain PyTorch)
    'auto'     'sortseg' for a CUDA tensor, 'scatter' for a CPU tensor, as
               the JAX package picks the kernel on the TPU only

Events are [N, 4] float32, zero-padded past ``n_valid``; rows at or past
n_valid add nothing.  Every backend also takes a batch of windows [B, N,
4] with counts [B] and gives [B, num_bins, H, W] (the kernels in one
launch sequence, as the JAX package vmaps K7 over a training batch's
windows in data/raw_pipeline.py::voxelize_batch).  The wrappers of K6 and
K7 run their plain versions for CPU tensors; on a CUDA tensor they launch
or raise.  ``<wrapper>.launches`` counts the kernel's launch sequences,
``<wrapper>.path_launches`` them by path.
Every device path drops a contribution outside the grid (an x or y
outside the image, or an event more than a bin before the window's first
timestamp) where the JAX and numpy versions would wrap a negative index
around the grid; a time-sorted event stream has none.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

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


def _contributions(events: torch.Tensor, n_valid, num_bins: int,
                   height: int, width: int):
    """The two bilinear contributions of every event of events [..., N, 4]:
    flat indices within each window's grid [..., 2N] int64, values [..., 2N]
    float32 and a mask [..., 2N] of those that land in the grid (left
    contributions first).  n_valid: an int for one window, or counts of
    the leading shape (clamped to [0, N]).  The time split in float32 in
    the JAX package's order: ts = (num_bins - 1) * (t - first) / dt with
    first = t[0], last = t[n_valid - 1] and dt = 1 when they are equal."""
    n = events.shape[-2]
    if n == 0:
        empty = events.new_zeros(events.shape[:-2] + (0,))
        return empty.long(), empty, empty.bool()
    t = events[..., 0]
    if isinstance(n_valid, int):
        last = t[..., max(n_valid - 1, 0)]
    else:
        n_valid = n_valid.clamp(0, n)
        last = t.gather(-1, (n_valid - 1).clamp(min=0).long()[..., None])[..., 0]
    dt = last - t[..., 0]
    dt = torch.where(dt == 0, torch.ones_like(dt), dt)
    ts = (num_bins - 1) * (t - t[..., :1]) / dt[..., None]
    tis = ts.to(torch.int32)                      # truncation toward zero
    dts = ts - tis
    xs, ys = events[..., 1].to(torch.int64), events[..., 2].to(torch.int64)
    pol = torch.where(events[..., 3] == 0, -1.0, events[..., 3])
    valid = torch.arange(n, device=events.device) < (
        n_valid if isinstance(n_valid, int) else n_valid[..., None])
    ok = (valid & (tis >= 0) & (xs >= 0) & (xs < width) & (ys >= 0)
          & (ys < height))
    left = tis.to(torch.int64) * (height * width) + ys * width + xs
    idx = torch.cat([left, left + height * width], -1)
    vals = torch.cat([pol * (1.0 - dts), pol * dts], -1)
    ok = torch.cat([ok & (tis < num_bins), ok & (tis + 1 < num_bins)], -1)
    return idx, vals, ok


def _prepare(events, n_valid):
    """(events float32 [N, 4] or [B, N, 4], n_valid): an int in [0, N] for
    one window; for a batch None (every row valid) or int32 counts [B] on
    the events' device, not yet clamped."""
    events = torch.as_tensor(events)
    if events.dim() not in (2, 3) or events.shape[-1] != 4:
        raise ValueError(f"events must be [N, 4] or [B, N, 4], got "
                         f"{tuple(events.shape)}")
    events = events.float()
    if events.dim() == 2:
        return events, _n_valid(events, n_valid)
    if n_valid is None:
        return events, None
    counts = torch.as_tensor(n_valid).to(events.device, torch.int32)
    if counts.shape != events.shape[:1]:
        raise ValueError(f"n_valid must be [{events.shape[0]}] counts for "
                         f"events {tuple(events.shape)}, got "
                         f"{tuple(counts.shape)}")
    return events, counts


def _window_counts(events: torch.Tensor, n_valid):
    """A batch's counts as a tensor: every row where n_valid is None."""
    if n_valid is None:
        return torch.full(events.shape[:1], events.shape[1], dtype=torch.int32,
                          device=events.device)
    return n_valid


def events_to_voxel_grid_scatter(events, n_valid=None, *, num_bins: int,
                                 height: int, width: int) -> torch.Tensor:
    """[num_bins, height, width] float32 by ``index_add_`` of the masked
    contributions into the zeroed flat grid (the JAX ``.at[].add``); for a
    batch of windows [B, N, 4] with counts [B], [B, num_bins, height,
    width] by one ``index_add_`` with window offsets."""
    events, n_valid = _prepare(events, n_valid)
    cells = num_bins * height * width
    if events.dim() == 3:
        n_valid = _window_counts(events, n_valid)
    idx, vals, ok = _contributions(events, n_valid, num_bins, height, width)
    if events.dim() == 3:
        idx = idx + torch.arange(events.shape[0], device=events.device)[:, None] * cells
    grid = torch.zeros(events.shape[:-2] + (cells,), dtype=torch.float32,
                       device=events.device)
    grid.view(-1).index_add_(0, torch.where(ok, idx, 0).reshape(-1),
                             torch.where(ok, vals, 0.0).reshape(-1))
    return grid.reshape(events.shape[:-2] + (num_bins, height, width))


def events_to_voxel_grid_matmul(events, n_valid=None, *, num_bins: int,
                                height: int, width: int, chunk: int = 512,
                                factor_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """The dense formulation: per chunk of ``chunk`` contributions,
    one-hot(rows)^T @ (vals * one-hot(cols)) accumulated into the
    [num_bins*height, width] grid (rows = bin*height + y, cols = x).
    factor_dtype=bfloat16 rounds the values to bf16 first, as K7 does.  A
    batch of windows [B, N, 4] with counts [B] is a loop over them."""
    events, n_valid = _prepare(events, n_valid)
    if events.dim() == 3:
        counts = _window_counts(events, n_valid).tolist()
        return torch.stack([events_to_voxel_grid_matmul(
            e, n, num_bins=num_bins, height=height, width=width, chunk=chunk,
            factor_dtype=factor_dtype) for e, n in zip(events, counts)])
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
    """(count, sum, sum of squares) of the nonzero cells of grid [...,
    num_bins, H, W], float32, one per window."""
    mask = grid != 0
    dims = (-3, -2, -1)
    return (mask.sum(dims).float(), torch.where(mask, grid, 0.0).sum(dims),
            torch.where(mask, grid * grid, 0.0).sum(dims))


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

# The kernels' two paths (csrc/voxel.cu), picked there by the launch's
# size unless the caller names one: 'one_pass' (a memset, then one atomic
# add per contribution into the grid in L2) and 'tiled' (a bucket launch,
# then one block per tile of one bin plane x a band of rows accumulating
# in shared memory, the grid written once).  A band holds at most
# TILE_BYTES (several blocks per SM), and fewer rows where a launch would
# otherwise have fewer than TILE_BLOCKS tiles (four per SM of the H100's
# 132), so that one window of 1M events still spreads over the card.
PATHS = {"one_pass": 1, "tiled": 2}
TILE_BYTES = 12 * 1024
TILE_BLOCKS = 4 * 132
SMEM_BYTES = 232_448          # shared memory a block may use on the H100


@dataclasses.dataclass(frozen=True)
class TilePlan:
    rows: int         # rows per band; the last band may be shorter
    bands: int        # bands per bin plane
    tiles: int        # tiles per window: num_bins * bands
    tile_bytes: int   # the shared-memory tile: rows * width float32


def tile_plan(num_bins: int, height: int, width: int,
              windows: int = 1) -> TilePlan:
    """The band tiles of a [num_bins, height, width] grid for a launch over
    ``windows`` windows: as many rows as fit in TILE_BYTES, fewer where
    the launch would have fewer than TILE_BLOCKS tiles, one at least;
    raises if one row does not fit in a block's shared memory."""
    row_bytes = 4 * width
    if num_bins < 1 or height < 1 or width < 1 or row_bytes > SMEM_BYTES:
        raise ValueError(f"no tile plan for a {num_bins}x{height}x{width} grid")
    rows = max(1, min(height, TILE_BYTES // row_bytes,
                      windows * num_bins * height // TILE_BLOCKS))
    bands = -(-height // rows)
    return TilePlan(rows, bands, num_bins * bands, rows * row_bytes)


@functools.lru_cache(maxsize=64)
def _launch_plan(windows: int, n: int, num_bins: int, height: int, width: int,
                 path=None):
    """(path, rows per band, scratch bytes) of one launch sequence over
    ``windows`` windows of n event rows, the path picked by the kernel's
    size rule unless named; raises where the kernels cannot take it."""
    lib = library()
    code = lib.ramnet_voxel_path(PATHS[path] if path else 0, windows,
                                 num_bins, height, width)
    path = next(p for p, c in PATHS.items() if c == code)
    rows = tile_plan(num_bins, height, width, windows).rows if path == "tiled" else 0
    scratch = lib.ramnet_voxel_scratch_bytes(code, windows, n, num_bins,
                                             height, width, rows)
    if scratch < 0:
        raise ValueError(f"{windows} windows of {n} events into a {num_bins}x"
                         f"{height}x{width} grid are beyond the {path} kernels")
    return path, rows, scratch


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ramnet_voxel_path": (_I, (_I, _I, _I, _I, _I)),
    "ramnet_voxel_scratch_bytes": (ctypes.c_longlong, (_I,) * 7),
    "ramnet_voxel_grid": (_I, (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P)),
    "ramnet_cuda_error_string": (ctypes.c_char_p, (_I,)),
}
SOURCES = ("voxel",)   # csrc/<name>.cu


@functools.cache
def library():
    """The built and loaded K6/K7 library (nvcc on first use), kept."""
    from .. import kernels
    return kernels.library("voxel", _SIGNATURES)


def _check_path(path):
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be None or one of {sorted(PATHS)}, got {path!r}")


def _launch(wrapper, events: torch.Tensor, n_valid, num_bins: int,
            height: int, width: int, bf16: bool, with_stats: bool, path):
    """The kernel on a CUDA tensor, on its device (entered only if it is
    not the current one): (grid [B, num_bins, H, W], stats [B, 3] or
    None) for events [B, N, 4] (n_valid: None or counts [B]) or [N, 4]
    (n_valid: an int, B = 1); a launch adds one to wrapper.launches and
    to wrapper.path_launches of its path."""
    if events.device.type != "cuda":
        raise ValueError(f"no implementation for device {events.device}")
    if events.device.index != torch.cuda.current_device():
        with torch.cuda.device(events.device):
            return _launch(wrapper, events, n_valid, num_bins, height, width,
                           bf16, with_stats, path)
    events = events.contiguous()
    if events.data_ptr() % 16:
        raise ValueError("events must be 16-byte aligned")
    B, N = events.shape[:2] if events.dim() == 3 else (1, events.shape[0])
    counts = n_valid if isinstance(n_valid, torch.Tensor) else None
    n_all = N if n_valid is None or counts is not None else n_valid
    dev = events.device
    if N == 0 or n_all == 0:     # nothing to add: no launch
        grid = torch.zeros(B, num_bins, height, width, device=dev)
        return grid, torch.zeros(B, 3, device=dev) if with_stats else None
    path, rows, scratch_bytes = _launch_plan(B, N, num_bins, height, width,
                                             path)
    grid = torch.empty(B, num_bins, height, width, device=dev)
    stats = torch.empty(B, 3, device=dev) if with_stats else None
    scratch = (torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
               if scratch_bytes else None)
    lib = library()
    err = lib.ramnet_voxel_grid(
        events.data_ptr(), None if counts is None else counts.data_ptr(), n_all,
        B, N, num_bins, height, width, PATHS[path], rows, int(bf16), grid.data_ptr(),
        None if stats is None else stats.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("voxel grid kernel launch failed: "
                           + lib.ramnet_cuda_error_string(err).decode())
    wrapper.launches += 1
    wrapper.path_launches[path] += 1
    return grid, stats


def events_to_voxel_grid_sortseg(events, n_valid=None, *, num_bins: int,
                                 height: int, width: int,
                                 with_stats: bool = False, path=None):
    """K6 for a CUDA tensor, ``events_to_voxel_grid_scatter`` for a CPU
    tensor: the grid, and with_stats also (count, sum, sum of squares) of
    its nonzero cells.  events [N, 4] with n_valid an int, or a batch of
    windows [B, N, 4] with counts [B] (None: every row), then grids [B,
    num_bins, H, W] and stats of shape [B], in one launch sequence.
    path: None (the kernel's size rule), 'one_pass' or 'tiled'.  No
    sort: the TPU kernel sorts only because the TPU lacks a fast scatter
    (rpg_ramnet_tpu/ops/voxel.py:287-300)."""
    _check_path(path)
    events, n_valid = _prepare(events, n_valid)
    if events.device.type == "cpu":
        grid = events_to_voxel_grid_scatter(events, n_valid, num_bins=num_bins,
                                            height=height, width=width)
        return (grid, voxel_stats(grid)) if with_stats else grid
    grid, stats = _launch(events_to_voxel_grid_sortseg, events, n_valid,
                          num_bins, height, width, False, with_stats, path)
    if events.dim() == 2:
        grid, stats = grid[0], None if stats is None else stats[0]
    return (grid, tuple(stats.unbind(-1))) if with_stats else grid


def events_to_voxel_grid_pallas(events, n_valid=None, *, num_bins: int,
                                height: int, width: int,
                                factor_dtype: torch.dtype = torch.float32,
                                path=None) -> torch.Tensor:
    """K7 for a CUDA tensor, ``events_to_voxel_grid_matmul`` for a CPU
    tensor: K6's grid (float32 factors) or the grid of the values rounded
    to bf16 first (bfloat16 factors), for one window or a batch, on a path,
    as K6."""
    _check_path(path)
    if factor_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"factor_dtype must be float32 or bfloat16, got "
                         f"{factor_dtype}")
    events, n_valid = _prepare(events, n_valid)
    if events.device.type == "cpu":
        return events_to_voxel_grid_matmul(
            events, n_valid, num_bins=num_bins, height=height, width=width,
            factor_dtype=factor_dtype)
    grid, _ = _launch(events_to_voxel_grid_pallas, events, n_valid, num_bins,
                      height, width, factor_dtype == torch.bfloat16, False, path)
    return grid if events.dim() == 3 else grid[0]


for _wrapper in (events_to_voxel_grid_sortseg, events_to_voxel_grid_pallas):
    _wrapper.launches = 0
    _wrapper.path_launches = dict.fromkeys(PATHS, 0)
del _wrapper

_BACKENDS = {"sortseg": events_to_voxel_grid_sortseg,
             "pallas": events_to_voxel_grid_pallas,
             "matmul": events_to_voxel_grid_matmul,
             "scatter": events_to_voxel_grid_scatter}


def events_to_voxel_grid(events, n_valid=None, *, num_bins: int, height: int,
                         width: int, backend: str = "auto") -> torch.Tensor:
    """The voxelizer entry point: [num_bins, height, width] float32 on the
    events' device (a numpy input is taken as a CPU tensor); a batch of
    windows [B, N, 4] with counts [B] gives [B, num_bins, height, width]."""
    events = torch.as_tensor(events)
    if backend == "auto":
        backend = "sortseg" if events.is_cuda else "scatter"
    return _BACKENDS[backend](events, n_valid, num_bins=num_bins,
                              height=height, width=width)
