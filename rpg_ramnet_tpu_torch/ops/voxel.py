"""Event voxel grids on the host (numpy).

Counterpart of the numpy functions of ``rpg_ramnet_tpu/ops/voxel.py``: the
bilinear-in-time voxelizer of the reference (dataset_asynchronous.py:
253-298), which the synthetic data writer uses, and the nonzero mean/std
normalization the voxel dataset applies (event_dataset.py:144-151).  The
device voxelizers (kernels K6, K7) are not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import numpy as np


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
