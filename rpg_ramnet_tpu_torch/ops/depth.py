"""Log-depth and gray-level transforms of the host data path (numpy).

Counterpart of the numpy half of ``rpg_ramnet_tpu/ops/depth.py``: the
forward transform of RAM_Net/data_loader/dataset.py:297-305 (clip,
/clip_distance, 1 + log(d)/reg_factor, clip to [0, 1]) and Rec601 luma.
"""
from __future__ import annotations

import numpy as np


def depth_to_log_np(depth: np.ndarray, clip_distance: float,
                    reg_factor: float) -> np.ndarray:
    d = np.clip(depth, 0.0, clip_distance) / clip_distance
    with np.errstate(divide="ignore", invalid="ignore"):
        out = 1.0 + np.log(d) / reg_factor
    return np.clip(out, 0.0, 1.0)


def rgb_to_gray_np(rgb: np.ndarray) -> np.ndarray:
    """Rec601 luma (reference data_loader/dataset.py:235-236)."""
    return np.dot(rgb[..., :3], [0.2989, 0.5870, 0.1140]).astype(np.float32)
