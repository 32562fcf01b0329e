"""Log-depth and gray-level transforms.

Counterpart of ``rpg_ramnet_tpu/ops/depth.py``: the forward transform of
RAM_Net/data_loader/dataset.py:297-305 (clip, /clip_distance,
1 + log(d)/reg_factor, clip to [0, 1]), its inverse of
RAM_Net/evaluation.py:74-96 (exp(reg*(x-1)) * clip, the prediction
optionally clipped to [exp(-reg)*clip, clip]), both in numpy (the host
data path, evaluation) and on torch tensors, and Rec601 luma.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def depth_to_log_np(depth: np.ndarray, clip_distance: float,
                    reg_factor: float) -> np.ndarray:
    d = np.clip(depth, 0.0, clip_distance) / clip_distance
    with np.errstate(divide="ignore", invalid="ignore"):
        out = 1.0 + np.log(d) / reg_factor
    return np.clip(out, 0.0, 1.0)


def log_to_depth_np(log_depth: np.ndarray, clip_distance: float,
                    reg_factor: float, clip_prediction: bool = False
                    ) -> np.ndarray:
    metric = np.exp(reg_factor * (log_depth - 1.0)) * clip_distance
    if clip_prediction:
        metric = np.clip(metric, np.exp(-reg_factor) * clip_distance,
                         clip_distance)
    return metric


def depth_to_log(depth: torch.Tensor, clip_distance: float,
                 reg_factor: float) -> torch.Tensor:
    d = torch.clamp(depth, 0.0, clip_distance) / clip_distance
    return torch.clamp(1.0 + torch.log(d) / reg_factor, 0.0, 1.0)


def log_to_depth(log_depth: torch.Tensor, clip_distance: float,
                 reg_factor: float, clip_prediction: bool = False
                 ) -> torch.Tensor:
    metric = torch.exp(reg_factor * (log_depth - 1.0)) * clip_distance
    if clip_prediction:
        metric = torch.clamp(metric, math.exp(-reg_factor) * clip_distance,
                             clip_distance)
    return metric


def rgb_to_gray_np(rgb: np.ndarray) -> np.ndarray:
    """Rec601 luma (reference data_loader/dataset.py:235-236)."""
    return np.dot(rgb[..., :3], [0.2989, 0.5870, 0.1140]).astype(np.float32)
