"""Spatial gradients and pooling for the multi-scale gradient loss.

Counterpart of ``rpg_ramnet_tpu/ops/gradient.py``: kornia's sobel
``spatial_gradient`` (3x3 sobel kernels normalized by their L1 mass, /8,
replicate padding, cross-correlation) and torch's ``AvgPool2d(k, k)``, on
NHWC tensors.  Every tap multiplies, zero weights included, so NaNs spread
to exactly the outputs a direct convolution would give NaN (the losses
mask them).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def spatial_gradient(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [N, H, W, C] -> (gx, gy), each [N, H, W, C]."""
    H, W = x.shape[1], x.shape[2]
    pad = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    pad = pad.permute(0, 2, 3, 1)
    gx = gy = 0.0
    for dy in range(3):
        for dx in range(3):
            tap = pad[:, dy:dy + H, dx:dx + W]
            gx = gx + (_SOBEL_X[dy][dx] / 8.0) * tap
            gy = gy + (_SOBEL_X[dx][dy] / 8.0) * tap
    return gx, gy


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch ``AvgPool2d(k, stride=k)`` on NHWC (floor mode, no padding),
    as a window mean: NaNs spread through their window."""
    if k == 1:
        return x
    n, h, w, c = x.shape
    hh, ww = h // k, w // k
    x = x[:, :hh * k, :ww * k]
    return x.reshape(n, hh, k, ww, k, c).mean(dim=(2, 4))
