"""Post-processing filters for inference outputs.

Counterpart of ``rpg_ramnet_tpu/eval/filters.py`` (reference
RAM_Net/utils/inference_utils.py: UnsharpMaskFilter:234-257, gaussian
unsharp masking; ImageFilter:258-276, bilateral smoothing).  The unsharp
mask is a separable depthwise gaussian conv with replicate padding on the
input's device; the bilateral filter is host-side cv2, imported where it
runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.layout import to_nchw, to_nhwc


def _gaussian_kernel1d(sigma: float, radius: Optional[int] = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of NHWC [N, H, W, C], replicate padding."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma)).to(x)
    r, c = (k.shape[0] - 1) // 2, x.shape[-1]
    y = F.pad(to_nchw(x), (0, 0, r, r), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    y = F.pad(y, (r, r, 0, 0), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return to_nhwc(y)


class UnsharpMaskFilter:
    """out = (1 + amount) * img - amount * gaussian_blur(img), on NHWC or
    HWC tensors (or numpy arrays, returned as numpy)."""

    def __init__(self, unsharp_mask_amount: float = 0.3,
                 unsharp_mask_sigma: float = 1.0):
        self.amount = unsharp_mask_amount
        self.sigma = unsharp_mask_sigma

    def __call__(self, img):
        if self.amount <= 0:
            return img
        as_numpy = isinstance(img, np.ndarray)
        x = torch.from_numpy(img) if as_numpy else img
        squeeze = x.dim() == 3
        x = x[None] if squeeze else x
        out = (1.0 + self.amount) * x - self.amount * gaussian_blur(x, self.sigma)
        out = out[0] if squeeze else out
        return out.numpy() if as_numpy else out


class ImageFilter:
    """Host-side bilateral filter (cv2); sigma <= 0 disables it."""

    def __init__(self, bilateral_filter_sigma: float = 0.0):
        self.sigma = bilateral_filter_sigma

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.sigma <= 0:
            return img
        import cv2
        return cv2.bilateralFilter(np.asarray(img, np.float32), d=5,
                                   sigmaColor=25.0 * self.sigma,
                                   sigmaSpace=25.0 * self.sigma)
