"""Event tensor preprocessing for the live streaming path.

Counterpart of ``rpg_ramnet_tpu/ops/event_preprocess.py`` (reference
RAM_Net/utils/event_tensor_utils.py:6-68, EventPreprocessor): hot-pixel
removal as a multiplicative mask, a flip of both spatial axes and the
nonzero mean/std normalization per grid, on NHWC tensors on any device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .voxel import normalize_voxel_grid


class EventPreprocessor:
    """Callable on [B, H, W, C] (or [H, W, C]) event voxel tensors."""

    def __init__(self, no_normalize: bool = False, flip: bool = False,
                 hot_pixels_file: Optional[str] = None,
                 hot_pixel_locations: Optional[np.ndarray] = None):
        self.no_normalize = no_normalize
        self.flip = flip
        self.hot_pixel_locations = np.zeros((0, 2), np.int64)
        if hot_pixel_locations is not None:
            self.hot_pixel_locations = np.asarray(hot_pixel_locations, np.int64)
        elif hot_pixels_file:
            try:
                self.hot_pixel_locations = np.loadtxt(
                    hot_pixels_file, delimiter=",").astype(np.int64).reshape(-1, 2)
            except IOError:
                print(f"WARNING: could not load hot pixels file: {hot_pixels_file}")
        self._mask = None

    def _hot_pixel_mask(self, h: int, w: int, device) -> Optional[torch.Tensor]:
        """[H, W, 1] float32: 0 at the hot pixels (x, y), 1 elsewhere."""
        if self.hot_pixel_locations.shape[0] == 0:
            return None
        if (self._mask is None or self._mask.shape[:2] != (h, w)
                or self._mask.device != torch.device(device)):
            m = np.ones((h, w, 1), np.float32)
            for x, y in self.hot_pixel_locations:
                m[y, x, 0] = 0.0
            self._mask = torch.from_numpy(m).to(device)
        return self._mask

    def __call__(self, events: torch.Tensor) -> torch.Tensor:
        squeeze = events.dim() == 3
        if squeeze:
            events = events[None]
        mask = self._hot_pixel_mask(events.shape[1], events.shape[2],
                                    events.device)
        if mask is not None:
            events = events * mask
        if self.flip:
            events = torch.flip(events, dims=(1, 2))
        if not self.no_normalize:
            events = torch.stack([normalize_voxel_grid(e) for e in events])
        return events[0] if squeeze else events
