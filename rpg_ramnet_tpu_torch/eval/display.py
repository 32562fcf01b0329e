"""Interactive cv2 display utilities (optional, headless-gated).

Counterpart of ``rpg_ramnet_tpu/eval/display.py`` (reference
RAM_Net/utils/image_display_utils.py: Trackbar:8, ImageDisplay:25 with
gamma/contrast/brightness LUTs, DepthDisplay:168 with inverse/log-inverse
toggles).  The math helpers are numpy and usable standalone; ``cv2`` is
imported only where a window is made or shown, and in a headless
environment (no GUI backend) construction raises a clear error.
"""
from __future__ import annotations

import numpy as np


def gamma_lut(gamma: float) -> np.ndarray:
    inv = 1.0 / max(gamma, 1e-6)
    return (np.clip(((np.arange(256) / 255.0) ** inv) * 255.0, 0, 255)
            .astype(np.uint8))


def apply_gamma(img_u8: np.ndarray, gamma: float) -> np.ndarray:
    return gamma_lut(gamma)[img_u8]


def apply_contrast_brightness(img_u8: np.ndarray, contrast: float = 1.0,
                              brightness: float = 0.0) -> np.ndarray:
    out = img_u8.astype(np.float32) * contrast + brightness
    return np.clip(out, 0, 255).astype(np.uint8)


def depth_to_display(depth: np.ndarray, mode: str = "linear",
                     reg_factor: float = 3.70378) -> np.ndarray:
    """log-depth [0,1] -> displayable inverse / log-inverse image
    (image_display_utils.py:168-283 toggles)."""
    if mode == "inverse":
        metric = np.exp(reg_factor * (depth - 1.0))
        img = 1.0 / np.maximum(metric, 1e-6)
        img = img / np.max(img)
    elif mode == "log_inverse":
        img = 1.0 - depth
    else:
        img = depth
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


class Trackbar:
    def __init__(self, name: str, window: str, value: int, max_value: int):
        import cv2
        self.name, self.window = name, window
        cv2.createTrackbar(name, window, value, max_value, lambda v: None)

    @property
    def value(self) -> int:
        import cv2
        return cv2.getTrackbarPos(self.name, self.window)


class ImageDisplay:
    """Interactive window with gamma/contrast/brightness trackbars."""

    def __init__(self, window_name: str = "image"):
        import cv2
        self.window_name = window_name
        try:
            cv2.namedWindow(window_name)
        except cv2.error as e:
            raise RuntimeError(
                "ImageDisplay requires a GUI-capable OpenCV build; this "
                "environment is headless") from e
        self.gamma = Trackbar("gamma x10", window_name, 10, 30)
        self.contrast = Trackbar("contrast x10", window_name, 10, 30)
        self.brightness = Trackbar("brightness", window_name, 0, 100)

    def show(self, img: np.ndarray, wait_time: int = 1):
        import cv2
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8) if img.dtype != np.uint8 else img
        u8 = apply_contrast_brightness(u8, self.contrast.value / 10.0,
                                       float(self.brightness.value))
        u8 = apply_gamma(u8, self.gamma.value / 10.0)
        cv2.imshow(self.window_name, u8)
        cv2.waitKey(wait_time)


class DepthDisplay(ImageDisplay):
    """Depth window with inverse/log-inverse display toggles."""

    def __init__(self, window_name: str = "depth", mode: str = "inverse",
                 reg_factor: float = 3.70378):
        super().__init__(window_name)
        self.mode = mode
        self.reg_factor = reg_factor

    def show(self, depth: np.ndarray, wait_time: int = 1):
        img = depth_to_display(depth, self.mode, self.reg_factor)
        super().show(img, wait_time)
