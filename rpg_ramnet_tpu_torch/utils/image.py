"""Robust image normalization helpers (reference utils/util.py:5-14).

Counterpart of ``rpg_ramnet_tpu/utils/image.py``: numpy on the host.
"""
from __future__ import annotations

import numpy as np


def robust_min(img: np.ndarray, p: float = 5) -> float:
    return float(np.percentile(img.ravel(), p))


def robust_max(img: np.ndarray, p: float = 95) -> float:
    return float(np.percentile(img.ravel(), p))


def normalize(img: np.ndarray, m: float = 10, M: float = 90) -> np.ndarray:
    lo = robust_min(img, m)
    hi = robust_max(img, M)
    return np.clip((img - lo) / (hi - lo), 0.0, 1.0)
