"""Host-side (numpy) evaluation metrics.

Counterpart of ``rpg_ramnet_tpu/eval/metrics.py``: the NaN-masked numpy
metrics of RAM_Net/model/metric.py, the running metric vector of
test.py:26-33 (``eval_metrics``) and what ``evaluation.py`` reads.  SSIM
is skimage's compare_ssim for float inputs written out in numpy (uniform
7x7 window, data range 2, sample covariance).
"""
from __future__ import annotations

import numpy as np

from ..core.registry import METRICS

EPS = 1e-6


@METRICS.register("abs_rel_diff")
def abs_rel_diff(y_input, y_target, eps: float = EPS):
    abs_diff = np.abs(y_target - y_input)
    return (abs_diff[~np.isnan(abs_diff)]
            / (y_target[~np.isnan(y_target)] + eps)).mean()


@METRICS.register("squ_rel_diff")
def squ_rel_diff(y_input, y_target, eps: float = EPS):
    abs_diff = np.abs(y_target - y_input)
    ok = ~np.isnan(abs_diff)
    return (abs_diff[ok] ** 2 / (y_target[ok] ** 2 + eps)).mean()


@METRICS.register("rms_linear")
def rms_linear(y_input, y_target):
    abs_diff = np.abs(y_target - y_input)
    return np.sqrt((abs_diff[~np.isnan(abs_diff)] ** 2).mean())


@METRICS.register("scale_invariant_error")
def scale_invariant_error(y_input, y_target):
    """Operates on |target - input| of its inputs (metric.py:22-25)."""
    log_diff = np.abs(y_target - y_input)
    ok = ~np.isnan(log_diff)
    return (log_diff[ok] ** 2).mean() - (log_diff[ok].mean()) ** 2


@METRICS.register("mean_error")
def mean_error(y_input, y_target):
    abs_diff = np.abs(y_target - y_input)
    return abs_diff[~np.isnan(abs_diff)].mean()


@METRICS.register("median_error")
def median_error(y_input, y_target):
    abs_diff = np.abs(y_target - y_input)
    return np.median(abs_diff[~np.isnan(abs_diff)])


@METRICS.register("mse")
def mse(y_input, y_target):
    """Per-sample MSE over non-NaN target pixels, averaged over the batch
    (metric.py:35-54); inputs [N, C, H, W] with C in {1, 3}."""
    n, c, _, _ = y_input.shape
    assert c in (1, 3)
    total = 0.0
    for i in range(n):
        for ch in range(c):
            ok = ~np.isnan(y_target[i, ch])
            d = y_input[i, ch][ok] - y_target[i, ch][ok]
            total += float(np.mean(d * d))
    out = total / float(n)
    return out / 3.0 if c == 3 else out


def _uniform_filter_valid(img: np.ndarray, win: int) -> np.ndarray:
    """win x win mean filter, 'valid' region only (no padding)."""
    c = np.cumsum(np.cumsum(img, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]
    return s / (win * win)


def _ssim_single(x: np.ndarray, y: np.ndarray, win: int = 7,
                 data_range: float = 2.0, k1: float = 0.01, k2: float = 0.03):
    """SSIM of two [H, W] images: skimage compare_ssim's defaults for float
    inputs (uniform 7x7 window, data_range 2, sample covariance)."""
    cov_norm = win * win / (win * win - 1)
    ux = _uniform_filter_valid(x, win)
    uy = _uniform_filter_valid(y, win)
    uxx = _uniform_filter_valid(x * x, win)
    uyy = _uniform_filter_valid(y * y, win)
    uxy = _uniform_filter_valid(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = (((2 * ux * uy + c1) * (2 * vxy + c2))
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    return float(s.mean())


@METRICS.register("structural_similarity")
def structural_similarity(y_input, y_target):
    """Batch SSIM, [N, C, H, W] with C in {1, 3} (metric.py:57-74): the
    mean over the batch of the per-image SSIM, averaged over the
    channels for C = 3."""
    n, c, _, _ = y_input.shape
    assert c in (1, 3)
    total = 0.0
    for i in range(n):
        if c == 3:
            total += np.mean([_ssim_single(y_input[i, ch], y_target[i, ch])
                              for ch in range(3)])
        else:
            total += _ssim_single(y_input[i, 0], y_target[i, 0])
    return total / float(n)


def get_metric(name: str):
    """The metric of that name (KeyError, listing the names, otherwise)."""
    return METRICS.get(name)


def eval_metrics(output: np.ndarray, target: np.ndarray,
                 names=("mse", "abs_rel_diff", "scale_invariant_error",
                        "median_error", "mean_error", "rms_linear")
                 ) -> np.ndarray:
    """The running metric vector of reference test.py:26-33."""
    return np.array([get_metric(n)(output, target) for n in names])
