"""Host-side (numpy) evaluation metrics of the inference CLI.

Counterpart of ``rpg_ramnet_tpu/eval/metrics.py`` for the metrics that
``eval_metrics`` reads (RAM_Net/model/metric.py: NaN-masked numpy
metrics; the running metric vector of test.py:26-33).
"""
from __future__ import annotations

import numpy as np

EPS = 1e-6


def abs_rel_diff(y_input, y_target, eps: float = EPS):
    abs_diff = np.abs(y_target - y_input)
    return (abs_diff[~np.isnan(abs_diff)]
            / (y_target[~np.isnan(y_target)] + eps)).mean()


def rms_linear(y_input, y_target):
    abs_diff = np.abs(y_target - y_input)
    return np.sqrt((abs_diff[~np.isnan(abs_diff)] ** 2).mean())


def scale_invariant_error(y_input, y_target):
    """Operates on |target - input| of its inputs (metric.py:22-25)."""
    log_diff = np.abs(y_target - y_input)
    ok = ~np.isnan(log_diff)
    return (log_diff[ok] ** 2).mean() - (log_diff[ok].mean()) ** 2


def mean_error(y_input, y_target):
    abs_diff = np.abs(y_target - y_input)
    return abs_diff[~np.isnan(abs_diff)].mean()


def median_error(y_input, y_target):
    abs_diff = np.abs(y_target - y_input)
    return np.median(abs_diff[~np.isnan(abs_diff)])


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


METRICS = {"mse": mse, "abs_rel_diff": abs_rel_diff,
           "scale_invariant_error": scale_invariant_error,
           "median_error": median_error, "mean_error": mean_error,
           "rms_linear": rms_linear}


def eval_metrics(output: np.ndarray, target: np.ndarray,
                 names=("mse", "abs_rel_diff", "scale_invariant_error",
                        "median_error", "mean_error", "rms_linear")
                 ) -> np.ndarray:
    """The running metric vector of reference test.py:26-33."""
    return np.array([METRICS[n](output, target) for n in names])
