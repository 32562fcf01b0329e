"""Training losses, NaN-masked.

Counterpart of ``rpg_ramnet_tpu/train/losses.py`` (reference
RAM_Net/model/loss.py): the NaN masking of the reference (``x[~isnan]``)
is a ``where`` and a division by the valid count, with the reference's
scalings (the gradient loss's ``* batch * 2 / num_scales``).  Masked
entries are zeroed before any nonlinearity, so they pass no NaN into the
gradients.
"""
from __future__ import annotations

import torch

from ..core.registry import LOSSES
from ..ops.gradient import avg_pool, spatial_gradient


def _nanmean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, 0.0).sum() / mask.sum().clamp_min(1)


@LOSSES.register("scale_invariant_loss")
def scale_invariant_loss(y_input, y_target, weight: float = 1.0,
                         n_lambda: float = 1.0):
    """weight * (mean(d^2) - n_lambda * mean(d)^2), d = input - target over
    non-NaN entries (loss.py:6-9)."""
    d = y_input - y_target
    ok = ~torch.isnan(d)
    d = torch.where(ok, d, 0.0)
    m1 = _nanmean(d, ok)
    return weight * (_nanmean(d * d, ok) - n_lambda * m1 * m1)


@LOSSES.register("scale_invariant_log_loss")
def scale_invariant_log_loss(y_input, y_target, n_lambda: float = 1.0):
    """The scale-invariant loss on log values (loss.py:12-15)."""
    d = torch.log(y_input) - torch.log(y_target)
    ok = ~torch.isnan(d)
    d = torch.where(ok, d, 0.0)
    return _nanmean(d * d, ok) - n_lambda * _nanmean(d, ok) ** 2


@LOSSES.register("mse_loss")
def mse_loss(y_input, y_target):
    """MSE over the entries whose target is not NaN (loss.py:18-19)."""
    ok = ~torch.isnan(y_target)
    d = torch.where(ok, y_input - y_target, 0.0)
    return _nanmean(d * d, ok)


def multi_scale_grad_loss(prediction, target, start_scale: int = 1,
                          num_scales: int = 4):
    """Multi-scale gradient matching loss (loss.py:22-63), NHWC: per scale
    s, the difference average-pooled by start_scale*2^s, its sobel
    gradients, their NaN-aware L1 mean over both maps, times batch*2; the
    sum over scales / num_scales."""
    diff = prediction - target
    batch = prediction.shape[0]
    total = 0.0
    for s in range(num_scales):
        gx, gy = spatial_gradient(avg_pool(diff, start_scale * 2 ** s))
        g = torch.stack([gx, gy])
        ok = ~torch.isnan(g)
        total = total + _nanmean(torch.where(ok, g, 0.0).abs(), ok) \
            * batch * 2.0
    return total / num_scales


def _resize_weights(n_in: int, n_out: int, dtype) -> torch.Tensor:
    """[n_in, n_out] weights of a triangle-kernel (bilinear) resize along
    one axis, antialiased when shrinking, normalized per output: the
    weight matrix of jax.image.resize(..., 'bilinear')."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None])
    w = (1.0 - dist.abs() / kernel_scale).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize the last two dims of x like jax.image.resize(..., 'bilinear')
    (the JAX package's MSE downsampling): a contraction with one weight
    matrix per axis, so a NaN spreads over its whole map, whose MSE then
    counts no entry."""
    wh = _resize_weights(x.shape[-2], height, x.dtype).to(x.device)
    ww = _resize_weights(x.shape[-1], width, x.dtype).to(x.device)
    return wh.transpose(0, 1) @ (x @ ww)


def get_loss(name: str):
    return LOSSES.get(name)
