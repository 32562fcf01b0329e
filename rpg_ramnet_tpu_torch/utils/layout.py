"""The package's one layout conversion: NHWC <-> NCHW-shaped views.

Public tensors are NHWC, as in the JAX package.  Modules run NCHW-shaped
tensors in ``torch.channels_last`` memory, which is physically NHWC, so
both directions are views and copy nothing.
"""
import torch


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> NCHW-shaped view [B, C, H, W]."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped [B, C, H, W] -> NHWC view [B, H, W, C]."""
    return x.permute(0, 2, 3, 1)
