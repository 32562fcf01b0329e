"""The plain feedforward UNet of the non-recurrent baseline (ERGB2Depth).

Counterpart of ``rpg_ramnet_tpu/models/unet.py`` (reference
RAM_Net/model/unet.py:87-131, UNet): a norm-free 5x5 head, strided 5x5
encoders doubling the channels, residual blocks at the bottleneck, decoder
layers (upsample-conv, two-stage or fast, or transposed-conv) each after
the skip of the encoder output at its scale, and the 1x1 pred conv on the
last decoder's output skipped with the head's: unlike StateNet's, this
pred takes the head skip (unet.py:129).  Skips 'sum' or 'concat' (which
doubles every decoder's input and the pred's, JAX unet.py:34, :40; JAX's
'no_skip' raises, see ``check_supported``); norms None, 'BN' or 'IN' on
every conv but the head's.  Parameter names are the upstream ones
(``head``, ``encoders.N``, ``resblocks.N``, ``decoders.N``, ``pred``).
Modules take and return NCHW-shaped tensors in channels_last memory, as
``statenet``'s.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from .layers import (ConvLayer, NormCtx, ResidualBlock, activate, name_norms,
                     upsample_conv_layer_fast)
from .statenet import apply_skip, decoder_layer, reset_parameters_


def check_supported(cfg: ModelConfig) -> None:
    """Raise KeyError for option values JAX's UNet does not know, and
    NotImplementedError for skip_type 'no_skip': JAX sizes the decoders
    and the pred for a concat, then feeds them the unskipped tensor, so
    its forward raises (as upstream's, unet.py:87-131); there is nothing
    to hold a port to (ROADMAP queue 3)."""
    if cfg.norm not in (None, "BN", "IN"):
        raise KeyError(f"unknown norm {cfg.norm!r}")
    if cfg.skip_type not in ("sum", "concat", "no_skip"):
        raise KeyError(f"unknown skip_type {cfg.skip_type!r}")
    if cfg.skip_type == "no_skip":
        raise NotImplementedError(
            "the UNet with skip_type='no_skip': the JAX reference raises on "
            "it, its layers being sized for concat (ROADMAP queue 3)")


class UNet(nn.Module):
    """Parameters of the UNet (unet.py:87-131 upstream)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        nb = cfg.base_num_channels
        wide = 1 if cfg.skip_type == "sum" else 2
        self.head = ConvLayer(cfg.num_bins_rgb, nb, 5, 1, 2)
        self.encoders = nn.ModuleList(
            ConvLayer(i, o, 5, 2, 2, norm=cfg.norm)
            for i, o in zip(cfg.encoder_input_sizes, cfg.encoder_output_sizes))
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels, cfg.norm)
            for _ in range(cfg.num_residual_blocks))
        self.decoders = nn.ModuleList(
            decoder_layer(cfg, wide * c, c // 2)
            for c in reversed(cfg.encoder_output_sizes))
        self.pred = ConvLayer(wide * nb, cfg.num_output_channels, 1, 1, 0,
                              activation=None, norm=cfg.norm)
        name_norms(self)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """torch's init on every conv and norm, as upstream."""
        reset_parameters_(self, generator)


def forward(net: UNet, cfg: ModelConfig, x: torch.Tensor,
            ctx: Optional[NormCtx] = None) -> torch.Tensor:
    """x: [N, C, H, W] (NCHW-shaped, any memory format; C = num_bins_rgb)
    -> the activated prediction [N, 1, H, W] in float32 (unet.py forward
    of the JAX package).  ctx: training-mode norms."""
    from .statenet import compute_dtype
    x = net.head(x.to(compute_dtype(cfg)))
    head = x
    blocks = []
    for enc in net.encoders:
        x = enc(x, ctx)
        blocks.append(x)
    for rb in net.resblocks:
        x = rb(x, ctx)
    for i, dec in enumerate(net.decoders):
        x = apply_skip(cfg, x, blocks[-1 - i])
        if cfg.use_upsample_conv and cfg.fast_upsample:
            x = upsample_conv_layer_fast(dec, x, ctx)
        else:
            x = dec(x, ctx)
    return activate(net.pred(apply_skip(cfg, x, head), ctx).float(),
                    cfg.activation)
