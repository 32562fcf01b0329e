"""The plain feedforward UNet of the non-recurrent baseline (ERGB2Depth).

Counterpart of ``rpg_ramnet_tpu/models/unet.py`` (reference
RAM_Net/model/unet.py:87-131, UNet): a norm-free 5x5 head, strided 5x5
encoders doubling the channels, residual blocks at the bottleneck,
upsample-conv decoders (the two-stage layer: bilinear x2, then a 5x5
conv) each after a sum skip of the encoder output at its scale, and the
1x1 pred conv on the last decoder's output summed with the head's: unlike
StateNet's, this pred takes the head skip (unet.py:129).  Parameter names
are the upstream ones (``head``, ``encoders.N``, ``resblocks.N``,
``decoders.N``, ``pred``).  Modules take and return NCHW-shaped tensors
in channels_last memory, as ``statenet``'s.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from .layers import ConvLayer, ResidualBlock, UpsampleConvLayer, activate, init_conv_


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for UNet options outside the ported
    recipe (the shipped no_recurrent config: sum skips, no norm,
    upsample-conv decoders)."""
    unported = []
    if cfg.norm is not None:
        unported.append("BN/IN norms (ROADMAP queue 1, item 12)")
    if cfg.skip_type != "sum":
        unported.append(f"skip_type={cfg.skip_type!r} "
                        "(ROADMAP queue 1, item 12)")
    if not cfg.use_upsample_conv or cfg.fast_upsample:
        unported.append("transposed-conv and fast-upsample decoders "
                        "(ROADMAP queue 1, item 12)")
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(unported))


class UNet(nn.Module):
    """Parameters of the UNet (unet.py:87-131 upstream)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        nb = cfg.base_num_channels
        self.head = ConvLayer(cfg.num_bins_rgb, nb, 5, 1, 2)
        self.encoders = nn.ModuleList(
            ConvLayer(i, o, 5, 2, 2)
            for i, o in zip(cfg.encoder_input_sizes, cfg.encoder_output_sizes))
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels)
            for _ in range(cfg.num_residual_blocks))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(c, c // 2, 5, padding=2)
            for c in reversed(cfg.encoder_output_sizes))
        self.pred = ConvLayer(nb, cfg.num_output_channels, 1, 1, 0,
                              activation=None)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """torch's conv default init on every conv, as upstream."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv_(m, generator)


def forward(net: UNet, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [N, C, H, W] (NCHW-shaped, any memory format; C = num_bins_rgb)
    -> the activated prediction [N, 1, H, W] in float32 (unet.py forward
    of the JAX package)."""
    from .statenet import compute_dtype
    x = net.head(x.to(compute_dtype(cfg)))
    head = x
    blocks = []
    for enc in net.encoders:
        x = enc(x)
        blocks.append(x)
    for rb in net.resblocks:
        x = rb(x)
    for i, dec in enumerate(net.decoders):
        x = dec(x + blocks[-1 - i])
    return activate(net.pred(x + head).float(), cfg.activation)
