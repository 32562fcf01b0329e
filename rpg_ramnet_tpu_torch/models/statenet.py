"""StateNet, the RAM-Net recurrent multi-modal UNet: the flagship subset.

Counterpart of ``rpg_ramnet_tpu/models/statenet.py`` for
recurrent_block_type='conv', state_combination='convgru', sum skips, no
norm, upsample-conv decoders.  ``StateNet`` holds the parameters under the
upstream names (StateNetPhasedRecurrent, RAM_Net/model/statenet.py); the
functions below are the JAX module's, on NCHW-shaped channels_last tensors.
A super state is one tensor per scale, [B, C_i, H/2^(i+1), W/2^(i+1)].
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..ops import gru_hside
from ..utils.layout import to_nchw, to_nhwc
from .layers import (ConvGRU, ConvLayer, RecurrentConvLayer, ResidualBlock,
                     UpsampleConvLayer, activate, init_conv_)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configurations outside the slice."""
    unported = []
    if cfg.is_baseline:
        unported.append("baselines (ROADMAP queue 1, item 12)")
    if cfg.recurrent_block_type != "conv":
        unported.append("convlstm encoders (ROADMAP queue 1, item 12)")
    if cfg.state_combination != "convgru":
        unported.append(f"state_combination={cfg.state_combination!r} "
                        "(ROADMAP queue 1, items 9 and 12)")
    if cfg.norm is not None:
        unported.append("BN/IN norms (ROADMAP queue 1, item 12)")
    if cfg.skip_type != "sum":
        unported.append(f"skip_type={cfg.skip_type!r} "
                        "(ROADMAP queue 1, item 12)")
    if not cfg.use_upsample_conv or cfg.fast_upsample:
        unported.append("transposed-conv and fast-upsample decoders "
                        "(ROADMAP queue 1, item 12)")
    if cfg.use_phased_arch:
        unported.append("the phased regime (ROADMAP queue 1, item 10)")
    for name in ("fused_gru", "fused_decoder", "composed_decoder"):
        if getattr(cfg, name) not in ("auto", "on", "off"):
            raise ValueError(f"{name} must be auto/on/off, got "
                             f"{getattr(cfg, name)!r}")
    if cfg.fused_decoder == "on":
        unported.append("fused_decoder='on' (the fused upsample-conv "
                        "kernel K8, ROADMAP queue 2, K8)")
    if cfg.composed_decoder == "on":
        unported.append("composed_decoder='on' (the composed decoder, "
                        "ROADMAP queue 1, item 2)")
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(unported))


def supports_x_precompute(cfg: ModelConfig) -> bool:
    """True when the encoder chain is state-independent and the state
    combination is ConvGRU/ConvLSTM: the x side can be batched over steps
    (statenet.py:315)."""
    return (not cfg.is_baseline and cfg.recurrent_block_type == "conv"
            and cfg.state_combination in ("convgru", "convlstm"))


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class StateNet(nn.Module):
    """Parameters of the flagship StateNet (statenet.py:139-202 upstream);
    the names are those of ``params_to_state_dict``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        nb = cfg.base_num_channels
        self.head_rgb = ConvLayer(cfg.num_bins_rgb, nb, 5, 1, 2)
        self.head_events = ConvLayer(cfg.num_bins_events, nb, 5, 1, 2)
        sizes = list(zip(cfg.encoder_input_sizes, cfg.encoder_output_sizes))
        self.encoders_rgb = nn.ModuleList(
            ConvLayer(i, o, 5, 2, 2) for i, o in sizes)
        self.encoders_events = nn.ModuleList(
            ConvLayer(i, o, 5, 2, 2) for i, o in sizes)
        self.state_combination_images = nn.ModuleList(
            RecurrentConvLayer(o) for _, o in sizes)
        self.state_combination_events = nn.ModuleList(
            RecurrentConvLayer(o) for _, o in sizes)
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels)
            for _ in range(cfg.num_residual_blocks))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(c, c // 2, 5, padding=2)
            for c in reversed(cfg.encoder_output_sizes))
        self.pred = ConvLayer(nb, cfg.num_output_channels, 1, 1, 0,
                              activation=None)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """Upstream init: torch's conv default, orthogonal ConvGRU gates."""
        for m in self.modules():
            if isinstance(m, ConvGRU):
                m.reset_parameters_(generator)
        grus = {id(g) for m in self.modules() if isinstance(m, ConvGRU)
                for g in m.gates()}
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and id(m) not in grus:
                init_conv_(m, generator)

    def branch(self, modality: str):
        """(head, encoders, state combinations) of one modality."""
        if modality == "events":
            return (self.head_events, self.encoders_events,
                    self.state_combination_events)
        return self.head_rgb, self.encoders_rgb, self.state_combination_images


def init_state(cfg: ModelConfig, batch: int, height: int, width: int,
               dtype: torch.dtype, device: torch.device
               ) -> Tuple[torch.Tensor, ...]:
    """Zero super states, NHWC [B, H/2^(i+1), W/2^(i+1), C_i] per scale."""
    return tuple(
        torch.zeros((batch, height // 2 ** (i + 1), width // 2 ** (i + 1),
                     cfg.base_num_channels * 2 ** (i + 1)),
                    dtype=dtype, device=device)
        for i in range(cfg.num_encoders))


def forward_modality(net: StateNet, cfg: ModelConfig, x: torch.Tensor,
                     supers: Sequence[torch.Tensor], modality: str,
                     allow_fused: bool = False) -> Tuple[torch.Tensor, ...]:
    """One encoder sweep of one modality with the full ConvGRU cell per
    scale (the reference semantics), returning the new super states.
    allow_fused: let the fused_gru policy run each scale's cell as
    ``gru_hside.conv_gru_full`` (kernel K5; inference only) instead of the
    plain layer (statenet.py:275-290)."""
    head, encoders, combs = net.branch(modality)
    x = head(x.to(compute_dtype(cfg)))
    new = []
    for enc, comb, prev in zip(encoders, combs, supers):
        x = enc(x)
        cell = comb.recurrent_block
        if allow_fused and use_fused_cell(cfg, prev, full=True):
            new.append(to_nchw(gru_hside.conv_gru_full(
                to_nhwc(x), to_nhwc(prev), *cell.full_weights(prev.dtype))))
        else:
            new.append(cell(x, prev))
    return tuple(new)


def encoder_features(net: StateNet, cfg: ModelConfig, x: torch.Tensor,
                     modality: str) -> List[torch.Tensor]:
    """Head + strided encoder convs on any batch (state-independent for
    recurrent_block_type='conv'): the per-scale x each ConvGRU consumes."""
    head, encoders, _ = net.branch(modality)
    x = head(x.to(compute_dtype(cfg)))
    xs = []
    for enc in encoders:
        x = enc(x)
        xs.append(x)
    return xs


def gru_x_gates(net: StateNet, modality: str,
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-scale x-side gate pre-activations [N, 3C, h, w]."""
    _, _, combs = net.branch(modality)
    return [c.recurrent_block.x_gates(x) for c, x in zip(combs, xs)]


def use_fused_cell(cfg: ModelConfig, h: torch.Tensor,
                   full: bool = False) -> bool:
    """The fused_gru policy for one NCHW super state, for the h-side cell
    (K1) or, with ``full``, the whole cell (K5).  'auto' takes the
    wrapper for bf16 states of a shape the kernel supports: on a CUDA
    tensor that is the kernel, on a CPU tensor the kernel's plain version.
    'on' takes the kernel always and raises on a CPU tensor (the wrapper
    raises on an unsupported shape); 'off' takes the plain layer."""
    if cfg.fused_gru == "off":
        return False
    if cfg.fused_gru == "on":
        if not h.is_cuda:
            raise ValueError("fused_gru='on' needs CUDA tensors: the kernel "
                             "has no CPU implementation")
        return True
    supports = gru_hside.supports_full if full else gru_hside.supports
    return supports(to_nhwc(h))


def combine_hside(net: StateNet, cfg: ModelConfig,
                  supers: Sequence[torch.Tensor],
                  gx_scales: Sequence[torch.Tensor], modality: str,
                  allow_fused: bool = False) -> Tuple[torch.Tensor, ...]:
    """One modality step of per-scale h-side ConvGRU completion from
    precomputed x-side gates.  allow_fused: let the fused_gru policy pick
    the h-side kernels (ops/gru_hside.py).  Under autograd the cell is the
    ``ConvGRUHside`` Function on the float32 master weights, folded anew
    per call; otherwise K1 on the cached folded weights in h's dtype."""
    _, _, combs = net.branch(modality)
    out = []
    for c, g, h in zip(combs, gx_scales, supers):
        cell = c.recurrent_block
        if allow_fused and use_fused_cell(cfg, h):
            w = cell.hside_weights(
                None if torch.is_grad_enabled() else h.dtype)
            out.append(to_nchw(gru_hside.conv_gru_hside(
                to_nhwc(h), to_nhwc(g), *w)))
        else:
            out.append(cell.hside(g, h))
    return tuple(out)


def forward_decoder_supers(net: StateNet, cfg: ModelConfig,
                           supers: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shared decoder on per-scale hidden states: resblocks on the
    deepest, then upsample-conv layers with sum skips of the shallower
    ones, the 1x1 pred conv and the activation in float32 [N, 1, H, W]."""
    x = supers[-1]
    for rb in net.resblocks:
        x = rb(x)
    n = cfg.num_encoders
    for i, dec in enumerate(net.decoders):
        if i > 0:
            x = x + supers[n - i - 1]   # _skip, skip_type='sum'
        x = dec(x)
    return activate(net.pred(x).float(), cfg.activation)
