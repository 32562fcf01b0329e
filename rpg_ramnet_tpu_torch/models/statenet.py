"""StateNet, the RAM-Net recurrent multi-modal UNet.

Counterpart of ``rpg_ramnet_tpu/models/statenet.py`` for two recipes: the
flagship (recurrent_block_type='conv', state_combination='convgru') with
its ConvLSTM state-combination variant, and the phased irregular-timestamp
regime (recurrent_block_type='convlstm', use_phased_arch, ConvLSTM or
ConvGRU state combination); sum skips, no norm, upsample-conv decoders.
``StateNet`` holds the parameters under the upstream names
(StateNetPhasedRecurrent, RAM_Net/model/statenet.py); the functions below
are the JAX module's, on NCHW-shaped channels_last tensors.

The state is a ``StateNetState``, as in JAX: per scale a super state
[B, C_i, H/2^(i+1), W/2^(i+1)], or a (hidden, cell) pair for the ConvLSTM
state combination, and per modality the phased encoders' (c0, h0) pairs
(empty tuples for conv encoders).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..ops import gru_hside
from ..utils.layout import to_nchw, to_nhwc
from .layers import (ConvGRU, ConvLayer, PhasedLSTMGate, RecurrentConvLayer,
                     RecurrentPhasedConvLayer, ResidualBlock,
                     UpsampleConvLayer, activate, init_conv_)


class ModalityState(NamedTuple):
    """Per-modality recurrent state: per scale the phased encoder's
    (c0, h0), or an empty tuple for conv encoders."""
    encoders: Tuple


class StateNetState(NamedTuple):
    """super_states: per scale a tensor, or (hidden, cell) for the ConvLSTM
    state combination (model/model.py:154-157); events, image: the
    modalities' encoder states."""
    super_states: Tuple
    events: ModalityState
    image: ModalityState


def map_state(fn, state):
    """``state`` with ``fn`` applied to every tensor, the nesting kept."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if hasattr(state, "_fields"):
        return type(state)(*(map_state(fn, s) for s in state))
    return tuple(map_state(fn, s) for s in state)


def is_phased(cfg: ModelConfig) -> bool:
    """Phased ConvLSTM encoders (the irregular-timestamp regime)."""
    return cfg.use_phased_arch and cfg.recurrent_block_type == "convlstm"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configurations outside the ported
    recipes."""
    unported = []
    if cfg.is_baseline:
        unported.append("baselines (ROADMAP queue 1, item 12)")
    if cfg.recurrent_block_type not in ("conv", "convlstm"):
        raise KeyError(f"unknown recurrent_block_type "
                       f"{cfg.recurrent_block_type}")
    if cfg.recurrent_block_type == "convlstm" and not cfg.use_phased_arch:
        unported.append("convlstm encoders without use_phased_arch "
                        "(ROADMAP queue 1, item 12)")
    if cfg.state_combination not in ("convgru", "convlstm"):
        unported.append(f"state_combination={cfg.state_combination!r} "
                        "(ROADMAP queue 1, item 12)")
    if cfg.norm is not None:
        unported.append("BN/IN norms (ROADMAP queue 1, item 12)")
    if cfg.skip_type != "sum":
        unported.append(f"skip_type={cfg.skip_type!r} "
                        "(ROADMAP queue 1, item 12)")
    if not cfg.use_upsample_conv or cfg.fast_upsample:
        unported.append("transposed-conv and fast-upsample decoders "
                        "(ROADMAP queue 1, item 12)")
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
    """Parameters of StateNet (statenet.py:139-202 upstream); the names are
    those of ``params_to_state_dict``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        nb = cfg.base_num_channels
        self.head_rgb = ConvLayer(cfg.num_bins_rgb, nb, 5, 1, 2)
        self.head_events = ConvLayer(cfg.num_bins_events, nb, 5, 1, 2)
        sizes = list(zip(cfg.encoder_input_sizes, cfg.encoder_output_sizes))

        def encoder(s, i, o):
            if not is_phased(cfg):
                return ConvLayer(i, o, 5, 2, 2)
            # the time gate spans the post-conv feature map of scale s
            # (statenet.py:98-108 of the JAX package)
            h, w = (r // 2 ** (s + 1) for r in cfg.spatial_resolution)
            return RecurrentPhasedConvLayer(i, o, h, w)

        for name in ("encoders_rgb", "encoders_events"):
            setattr(self, name, nn.ModuleList(
                encoder(s, i, o) for s, (i, o) in enumerate(sizes)))
        for name in ("state_combination_images", "state_combination_events"):
            setattr(self, name, nn.ModuleList(
                RecurrentConvLayer(o, cfg.state_combination)
                for _, o in sizes))
        self.resblocks = nn.ModuleList(
            ResidualBlock(cfg.max_num_channels)
            for _ in range(cfg.num_residual_blocks))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(c, c // 2, 5, padding=2)
            for c in reversed(cfg.encoder_output_sizes))
        self.pred = ConvLayer(nb, cfg.num_output_channels, 1, 1, 0,
                              activation=None)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """Upstream init: torch's conv default (the ConvLSTM gates
        included), orthogonal ConvGRU gates, the phased gates' periods and
        phases."""
        for m in self.modules():
            if isinstance(m, (ConvGRU, PhasedLSTMGate)):
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
               dtype: torch.dtype, device: torch.device) -> StateNetState:
    """The zero state (model/model.py:146-159), NHWC tensors
    [B, H/2^(i+1), W/2^(i+1), C_i] per scale."""
    supers, encoders = [], []
    for i in range(cfg.num_encoders):
        z = torch.zeros((batch, height // 2 ** (i + 1), width // 2 ** (i + 1),
                         cfg.base_num_channels * 2 ** (i + 1)),
                        dtype=dtype, device=device)
        supers.append((z, z) if cfg.state_combination == "convlstm" else z)
        if cfg.recurrent_block_type == "convlstm":
            encoders.append((z, z))
    return StateNetState(super_states=tuple(supers),
                         events=ModalityState(tuple(encoders)),
                         image=ModalityState(tuple(encoders)))


def use_fused_cell(cfg: ModelConfig, h: torch.Tensor,
                   kind: str = "hside") -> bool:
    """The fused_gru policy for one NCHW state tensor and one kind of cell:
    'hside' the GRU h-side cell (K1), 'full' the whole GRU cell (K5),
    'lstm' the ConvLSTM cells (K3, K4).  'auto' takes the wrapper for bf16
    states of a shape the kernel supports: on a CUDA tensor that is the
    kernel, on a CPU tensor the kernel's plain version.  'on' takes the
    kernel always and raises on a CPU tensor (the wrapper raises on an
    unsupported shape); 'off' takes the plain layer."""
    if cfg.fused_gru == "off":
        return False
    if cfg.fused_gru == "on":
        if not h.is_cuda:
            raise ValueError("fused_gru='on' needs CUDA tensors: the kernel "
                             "has no CPU implementation")
        return True
    supports = {"hside": gru_hside.supports, "full": gru_hside.supports_full,
                "lstm": gru_hside.supports_lstm}[kind]
    return supports(to_nhwc(h))


def _lstm_hside(cell, gx: torch.Tensor, state):
    """The ConvLSTM cell's h side as kernel K3 (its plain version for CPU
    tensors) on the cached folded weight: NCHW (hidden, cell)."""
    h, c = state
    hid, cell_new = gru_hside.conv_lstm_hside(
        to_nhwc(h), to_nhwc(c), to_nhwc(gx), cell.hside_weights(h.dtype))
    return to_nchw(hid), to_nchw(cell_new)


def forward_modality(net: StateNet, cfg: ModelConfig, x: torch.Tensor,
                     state: StateNetState, modality: str,
                     times: Optional[torch.Tensor] = None,
                     allow_fused: bool = False) -> StateNetState:
    """One encoder sweep of one modality with the whole cells per scale
    (the reference semantics), returning the new state.  times [B]: the
    step's timestamps for the phased encoders (zeros when None).
    allow_fused: let the fused_gru policy run the phased encoder cells as
    kernel K4, the ConvLSTM state combination as kernel K3 (after its x
    side) and the ConvGRU one as kernel K5, all inference only, instead of
    the plain layers (statenet.py:230-290)."""
    head, encoders, combs = net.branch(modality)
    enc_states = (state.events if modality == "events"
                  else state.image).encoders
    x = head(x.to(compute_dtype(cfg)))
    supers, enc_new = [], []
    for i, (enc, comb, prev) in enumerate(zip(encoders, combs,
                                              state.super_states)):
        if is_phased(cfg):
            t = times if times is not None else torch.zeros(
                x.shape[0], device=x.device)
            fuse = allow_fused and use_fused_cell(cfg, enc_states[i][0],
                                                  "lstm")
            x, st = enc(x, t, enc_states[i], fused=fuse)
            enc_new.append(st)
        else:
            x = enc(x)
        cell = comb.recurrent_block
        if cfg.state_combination == "convlstm":
            if allow_fused and use_fused_cell(cfg, prev[0], "lstm"):
                supers.append(_lstm_hside(cell, cell.x_gates(x), prev))
            else:
                supers.append(cell(x, prev))
        elif allow_fused and use_fused_cell(cfg, prev, "full"):
            supers.append(to_nchw(gru_hside.conv_gru_full(
                to_nhwc(x), to_nhwc(prev), *cell.full_weights(prev.dtype))))
        else:
            supers.append(cell(x, prev))
    state = state._replace(super_states=tuple(supers))
    if is_phased(cfg):
        state = state._replace(**{modality: ModalityState(tuple(enc_new))})
    return state


def encoder_features(net: StateNet, cfg: ModelConfig, x: torch.Tensor,
                     modality: str) -> List[torch.Tensor]:
    """Head + strided encoder convs on any batch (state-independent for
    recurrent_block_type='conv'): the per-scale x each recurrent cell of
    the state combination consumes."""
    head, encoders, _ = net.branch(modality)
    x = head(x.to(compute_dtype(cfg)))
    xs = []
    for enc in encoders:
        x = enc(x)
        xs.append(x)
    return xs


def gru_x_gates(net: StateNet, modality: str,
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-scale x-side gate pre-activations of the state combination's
    cells: [N, 3C, h, w] (ConvGRU) or [N, 4C, h, w] (ConvLSTM)."""
    _, _, combs = net.branch(modality)
    return [c.recurrent_block.x_gates(x) for c, x in zip(combs, xs)]


def combine_hside(net: StateNet, cfg: ModelConfig, supers: Sequence,
                  gx_scales: Sequence[torch.Tensor], modality: str,
                  allow_fused: bool = False) -> Tuple:
    """One modality step of per-scale h-side completion from precomputed
    x-side gates; supers are per-scale tensors (ConvGRU) or (hidden, cell)
    pairs (ConvLSTM).  allow_fused: let the fused_gru policy pick the
    h-side kernels (ops/gru_hside.py: K1, or K3 for the ConvLSTM, which
    has no gradient yet).  Under autograd the GRU cell is the
    ``ConvGRUHside`` Function on the float32 master weights, folded anew
    per call; otherwise K1 on the cached folded weights in h's dtype."""
    _, _, combs = net.branch(modality)
    out = []
    for c, g, s in zip(combs, gx_scales, supers):
        cell = c.recurrent_block
        if cfg.state_combination == "convlstm":
            if allow_fused and use_fused_cell(cfg, s[0], "lstm"):
                out.append(_lstm_hside(cell, g, s))
            else:
                out.append(cell.hside(g, s))
        elif allow_fused and use_fused_cell(cfg, s):
            w = cell.hside_weights(
                None if torch.is_grad_enabled() else s.dtype)
            out.append(to_nchw(gru_hside.conv_gru_hside(
                to_nhwc(s), to_nhwc(g), *w)))
        else:
            out.append(cell.hside(g, s))
    return tuple(out)


def supers_decoder_view(cfg: ModelConfig, supers: Sequence) -> Tuple:
    """The per-scale tensors the decoder reads from a supers tuple: the
    hidden parts of ConvLSTM pairs (statenet.py:292-295)."""
    if cfg.state_combination == "convlstm":
        return tuple(s[0] for s in supers)
    return tuple(supers)


def decoder_view(cfg: ModelConfig, state: StateNetState) -> Tuple:
    """supers_decoder_view of a state: what deferred-decode snapshots
    stack (the cells and encoder states never feed the decoder)."""
    return supers_decoder_view(cfg, state.super_states)


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
