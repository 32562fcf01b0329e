"""Conv layers and the ConvGRU cell of the ported slice, as nn.Modules.

Counterpart of ``rpg_ramnet_tpu/models/layers.py`` (the flagship subset).
Module and parameter names follow the upstream torch modules
(RAM_Net/model/submodules.py), which are also the names
``compat.params_to_state_dict`` emits for JAX params, so a reference
state dict loads with ``strict=True``.

    JAX function                         port
    conv2d / conv_layer_apply            ConvLayer.forward
    upsample2x_bilinear                  upsample2x_bilinear
    upsample_conv_layer_apply            UpsampleConvLayer.forward
    residual_block_apply                 ResidualBlock.forward
    conv_gru_apply                       ConvGRU.forward
    conv_gru_x_gates                     ConvGRU.x_gates
    conv_gru_apply_hside                 ConvGRU.hside
    the folds of conv_gru_hside_fused    ConvGRU.hside_weights (K1)
    the folds of conv_gru_full_fused     ConvGRU.full_weights (K5)

Parameters stay float32 (the masters an optimizer updates); every layer
casts its weights to its input's dtype at use, as the JAX layers do
(``conv2d``: ``w.astype(x.dtype)``), so one model serves float32 and bf16
compute, training and inference.

Modules take and return NCHW-shaped tensors.  The model keeps them in
``torch.channels_last`` memory, which is physically the JAX package's NHWC:
``utils.layout.to_nchw``/``to_nhwc`` are the only layout conversions in the
package and are views, not copies.  A ConvLayer also takes an
NCHW-contiguous input (the channel-first head input of the JAX
``input_layout='NCHW'``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def activate(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name is None or name == "identity":
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    raise KeyError(f"unknown activation {name}")


def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """torch's nn.Conv2d default init (U(+-1/sqrt(fan_in)) on weight and
    bias), drawn from ``generator``."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(conv.weight, -bound, bound, generator=generator)
        if conv.bias is not None:
            nn.init.uniform_(conv.bias, -bound, bound, generator=generator)


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied to x with its weight and bias cast to x's dtype."""
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), b, layer.stride,
                    layer.padding)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, half-pixel centres (align_corners=False), as the
    reference's UpsampleConvLayer (submodules.py:88)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class ConvLayer(nn.Module):
    """Conv + activation (submodules.py:8-35, norm-free)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activate(conv(self.conv2d, x), self.activation)


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 then conv + activation (submodules.py:69-97)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 padding: int = 0, activation: Optional[str] = "relu"):
        super().__init__()
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size, 1, padding)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activate(conv(self.conv2d, upsample2x_bilinear(x)),
                        self.activation)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with an identity skip (submodules.py:182-215)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, 1, 1)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv(self.conv2, torch.relu(conv(self.conv1, x)))
        return torch.relu(out + x)


class ConvGRU(nn.Module):
    """ConvGRU (submodules.py:414-454): three gate convs on cat(x, h).

    forward is the whole cell; x_gates and hside split it for the
    precomputed path: conv(cat(x, h), W) == conv(x, W_x) + conv(h, W_h), the
    x side is state-independent and runs batched over a whole chunk, and
    only the h side stays sequential."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        cin = input_size + hidden_size
        self.reset_gate = nn.Conv2d(cin, hidden_size, 3, padding=1)
        self.update_gate = nn.Conv2d(cin, hidden_size, 3, padding=1)
        self.out_gate = nn.Conv2d(cin, hidden_size, 3, padding=1)
        self._fold_cache = {}

    def gates(self):
        """The gate convs in gx order: update, reset, out."""
        return (self.update_gate, self.reset_gate, self.out_gate)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """Orthogonal weights, zero biases (submodules.py:429-434)."""
        with torch.no_grad():
            for g in (self.reset_gate, self.update_gate, self.out_gate):
                nn.init.orthogonal_(g.weight, generator=generator)
                nn.init.zeros_(g.bias)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        C = self.hidden_size
        dt = h.dtype
        stacked = torch.cat([x, h], dim=1)
        w_ur = torch.cat([self.update_gate.weight, self.reset_gate.weight])
        b_ur = torch.cat([self.update_gate.bias, self.reset_gate.bias])
        ur = torch.sigmoid(F.conv2d(stacked, w_ur.to(dt), b_ur.to(dt), 1, 1))
        z, r = ur[:, :C], ur[:, C:]
        o = torch.tanh(conv(self.out_gate, torch.cat([x, h * r], dim=1)))
        return h * (1.0 - z) + o * z

    def x_gates(self, x: torch.Tensor) -> torch.Tensor:
        """x-side gate pre-activations [B, 3C, H, W] in (update, reset,
        out) order, biases folded in, so the h-side convs are bias-free."""
        cx = self.input_size
        w = torch.cat([g.weight[:, :cx] for g in self.gates()])
        b = torch.cat([g.bias for g in self.gates()])
        return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), 1, 1)

    def hside(self, gx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The sequential h-side completion from gx = x_gates(x).  Equals
        forward up to float summation order (the two conv halves are
        summed after the convs)."""
        C = self.hidden_size
        dt = h.dtype
        w_ur = torch.cat([self.update_gate.weight[:, -C:],
                          self.reset_gate.weight[:, -C:]])
        ur = torch.sigmoid(F.conv2d(h, w_ur.to(dt), None, 1, 1)
                           + gx[:, :2 * C])
        z, r = ur[:, :C], ur[:, C:]
        o = torch.tanh(F.conv2d(h * r, self.out_gate.weight[:, -C:].to(dt),
                                None, 1, 1) + gx[:, 2 * C:])
        return h * (1.0 - z) + o * z

    def hside_weights(self, dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The h slices of the gate weights in the layout of
        ops.gru_hside: w_ur [9, 2C, C] (update rows, then reset rows) and
        w_o [9, C, C], indexed (ky*3 + kx, output channel, input channel),
        in ``dtype`` (the parameters' own when None).

        Under autograd they are folded from the live parameters on every
        call, through differentiable ops, so gradients reach the gate
        weights.  Otherwise (no_grad, inference_mode) they are folded once
        per weight version and dtype and cached, not once per step."""
        C = self.hidden_size

        def fold(w):
            return (w[:, -C:].permute(2, 3, 0, 1)
                    .reshape(9, w.shape[0], C).to(dtype).contiguous())

        def make(ws, dtype):
            return fold(torch.cat([ws[0], ws[1]])), fold(ws[2])

        dtype = dtype or self.update_gate.weight.dtype
        return self._folded("hside", dtype, make)

    def full_weights(self, dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, ...]:
        """The whole cell's gate weights on cat(x, h) in the layout of
        ops.gru_hside.conv_gru_full (kernel K5): w_ur [9, 2C, Cx + C]
        (update rows, then reset rows; x channels, then h channels) and
        w_o [9, C, Cx + C], indexed (ky*3 + kx, output channel, input
        channel), in ``dtype`` (the parameters' own when None), and the
        biases b_ur [2C] and b_o [C] in float32.  Folded once per weight
        version and dtype and cached; under autograd, folded anew."""
        def fold(w):
            return (w.permute(2, 3, 0, 1)
                    .reshape(9, w.shape[0], w.shape[1]).to(dtype).contiguous())

        def make(ws, dtype):
            u, r, o = self.gates()
            return (fold(torch.cat([ws[0], ws[1]])), fold(ws[2]),
                    torch.cat([u.bias, r.bias]).float(), o.bias.float().clone())

        dtype = dtype or self.update_gate.weight.dtype
        return self._folded("full", dtype, make)

    def _folded(self, kind: str, dtype: torch.dtype, make):
        """make(gate weights, dtype), cached per kind, weight version and
        dtype when no gradient is being recorded."""
        ws = tuple(g.weight for g in self.gates())
        if torch.is_grad_enabled():
            return make(ws, dtype)
        params = ws + tuple(g.bias for g in self.gates())
        key = tuple((p.data_ptr(), p._version) for p in params) + (dtype,)
        hit = self._fold_cache.get(kind)
        if hit is None or hit[0] != key:
            hit = self._fold_cache[kind] = (key, make(ws, dtype))
        return hit[1]


class RecurrentConvLayer(nn.Module):
    """Bare recurrent block for per-scale state combination
    (submodules.py:100-120; its conv is unused upstream)."""

    def __init__(self, channels: int):
        super().__init__()
        self.recurrent_block = ConvGRU(channels, channels)
