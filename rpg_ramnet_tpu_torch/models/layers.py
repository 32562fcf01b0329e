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
    conv_lstm_apply                      ConvLSTM.forward
    conv_lstm_x_gates                    ConvLSTM.x_gates
    conv_lstm_apply_hside                ConvLSTM.hside
    the fold of conv_lstm_hside_fused    ConvLSTM.hside_weights (K3, K4)
    recurrent_conv_layer_apply           RecurrentConvLayer.forward
    phased_lstm_gate_init                PhasedLSTMGate
    phased_gate_k                        phased_gate_k
    phased_conv_lstm_apply               PhasedConvLSTM.forward
    recurrent_phased_conv_layer_apply    RecurrentPhasedConvLayer.forward

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

from ..ops.phased_cell import conv_lstm_phased, gate_k
from ..utils.layout import to_nchw, to_nhwc


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


class _FoldedGates(nn.Module):
    """A recurrent cell whose gate convs (``gates()``) are folded into the
    kernels' weight layouts, cached per weight version and dtype."""

    def __init__(self):
        super().__init__()
        self._fold_cache = {}

    def _folded(self, kind: str, dtype: torch.dtype, make):
        """make(gate weights, dtype), cached per kind, weight version and
        dtype when no gradient is being recorded; under autograd, folded
        anew from the live parameters through differentiable ops."""
        ws = tuple(g.weight for g in self.gates())
        if torch.is_grad_enabled():
            return make(ws, dtype)
        params = ws + tuple(g.bias for g in self.gates())
        key = tuple((p.data_ptr(), p._version) for p in params) + (dtype,)
        hit = self._fold_cache.get(kind)
        if hit is None or hit[0] != key:
            hit = self._fold_cache[kind] = (key, make(ws, dtype))
        return hit[1]


def _fold_taps(w: torch.Tensor, dtype) -> torch.Tensor:
    """OIHW [O, I, 3, 3] -> [9, O, I] (tap ky*3 + kx, output, input) in
    ``dtype``, contiguous: the tensor cores' B operand."""
    return (w.permute(2, 3, 0, 1).reshape(9, w.shape[0], w.shape[1])
            .to(dtype).contiguous())


class ConvGRU(_FoldedGates):
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

        def make(ws, dtype):
            return (_fold_taps(torch.cat([ws[0], ws[1]])[:, -C:], dtype),
                    _fold_taps(ws[2][:, -C:], dtype))

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
        def make(ws, dtype):
            u, r, o = self.gates()
            return (_fold_taps(torch.cat([ws[0], ws[1]]), dtype),
                    _fold_taps(ws[2], dtype),
                    torch.cat([u.bias, r.bias]).float(), o.bias.float().clone())

        dtype = dtype or self.update_gate.weight.dtype
        return self._folded("full", dtype, make)


def _lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """(hidden, cell) from the 4-gate pre-activations [B, 4C, H, W] in
    (in, remember, out, cell) order and the cell input c."""
    i, f, o, u = gates.chunk(4, dim=1)
    cell = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
    return torch.sigmoid(o) * torch.tanh(cell), cell


class ConvLSTM(_FoldedGates):
    """ConvLSTM (submodules.py:303-358): one 4-gate conv ``Gates`` on
    cat(x, h), gate order (in, remember, out, cell), torch's default conv
    init.  The state is (hidden, cell); forward returns the new pair.

    x_gates and hside split it as ConvGRU's do (the biases go with the x
    side), and hside_weights folds the h slice for kernels K3 and K4."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size, 3,
                               padding=1)

    def gates(self):
        return (self.Gates,)

    def forward(self, x: torch.Tensor, state):
        h, c = state
        return _lstm_cell(conv(self.Gates, torch.cat([x, h], dim=1)), c)

    def x_gates(self, x: torch.Tensor) -> torch.Tensor:
        """x-side gate pre-activations [B, 4C, H, W], bias folded in."""
        w = self.Gates.weight[:, :self.input_size]
        return F.conv2d(x, w.to(x.dtype), self.Gates.bias.to(x.dtype), 1, 1)

    def hside(self, gx: torch.Tensor, state):
        """The h-side completion from gx = x_gates(x): the new (hidden,
        cell).  Equals forward up to float summation order."""
        h, c = state
        w = self.Gates.weight[:, -self.hidden_size:]
        return _lstm_cell(F.conv2d(h, w.to(h.dtype), None, 1, 1) + gx, c)

    def hside_weights(self, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
        """The h slice of the gate weight in the layout of
        ops.gru_hside.conv_lstm_hside (K3) and ops.phased_cell (K4):
        w4 [9, 4C, C], indexed (ky*3 + kx, gate*C + output channel, input
        channel), in ``dtype`` (the parameter's own when None); cached as
        ConvGRU.hside_weights."""
        C = self.hidden_size
        dtype = dtype or self.Gates.weight.dtype
        return self._folded("hside", dtype,
                            lambda ws, dt: _fold_taps(ws[0][:, -C:], dt))


class RecurrentConvLayer(nn.Module):
    """Bare recurrent block for per-scale state combination
    (submodules.py:100-120; its conv is unused upstream): a ConvGRU, or a
    ConvLSTM for state_combination='convlstm'."""

    def __init__(self, channels: int, block_type: str = "convgru"):
        super().__init__()
        cell = ConvLSTM if block_type == "convlstm" else ConvGRU
        self.recurrent_block = cell(channels, channels)


class PhasedLSTMGate(nn.Module):
    """The PhasedLSTM time gate (submodules.py:218-300): a period ``tau``
    and a ``phase`` per flattened torch-order feature (c*H*W + y*W + x).
    Init (``reset_parameters_``): log tau ~ U(log 0.02, log 50), phase ~
    U(0, 1) * tau, as ``phased_lstm_gate_init``."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.tau = nn.Parameter(torch.empty(hidden_size))
        self.phase = nn.Parameter(torch.empty(hidden_size))
        self._cache = None

    def reset_parameters_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.tau.uniform_(math.log(0.02), math.log(50.0),
                              generator=generator).exp_()
            self.phase.uniform_(0.0, 1.0, generator=generator).mul_(self.tau)

    def nchw(self, c: int, h: int, w: int):
        """(tau, phase) as [C, H, W] views of the parameters."""
        return self.tau.view(c, h, w), self.phase.view(c, h, w)

    def nhwc(self, c: int, h: int, w: int):
        """(tau, phase) permuted once to the kernel's [H, W, C], float32,
        contiguous: copies, never aliases of the parameters, cached per
        parameter version."""
        key = tuple((p.data_ptr(), p._version) for p in (self.tau, self.phase))
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                out = tuple(v.float().view(c, h, w).permute(1, 2, 0)
                            .contiguous().clone() for v in (self.tau, self.phase))
            self._cache = (key, out)
        return self._cache[1]


def phased_gate_k(gate: PhasedLSTMGate, t: torch.Tensor, c: int, h: int,
                  w: int) -> torch.Tensor:
    """k(t) [B, C, H, W] (NCHW-shaped) in float32 from the flattened
    torch-order tau/phase and t [B]: the JAX ``phased_gate_k`` evaluated in
    the layout of the port's modules."""
    tau, phase = gate.nchw(c, h, w)
    return gate_k(tau[None], phase[None], t.reshape(-1, 1, 1, 1))


class PhasedConvLSTM(nn.Module):
    """PhasedConvLSTMCell (submodules.py:361-411): a ConvLSTM whose outputs
    the time gate blends with the previous state, over a feature map of a
    fixed size (the gate is per flattened feature)."""

    def __init__(self, input_channels: int, hidden_channels: int,
                 height: int, width: int):
        super().__init__()
        self.height, self.width = height, width
        self.lstm = ConvLSTM(input_channels, hidden_channels)
        self.phased_cell = PhasedLSTMGate(hidden_channels * height * width)

    def forward(self, x: torch.Tensor, times: torch.Tensor, state,
                fused: bool = False):
        """(h_t, (h_new, c_new)) from NCHW x, times [B] and the state
        (c0, h0), the reference's slot convention kept verbatim: (c0, h0)
        go into the ConvLSTM's (hidden, cell) slots and its (hidden, cell)
        return is (c_t, h_t).  The blend runs in float32 and is cast back
        to the state's dtype.  fused: the x/h split and kernel K4
        (ops/phased_cell.py), on the kernel's plain version for CPU
        tensors."""
        c0, h0 = state
        C = self.lstm.hidden_size
        if fused:
            gx = self.lstm.x_gates(x)
            h_t, h_new, c_new = conv_lstm_phased(
                to_nhwc(c0), to_nhwc(h0), to_nhwc(gx),
                self.lstm.hside_weights(c0.dtype),
                *self.phased_cell.nhwc(C, self.height, self.width), times)
            return to_nchw(h_t), (to_nchw(h_new), to_nchw(c_new))
        c_t, h_t = self.lstm(x, (c0, h0))
        k = phased_gate_k(self.phased_cell, times, C, *c_t.shape[2:])
        dt = h_t.dtype
        return h_t, ((k * h_t + (1.0 - k) * h0).to(dt),
                     (k * c_t + (1.0 - k) * c0).to(dt))


class RecurrentPhasedConvLayer(nn.Module):
    """RecurrentPhasedConvLayer (submodules.py:145-157): a 5x5 stride-2
    conv with ReLU, then a PhasedConvLSTM over the post-conv feature map
    (height x width)."""

    def __init__(self, in_ch: int, out_ch: int, height: int, width: int):
        super().__init__()
        self.conv = ConvLayer(in_ch, out_ch, 5, 2, 2)
        self.recurrent_block = PhasedConvLSTM(out_ch, out_ch, height, width)

    def forward(self, x: torch.Tensor, times: torch.Tensor, state,
                fused: bool = False):
        return self.recurrent_block(self.conv(x), times, state, fused=fused)
