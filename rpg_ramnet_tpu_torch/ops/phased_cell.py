"""The phased ConvLSTM cell: the ConvLSTM h-side completion and the time
gate's blend in one launch (kernel K4).

Counterpart of ``rpg_ramnet_tpu/ops/phased_cell.py``
(``conv_lstm_phased_fused``: Pallas ``_run_phased``/``_phased_kernel``).
The kernel is ``csrc/lstm_hside.cu`` with its phased flag; its header says
what bounds it on an H100 and what the design does about it.

Slot conventions kept verbatim from the reference (RAM_Net/model/
submodules.py:381-411): the phased state is (c0, h0); the ConvLSTM takes
them in its (hidden, cell) slots, so c0 is the conv operand and h0 the
cell input; its cell' output is h_t and its hidden' output is c_t:

    i, f, o, u = gates(conv3x3(c0, W4) + gx)
    h_t = f * h0 + i * u          c_t = o * tanh(h_t)
    k   = gate_k(t; tau, phase)   (per feature, float32)
    h_new = k h_t + (1 - k) h0    c_new = k c_t + (1 - k) c0

Tensors are NHWC [B, H, W, C]; gx [B, H, W, 4C] = ``ConvLSTM.x_gates``;
w4 [9, 4C, C] = ``ConvLSTM.hside_weights``; tau and phase [H, W, C]
float32 (``PhasedLSTMGate.nhwc``: the flattened torch-order parameters
permuted once); t [B] float32.  ``conv_lstm_phased`` runs K4 for CUDA
tensors and ``conv_lstm_phased_plain`` for CPU tensors; it raises under
autograd (the VJP, ``_phased_cell_bwd``, comes with training).
``conv_lstm_phased.launches`` counts K4's launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.layout import to_nchw, to_nhwc
from . import gru_hside

LEAK, RATIO_ON = 0.001, 0.1     # the reference's PhasedLSTMCell defaults


def gate_k(tau: torch.Tensor, phase: torch.Tensor, t: torch.Tensor,
           leak: float = LEAK, ratio_on: float = RATIO_ON) -> torch.Tensor:
    """The time gate's openness k(t) in float32, by broadcasting: tau and
    phase per feature, t per batch item (shaped to broadcast against
    them).  The same scalar operations as the JAX ``phased_gate_k``."""
    tau, phase = tau.float(), phase.float()
    phi = torch.abs(torch.fmod(t.float() - phase, tau)) / tau
    k_up = 2.0 * phi / ratio_on
    k = torch.where(phi < ratio_on, 2.0 - k_up, leak * phi)
    return torch.where(phi < 0.5 * ratio_on, k_up, k)


def conv_lstm_phased_plain(c0: torch.Tensor, h0: torch.Tensor,
                           gx: torch.Tensor, w4: torch.Tensor,
                           tau: torch.Tensor, phase: torch.Tensor,
                           t: torch.Tensor, leak: float = LEAK,
                           ratio_on: float = RATIO_ON
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's arithmetic in plain PyTorch: gates, cell and blend in the work
    dtype (k in float32), (h_t, h_new, c_new) rounded to c0's dtype.  The
    CPU implementation of ``conv_lstm_phased`` and the kernel's oracle on
    the card."""
    i, f, o, u = gru_hside.lstm_gates_plain(c0, gx, w4)
    dt = i.dtype
    h0f, c0f = to_nchw(h0).to(dt), to_nchw(c0).to(dt)
    h_t = f * h0f + i * u
    c_t = o * torch.tanh(h_t)
    k = gate_k(to_nchw(tau[None]), to_nchw(phase[None]),
               t.reshape(-1, 1, 1, 1), leak, ratio_on).to(dt)
    h_new = k * h_t + (1.0 - k) * h0f
    c_new = k * c_t + (1.0 - k) * c0f
    return tuple(to_nhwc(v.to(c0.dtype)).contiguous()
                 for v in (h_t, h_new, c_new))


def conv_lstm_phased(c0: torch.Tensor, h0: torch.Tensor, gx: torch.Tensor,
                     w4: torch.Tensor, tau: torch.Tensor, phase: torch.Tensor,
                     t: torch.Tensor, leak: float = LEAK,
                     ratio_on: float = RATIO_ON
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h_t, h_new, c_new) [B, H, W, C] of the phased ConvLSTM cell: K4 for
    CUDA tensors, ``conv_lstm_phased_plain`` for CPU tensors.  Inference
    only: raises when autograd would need a gradient."""
    gru_hside.check_lstm(c0, h0, gx, w4)
    B, H, W, C = c0.shape
    for name, v in (("tau", tau), ("phase", phase)):
        if tuple(v.shape) != (H, W, C) or v.device != c0.device:
            raise ValueError(f"{name} must be [{H}, {W}, {C}] on {c0.device}, "
                             f"got {tuple(v.shape)} on {v.device}")
    if t.numel() != B or t.device != c0.device:
        raise ValueError(f"t must hold {B} times on {c0.device}")
    gru_hside.raise_under_autograd("conv_lstm_phased", c0, h0, gx, w4, tau,
                                   phase, t)
    if gru_hside._device_of(c0) == "cpu":
        return conv_lstm_phased_plain(c0, h0, gx, w4, tau, phase, t, leak,
                                      ratio_on)
    with torch.cuda.device(c0.device):
        out = gru_hside.launch_lstm(
            c0, h0, gx, w4, (tau, phase, t.reshape(B).float(), leak, ratio_on))
    conv_lstm_phased.launches += 1
    return out


conv_lstm_phased.launches = 0
