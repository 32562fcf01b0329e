"""The phased ConvLSTM cell: the ConvLSTM h-side completion and the time
gate's blend in one launch (kernel K4), its residual variant for training
(K4-res) and the autograd.Function over them.

Counterpart of ``rpg_ramnet_tpu/ops/phased_cell.py``
(``conv_lstm_phased_fused``: Pallas ``_run_phased``/``_phased_kernel``,
``_phased_kernel_res``, and the custom VJP ``_phased_cell``).  The kernel
is ``csrc/lstm_hside.cu`` with its phased flag (and its acts flag);
its header says what bounds it on an H100 and what the design does about
it.

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
permuted once, or a differentiable permute under autograd); t [B]
float32.  ``conv_lstm_phased`` runs K4 for CUDA tensors and
``conv_lstm_phased_plain`` for CPU tensors; when a gradient is needed it
runs ``PhasedCell``, whose forward runs K4-res and whose backward is
``_phased_cell_bwd``'s: the blend chain, the time gate's gradients by
autograd through ``gate_k``, and the ConvLSTM backward
(``gru_hside.conv_lstm_hside_bwd``) with slot-swapped cotangents.
``conv_lstm_phased.launches`` and ``conv_lstm_phased_res.launches`` count
K4's and K4-res's launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.layout import to_nchw, to_nhwc
from . import gru_hside

LEAK, RATIO_ON = 0.001, 0.1     # the reference's PhasedLSTMCell defaults


def gate_k(tau: torch.Tensor, phase: torch.Tensor, t: torch.Tensor,
           leak: float = LEAK, ratio_on: float = RATIO_ON) -> torch.Tensor:
    """The time gate's openness k(t) in float32 (float64 for float64
    inputs, for gradcheck), by broadcasting: tau and phase per feature, t
    per batch item (shaped to broadcast against them).  The same scalar
    operations as the JAX ``phased_gate_k``, with its subgradients: fmod's
    with respect to the divisor is -trunc(a/b) in both, and |x| is written
    as where(x >= 0, x, -x), whose gradient at 0 is +1 as JAX's abs
    (torch.abs gives 0 there)."""
    dt = torch.promote_types(torch.promote_types(tau.dtype, phase.dtype),
                             torch.promote_types(t.dtype, torch.float32))
    tau, phase = tau.to(dt), phase.to(dt)
    r = torch.fmod(t.to(dt) - phase, tau)
    phi = torch.where(r >= 0, r, -r) / tau
    k_up = 2.0 * phi / ratio_on
    k = torch.where(phi < ratio_on, 2.0 - k_up, leak * phi)
    return torch.where(phi < 0.5 * ratio_on, k_up, k)


def _phased_plain(c0, h0, gx, w4, tau, phase, t, leak, ratio_on):
    """(h_t, h_new, c_new, (i, f, o, u)) NCHW in the work dtype."""
    gates = gru_hside.lstm_gates_plain(c0, gx, w4)
    i, f, o, u = gates
    dt = i.dtype
    h0f, c0f = to_nchw(h0).to(dt), to_nchw(c0).to(dt)
    h_t = f * h0f + i * u
    c_t = o * torch.tanh(h_t)
    k = gate_k(to_nchw(tau[None]), to_nchw(phase[None]),
               t.reshape(-1, 1, 1, 1), leak, ratio_on).to(dt)
    return (h_t, k * h_t + (1.0 - k) * h0f, k * c_t + (1.0 - k) * c0f, gates)


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
    out = _phased_plain(c0, h0, gx, w4, tau, phase, t, leak, ratio_on)[:3]
    return tuple(to_nhwc(v.to(c0.dtype)).contiguous() for v in out)


def conv_lstm_phased_res_plain(c0: torch.Tensor, h0: torch.Tensor,
                               gx: torch.Tensor, w4: torch.Tensor,
                               tau: torch.Tensor, phase: torch.Tensor,
                               t: torch.Tensor, leak: float = LEAK,
                               ratio_on: float = RATIO_ON
                               ) -> Tuple[torch.Tensor, ...]:
    """K4-res in plain PyTorch: (h_t, h_new, c_new) as
    ``conv_lstm_phased_plain`` and acts [B, H, W, 4C] = (i, f, o, u)
    rounded to c0's dtype."""
    h_t, h_new, c_new, gates = _phased_plain(c0, h0, gx, w4, tau, phase, t,
                                             leak, ratio_on)
    return tuple(to_nhwc(v.to(c0.dtype)).contiguous()
                 for v in (h_t, h_new, c_new, torch.cat(gates, 1)))


def _check(c0, h0, gx, w4, tau, phase, t) -> None:
    gru_hside.check_lstm(c0, h0, gx, w4)
    B, H, W, C = c0.shape
    for name, v in (("tau", tau), ("phase", phase)):
        if tuple(v.shape) != (H, W, C) or v.device != c0.device:
            raise ValueError(f"{name} must be [{H}, {W}, {C}] on {c0.device}, "
                             f"got {tuple(v.shape)} on {v.device}")
    if t.numel() != B or t.device != c0.device:
        raise ValueError(f"t must hold {B} times on {c0.device}")


def conv_lstm_phased_res(c0: torch.Tensor, h0: torch.Tensor, gx: torch.Tensor,
                         w4: torch.Tensor, tau: torch.Tensor,
                         phase: torch.Tensor, t: torch.Tensor,
                         leak: float = LEAK, ratio_on: float = RATIO_ON,
                         _plan: Optional[gru_hside.LstmPlan] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """(h_t, h_new, c_new, acts): K4-res for CUDA tensors,
    ``conv_lstm_phased_res_plain`` for CPU tensors.
    ``conv_lstm_phased_res.launches`` counts kernel launches.  _plan: a
    ``gru_hside.LstmPlan`` that replaces ``plan_lstm``'s (tests and timing;
    checked on either device)."""
    _check(c0, h0, gx, w4, tau, phase, t)
    if gru_hside._device_of(c0) == "cpu":
        if _plan is not None:
            gru_hside.check_lstm_plan(gru_hside.LstmPlan(*_plan),
                                      c0.shape[-1], phased=True, residuals=True)
        return conv_lstm_phased_res_plain(c0, h0, gx, w4, tau, phase, t, leak,
                                          ratio_on)
    with torch.cuda.device(c0.device):
        out = gru_hside.launch_lstm(
            c0, h0, gx, w4,
            (tau, phase, t.reshape(-1).float(), leak, ratio_on),
            residuals=True, plan=_plan)
    conv_lstm_phased_res.launches += 1
    return out


class PhasedCell(torch.autograd.Function):
    """(h_t, h_new, c_new) = phased cell(c0, h0, gx, w4, tau, phase, t)
    with gradients for every tensor input, the counterpart of the JAX
    ``_phased_cell`` custom VJP.  The forward runs K4-res and saves
    (c0, h0, tau, phase, t, h_t, acts, the weight in c0's dtype) when a
    gradient is needed, K4 otherwise.  The backward, as
    ``_phased_cell_bwd``: c_t = o * tanh(h_t) recomputed; the blend's
    cotangent of k, dk = gh_new (h_t - h0) + gc_new (c_t - c0), taken
    through ``gate_k`` by autograd for dtau, dphase and dt; the ConvLSTM
    backward with the slot swap (residuals (c0, h0, h_t, acts), cotangents
    gc_new k for its hidden' = c_t and gh_t + gh_new k for its cell' =
    h_t); then the blend's direct (1 - k) terms on dc0 and dh0.  The
    weight may be the float32 master (rounded for the kernel, its gradient
    in its own dtype); dgx comes back in gx's dtype."""

    @staticmethod
    def forward(ctx, c0, h0, gx, w4, tau, phase, t, leak=LEAK,
                ratio_on=RATIO_ON):
        wk = w4.to(c0.dtype).contiguous()
        if not any(ctx.needs_input_grad):
            return conv_lstm_phased(c0, h0, gx, wk, tau, phase, t, leak,
                                    ratio_on)
        h_t, h_new, c_new, acts = conv_lstm_phased_res(
            c0, h0, gx, wk, tau, phase, t, leak, ratio_on)
        ctx.save_for_backward(c0, h0, tau, phase, t, h_t, acts, wk)
        ctx.consts = (gx.dtype, w4.dtype, leak, ratio_on)
        return h_t, h_new, c_new

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ht, g_hnew, g_cnew):
        c0, h0, tau, phase, t, h_t, acts, wk = ctx.saved_tensors
        gx_dt, w_dt, leak, ratio_on = ctx.consts
        C = c0.shape[-1]
        wd = gru_hside._work_dtype(c0)
        leaves = [v.detach().to(wd).requires_grad_() for v in (tau, phase, t)]
        with torch.enable_grad():
            k = gate_k(leaves[0][None], leaves[1][None],
                       leaves[2].reshape(-1, 1, 1, 1), leak, ratio_on)
        htf = h_t.to(wd)
        c_t = acts[..., 2 * C:3 * C].to(wd) * torch.tanh(htf)
        ghn, gcn = g_hnew.to(wd), g_cnew.to(wd)
        dk = ghn * (htf - h0.to(wd)) + gcn * (c_t - c0.to(wd))
        dtau, dphase, dt = torch.autograd.grad(k, leaves, dk)
        k = k.detach()
        dc0, dh0, dgx, dw = gru_hside.conv_lstm_hside_bwd(
            (gcn * k).to(h_t.dtype), (g_ht.to(wd) + ghn * k).to(h_t.dtype),
            c0, h0, h_t, acts, wk)
        dc0 = (dc0.to(wd) + gcn * (1.0 - k)).to(c0.dtype)
        dh0 = (dh0.to(wd) + ghn * (1.0 - k)).to(h0.dtype)
        return (dc0, dh0, dgx.to(gx_dt), dw.to(w_dt), dtau.to(tau.dtype),
                dphase.to(phase.dtype), dt.to(t.dtype), None, None)


def conv_lstm_phased(c0: torch.Tensor, h0: torch.Tensor, gx: torch.Tensor,
                     w4: torch.Tensor, tau: torch.Tensor, phase: torch.Tensor,
                     t: torch.Tensor, leak: float = LEAK,
                     ratio_on: float = RATIO_ON,
                     _plan: Optional[gru_hside.LstmPlan] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h_t, h_new, c_new) [B, H, W, C] of the phased ConvLSTM cell.  When
    autograd needs a gradient of any input this is ``PhasedCell``;
    otherwise K4 for CUDA tensors and ``conv_lstm_phased_plain`` for CPU
    tensors.  _plan: a ``gru_hside.LstmPlan`` that replaces
    ``plan_lstm``'s for K4 (tests and timing; checked on either device)."""
    _check(c0, h0, gx, w4, tau, phase, t)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (c0, h0, gx, w4, tau, phase, t)):
        return PhasedCell.apply(c0, h0, gx, w4, tau, phase, t, leak, ratio_on)
    if gru_hside._device_of(c0) == "cpu":
        if _plan is not None:
            gru_hside.check_lstm_plan(gru_hside.LstmPlan(*_plan),
                                      c0.shape[-1], phased=True)
        return conv_lstm_phased_plain(c0, h0, gx, w4, tau, phase, t, leak,
                                      ratio_on)
    with torch.cuda.device(c0.device):
        out = gru_hside.launch_lstm(
            c0, h0, gx, w4,
            (tau, phase, t.reshape(-1).float(), leak, ratio_on), plan=_plan)
    conv_lstm_phased.launches += 1
    return out


conv_lstm_phased.launches = 0
conv_lstm_phased_res.launches = 0
