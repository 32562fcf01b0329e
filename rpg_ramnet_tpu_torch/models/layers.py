"""Conv layers and the ConvGRU cell of the ported slice, as nn.Modules.

Counterpart of ``rpg_ramnet_tpu/models/layers.py`` (the flagship subset).
Module and parameter names follow the upstream torch modules
(RAM_Net/model/submodules.py), which are also the names
``compat.params_to_state_dict`` emits for JAX params, so a reference
state dict loads with ``strict=True``.

    JAX function                         port
    conv2d / conv_layer_apply            ConvLayer.forward
    _apply_norm, _train_bn, _train_in    Norm.forward (NormCtx: training)
    extract_norm_stats                   extract_norm_stats
    merge_norm_stats                     merge_norm_stats
    upsample2x_bilinear                  upsample2x_bilinear
    upsample_conv_layer_apply            UpsampleConvLayer.forward
    upsample_conv_layer_fast_apply       upsample_conv_layer_fast
    transposed_conv_layer_apply          TransposedConvLayer.forward
    compose_upsample_conv_kernel         compose_upsample_conv_kernel
                                         (UpsampleConvLayer.composed_weights)
    upsample_conv_layer_composed_apply   upsample_conv_layer_composed
    the fold of upsample_conv_fused      UpsampleConvLayer.fused_weights (K8)
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
    recurrent2_conv_layer_apply          Recurrent2ConvLayer.forward
    phased_lstm_gate_init                PhasedLSTMGate
    phased_gate_k                        phased_gate_k
    phased_conv_lstm_apply               PhasedConvLSTM.forward
    recurrent_phased_conv_layer_apply    RecurrentPhasedConvLayer.forward

Parameters stay float32 (the masters an optimizer updates); every layer
casts its weights to its input's dtype at use, as the JAX layers do
(``conv2d``: ``w.astype(x.dtype)``), so one model serves float32 and bf16
compute, training and inference.  A norm computes in float32 and returns
its input's dtype (JAX's norms promote a bf16 input to float32 through
the float32 running stats and affine weights, so everything after them
runs in float32 there: ROADMAP queue 3).

Norms (``norm`` 'BN' or 'IN', JAX layers.py:129-249) run in eval mode,
on the running stats, unless a layer is given a ``NormCtx``: then they
normalize by the batch's statistics and put the updated running stats
into the ctx, never into the buffers, so a recompute under
torch.utils.checkpoint cannot update them twice.  The caller writes them
back (``merge_norm_stats``) after the step.

Modules take and return NCHW-shaped tensors.  The model keeps them in
``torch.channels_last`` memory, which is physically the JAX package's NHWC:
``utils.layout.to_nchw``/``to_nhwc`` are the only layout conversions in the
package and are views, not copies.  A ConvLayer also takes an
NCHW-contiguous input (the channel-first head input of the JAX
``input_layout='NCHW'``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.phased_cell import conv_lstm_phased, gate_k
from ..ops.upsample_conv import kernel_weights
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


NORM_MOMENTUM = 0.1
NORM_EPS = 1e-5


class NormCtx:
    """Training-mode norms' running stats, carried as values (JAX
    layers.py:151-178).  ``stats``: {key: {'running_mean', 'running_var'}}
    at the start of the carried span (``extract_norm_stats``); ``out``
    collects the updates of the norms that ran, so a norm applied several
    times (the event encoders, K times per package) sees its own earlier
    update, in call order (``fetch``).  ``merged()`` is the stats after
    the span."""

    def __init__(self, stats: Dict[str, Dict[str, torch.Tensor]]):
        self.stats = stats
        self.out: Dict[str, Dict[str, torch.Tensor]] = {}

    def fetch(self, key: str, norm: "Norm") -> Dict[str, torch.Tensor]:
        if key in self.out:
            return self.out[key]
        if key in self.stats:
            return self.stats[key]
        return {"running_mean": norm.running_mean,
                "running_var": norm.running_var}

    def update(self, key: str, norm: "Norm", mean: torch.Tensor,
               var: torch.Tensor) -> None:
        """Momentum update of ``key``'s stats by a batch's mean and
        unbiased variance (float32 [C], detached)."""
        old, m = self.fetch(key, norm), NORM_MOMENTUM
        self.out[key] = {
            "running_mean": (1 - m) * old["running_mean"] + m * mean,
            "running_var": (1 - m) * old["running_var"] + m * var}

    def merged(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {**self.stats, **self.out}


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.float().view(1, -1, 1, 1)


class Norm(nn.Module):
    """BatchNorm2d (affine, 'BN') or InstanceNorm2d(track_running_stats=
    True) (non-affine, 'IN') as upstream's ConvLayer has them
    (submodules.py:13-24), with the buffers ``running_mean`` and
    ``running_var`` and no ``num_batches_tracked``: the momentum is fixed,
    so the count is never read, and a state dict then has exactly the
    names JAX's ``params_to_state_dict`` gives (a reference checkpoint's
    counts are dropped on load, ``compat.load_reference_checkpoint``).
    ``key``: the norm's dotted path in its network (JAX's param path),
    which names its stats in a NormCtx; the network sets it
    (``name_norms``)."""

    def __init__(self, kind: str, channels: int):
        super().__init__()
        if kind not in ("BN", "IN"):
            raise KeyError(f"unknown norm {kind!r}")
        self.kind = kind
        self.key = ""
        if kind == "BN":
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters_(self) -> None:
        """torch's init, as the constructor's: weight 1, bias 0, running
        stats (0, 1) (a model built on the meta device needs it)."""
        with torch.no_grad():
            if self.kind == "BN":
                self.weight.fill_(1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, ctx: Optional[NormCtx] = None
                ) -> torch.Tensor:
        """NCHW-shaped x in, x's dtype out.  Without ctx (eval,
        ``_apply_norm``): normalized by the running stats, then BN's
        affine.  With ctx (training, ``_train_bn``/``_train_in``): by the
        batch's biased statistics, over (N, H, W) for BN and per instance
        over (H, W) for IN, and the ctx's stats move by the momentum
        towards the unbiased variance and the mean (IN: their batch
        means)."""
        xf = x.float()
        if ctx is None:
            y = ((xf - _per_channel(self.running_mean))
                 * torch.rsqrt(_per_channel(self.running_var) + NORM_EPS))
        else:
            dims = (0, 2, 3) if self.kind == "BN" else (2, 3)
            m = xf.mean(dims, keepdim=True)
            v = (xf - m).square().mean(dims, keepdim=True)
            y = (xf - m) * torch.rsqrt(v + NORM_EPS)
            n = math.prod(x.shape[d] for d in dims)
            unbiased = v.detach() * (n / max(n - 1, 1))
            # [1 or B, C, 1, 1] -> [C] (IN: the batch mean of its stats)
            ctx.update(self.key, self, m.detach().mean((0, 2, 3)),
                       unbiased.mean((0, 2, 3)))
        if self.kind == "BN":
            y = y * _per_channel(self.weight) + _per_channel(self.bias)
        return y.to(x.dtype)


def instance_norm_plain(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d() without running stats or affine (the residual
    blocks' IN, submodules.py:193-194): per-instance biased statistics in
    training and eval alike, in float32, returned in x's dtype."""
    xf = x.float()
    m = xf.mean((2, 3), keepdim=True)
    v = (xf - m).square().mean((2, 3), keepdim=True)
    return ((xf - m) * torch.rsqrt(v + NORM_EPS)).to(x.dtype)


def name_norms(net: nn.Module) -> None:
    """Set every Norm's ``key`` to its dotted path in ``net``."""
    for name, m in net.named_modules():
        if isinstance(m, Norm):
            m.key = name


def extract_norm_stats(net: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """{key: {'running_mean', 'running_var'}} of every Norm of ``net``
    (JAX ``extract_norm_stats``, layers.py:869-888): the stats a training
    window starts from.  The tensors are the buffers themselves."""
    return {m.key: {"running_mean": m.running_mean,
                    "running_var": m.running_var}
            for m in net.modules() if isinstance(m, Norm)}


def merge_norm_stats(net: nn.Module,
                     stats: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy ``stats`` into the buffers of the Norms they name (JAX
    ``merge_norm_stats``, layers.py:891-915); unnamed norms keep theirs."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Norm) and m.key in stats:
                m.running_mean.copy_(stats[m.key]["running_mean"])
                m.running_var.copy_(stats[m.key]["running_var"])


def _norm(norm: Optional[str], channels: int) -> Optional[Norm]:
    return None if norm is None else Norm(norm, channels)


class ConvLayer(nn.Module):
    """Conv, norm, activation (submodules.py:8-35): under BN the conv has
    no bias (submodules.py:13)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding,
                                bias=norm != "BN")
        self.norm_layer = _norm(norm, out_ch)
        self.activation = activation

    def forward(self, x: torch.Tensor, ctx: Optional[NormCtx] = None
                ) -> torch.Tensor:
        y = conv(self.conv2d, x)
        if self.norm_layer is not None:
            y = self.norm_layer(y, ctx)
        return activate(y, self.activation)


class _FoldedGates(nn.Module):
    """A module whose convs (``gates()``: a recurrent cell's gate convs, a
    decoder layer's conv) are folded into the kernels' weight layouts,
    cached per weight version and dtype."""

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


class UpsampleConvLayer(_FoldedGates):
    """Bilinear x2 then conv, norm, activation (submodules.py:69-97).  Its
    weights also come folded for the fused decoder kernel K8
    (``fused_weights``) and composed for the transposed-conv formulation
    (``composed_weights``), both of which the decoder takes norm-free
    only."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 padding: int = 0, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv2d = nn.Conv2d(in_ch, out_ch, kernel_size, 1, padding,
                                bias=norm != "BN")
        self.norm_layer = _norm(norm, out_ch)
        self.activation = activation

    def gates(self):
        return (self.conv2d,)

    def finish(self, y: torch.Tensor, ctx: Optional[NormCtx] = None
               ) -> torch.Tensor:
        """The norm and the activation on the conv's output."""
        if self.norm_layer is not None:
            y = self.norm_layer(y, ctx)
        return activate(y, self.activation)

    def forward(self, x: torch.Tensor, ctx: Optional[NormCtx] = None
                ) -> torch.Tensor:
        return self.finish(conv(self.conv2d, upsample2x_bilinear(x)), ctx)

    def fused_weights(self, dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The phase, edge and corner weights [144, Cout_pad, C] in
        ``dtype`` and the bias [Cout] in float32, in the layout of
        ops.upsample_conv.kernel_weights (K8); cached per weight version
        and dtype."""
        return self._folded("fused", dtype, lambda ws, dt: kernel_weights(
            ws[0], self.conv2d.bias, dt))

    def composed_weights(self, dtype: torch.dtype) -> torch.Tensor:
        """``compose_upsample_conv_kernel`` of the weight, in ``dtype``;
        cached per weight version and dtype, differentiable under
        autograd."""
        return self._folded("composed", dtype, lambda ws, dt:
                            compose_upsample_conv_kernel(ws[0]).to(dt))


# -- composed transposed-conv formulation of bilinear-2x + 5x5 conv ---------
#
# The half-pixel bilinear 2x is a stride-2 transposed conv with the stencil
# c = [.25, .75, .75, .25], so the whole layer is ONE stride-2 transposed
# conv with the composed 8-tap kernel k_eff[t] = sum_d w[d] c[t + d + 1],
# t in [-3, 4], per axis: no 2x intermediate in device memory.  Edge
# padding x by 2 reproduces the resize's clamp; the conv's zero padding at
# the outer 2 rows and columns of the 2x image differs, so those are
# restitched exactly from 4-pixel slabs of the two-stage layer (JAX
# layers.py:345-408).

_C4 = (0.25, 0.75, 0.75, 0.25)     # c[t], t in [-1..2]


def _composed_kernel_1d() -> torch.Tensor:
    """[8, 5]: k_eff's taps t = -3..4 against w's taps d = -2..2."""
    k1 = torch.zeros(8, 5)
    for ti, t in enumerate(range(-3, 5)):
        for di, d in enumerate(range(-2, 3)):
            if 0 <= t + d + 1 < 4:
                k1[ti, di] = _C4[t + d + 1]
    return k1


def compose_upsample_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW w [Cout, C, 5, 5] -> the composed kernel [C, Cout, 8, 8] in
    float32, in ``F.conv_transpose2d``'s layout for stride 2 and padding 7
    on a 2-edge-padded input (JAX ``compose_upsample_conv_kernel`` returns
    the same taps flipped, HWIO, for a dilated correlation)."""
    k1 = _composed_kernel_1d().to(w.device)
    return torch.einsum("au,oiuv,bv->ioab", k1, w.float(), k1)


def upsample_conv_layer_composed(layer: UpsampleConvLayer, x: torch.Tensor,
                                 activation: Optional[str] = "relu"
                                 ) -> torch.Tensor:
    """The two-stage layer (norm-free) as ONE stride-2 transposed conv plus
    the exact border restitch, the counterpart of JAX
    ``upsample_conv_layer_composed_apply``; NCHW-shaped in and out, in x's
    dtype.  Plain library ops, so differentiable; it equals the two-stage
    layer up to float summation order."""
    b = layer.conv2d.bias
    b = None if b is None else b.to(x.dtype)
    # edge padding by 2 as one gather in NHWC, so that x's channels_last
    # memory carries through (the library's replicate pad returns NCHW
    # memory on CUDA, and the NCHW resize of the slabs is several times
    # slower than the NHWC one)
    H, W = x.shape[2:]
    rows = torch.arange(-2, H + 2, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-2, W + 2, device=x.device).clamp(0, W - 1)
    xe = to_nchw(to_nhwc(x)[:, rows[:, None], cols[None, :]])
    y = F.conv_transpose2d(xe, layer.composed_weights(x.dtype), b, stride=2,
                           padding=7)

    def ref_up(xs):
        xs = xs.contiguous(memory_format=torch.channels_last)
        return conv(layer.conv2d, upsample2x_bilinear(xs))

    _restitch_borders(y, ref_up, x)
    return activate(y, activation)


# -- subpixel ("fast upsample") formulation of bilinear-2x + 5x5 conv --------
#
# In the interior the composite is, per output phase, a 4x4 convolution at
# the low resolution: the half-pixel bilinear stencils (0.25, 0.75)
# composed with the 5x5 weights through the 4x5 matrices below.  The outer
# two rows and columns of the 2x image mix the resize's clamp with the
# conv's zero padding, so they are recomputed with the two-stage op on
# 4-pixel slabs and stitched in (JAX layers.py:256-333, computed there
# outside any Pallas kernel: library convolutions here).

_S0 = ((0.25, 0.00, 0.00, 0.00, 0.00),
       (0.75, 0.75, 0.25, 0.00, 0.00),
       (0.00, 0.25, 0.75, 0.75, 0.25),
       (0.00, 0.00, 0.00, 0.25, 0.75))           # dm in {-2..1}
_S1 = ((0.75, 0.25, 0.00, 0.00, 0.00),
       (0.25, 0.75, 0.75, 0.25, 0.00),
       (0.00, 0.00, 0.25, 0.75, 0.75),
       (0.00, 0.00, 0.00, 0.00, 0.25))           # dm in {-1..2}


def fast_phase_kernels(w: torch.Tensor):
    """OIHW w [Cout, C, 5, 5] -> {(p, q): [Cout, C, 4, 4]}, the phase
    kernels of output rows 2i+p and columns 2j+q (JAX ``_phase_kernels``),
    in w's dtype."""
    s = {p: torch.tensor(m, dtype=w.dtype, device=w.device)
         for p, m in ((0, _S0), (1, _S1))}
    return {(p, q): torch.einsum("au,oiuv,bv->oiab", s[p], w, s[q])
            for p in (0, 1) for q in (0, 1)}


def _restitch_borders(y: torch.Tensor, ref_up, x: torch.Tensor) -> None:
    """Overwrite the outer two rows and columns of the 2x output y with
    the two-stage op ``ref_up`` on 4-pixel slabs of x, then the corners
    with 4x4 corner slabs (both clamps interact there)."""
    y[:, :, :2] = ref_up(x[:, :, :4])[:, :, :2]
    y[:, :, -2:] = ref_up(x[:, :, -4:])[:, :, -2:]
    y[..., :2] = ref_up(x[..., :4])[..., :2]
    y[..., -2:] = ref_up(x[..., -4:])[..., -2:]
    y[..., :2, :2] = ref_up(x[..., :4, :4])[..., :2, :2]
    y[..., :2, -2:] = ref_up(x[..., :4, -4:])[..., :2, -2:]
    y[..., -2:, :2] = ref_up(x[..., -4:, :4])[..., -2:, :2]
    y[..., -2:, -2:] = ref_up(x[..., -4:, -4:])[..., -2:, -2:]


def upsample_conv_layer_fast(layer: UpsampleConvLayer, x: torch.Tensor,
                             ctx: Optional[NormCtx] = None) -> torch.Tensor:
    """The exact fast equivalent of ``layer(x, ctx)`` (JAX
    ``upsample_conv_layer_fast_apply``): the interior as four 4x4 phase
    convolutions on the edge-padded low-resolution x, the borders and
    corners restitched from 4-pixel slabs of the two-stage op, then the
    bias, the norm and the activation.  NCHW-shaped in and out, in x's
    dtype; library ops, so differentiable.  It equals the two-stage layer
    up to float summation order."""
    w = layer.conv2d.weight
    n, _, h, wd = x.shape
    xr = F.pad(x, (2, 2, 2, 2), mode="replicate")
    y = x.new_empty((n, w.shape[0], 2 * h, 2 * wd))
    for (p, q), k in fast_phase_kernels(w).items():
        # phase 0 taps dm in {-2..1} (offset 0), phase 1 {-1..2} (offset 1)
        y[:, :, p::2, q::2] = F.conv2d(xr[:, :, p:p + h + 3, q:q + wd + 3],
                                       k.to(x.dtype))

    def ref_up(xs):
        return F.conv2d(upsample2x_bilinear(xs), w.to(x.dtype), None, 1, 2)

    _restitch_borders(y, ref_up, x)
    if layer.conv2d.bias is not None:
        y = y + layer.conv2d.bias.to(y.dtype).view(1, -1, 1, 1)
    return layer.finish(y, ctx)


class TransposedConvLayer(nn.Module):
    """Transposed conv (k 5, stride 2, padding 2, output padding 1), norm,
    activation (submodules.py:38-66); no conv bias under BN.  Its weight
    is torch's (in, out, kh, kw), which ``compat.params_to_state_dict``
    maps JAX's to."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 padding: int = 2, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.transposed_conv2d = nn.ConvTranspose2d(
            in_ch, out_ch, kernel_size, stride=2, padding=padding,
            output_padding=1, bias=norm != "BN")
        self.norm_layer = _norm(norm, out_ch)
        self.activation = activation

    def forward(self, x: torch.Tensor, ctx: Optional[NormCtx] = None
                ) -> torch.Tensor:
        t = self.transposed_conv2d
        b = None if t.bias is None else t.bias.to(x.dtype)
        y = F.conv_transpose2d(x, t.weight.to(x.dtype), b, stride=2,
                               padding=t.padding, output_padding=1)
        if self.norm_layer is not None:
            y = self.norm_layer(y, ctx)
        return activate(y, self.activation)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with an identity skip (submodules.py:182-215).  BN:
    no conv biases, norms ``bn1`` and ``bn2`` with running stats; IN: the
    plain instance norm after each conv, no parameters or stats."""

    def __init__(self, channels: int, norm: Optional[str] = None):
        super().__init__()
        self.norm = norm
        self.conv1 = nn.Conv2d(channels, channels, 3, 1, 1, bias=norm != "BN")
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=norm != "BN")
        if norm == "BN":
            self.bn1 = Norm("BN", channels)
            self.bn2 = Norm("BN", channels)

    def _norm(self, i: int, y: torch.Tensor, ctx: Optional[NormCtx]
              ) -> torch.Tensor:
        if self.norm == "BN":
            return getattr(self, f"bn{i}")(y, ctx)
        if self.norm == "IN":
            return instance_norm_plain(y)
        return y

    def forward(self, x: torch.Tensor, ctx: Optional[NormCtx] = None
                ) -> torch.Tensor:
        out = torch.relu(self._norm(1, conv(self.conv1, x), ctx))
        out = self._norm(2, conv(self.conv2, out), ctx)
        return torch.relu(out + x)


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


class Recurrent2ConvLayer(nn.Module):
    """A 5x5 stride-2 ConvLayer (with the norm), then a ConvLSTM
    (submodules.py:122-142): the ConvLSTM encoders without
    use_phased_arch.  Returns (hidden, (hidden, cell))."""

    def __init__(self, in_ch: int, out_ch: int, norm: Optional[str] = None):
        super().__init__()
        self.conv = ConvLayer(in_ch, out_ch, 5, 2, 2, norm=norm)
        self.recurrent_block = ConvLSTM(out_ch, out_ch)

    def forward(self, x: torch.Tensor, state, ctx: Optional[NormCtx] = None):
        state = self.recurrent_block(self.conv(x, ctx), state)
        return state[0], state


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
        """(tau, phase) permuted to the kernel's [H, W, C], float32,
        contiguous.  Under autograd, permuted anew from the live parameters
        through differentiable ops, so gradients reach them; otherwise
        copies, never aliases of the parameters, cached per parameter
        version."""
        if torch.is_grad_enabled():
            return tuple(v.float().view(c, h, w).permute(1, 2, 0).contiguous()
                         for v in (self.tau, self.phase))
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
        tensors; under autograd the ``PhasedCell`` Function (K4-res) on the
        float32 master weight, folded anew, and the live tau and phase."""
        c0, h0 = state
        C = self.lstm.hidden_size
        if fused:
            gx = self.lstm.x_gates(x)
            h_t, h_new, c_new = conv_lstm_phased(
                to_nhwc(c0), to_nhwc(h0), to_nhwc(gx),
                self.lstm.hside_weights(
                    None if torch.is_grad_enabled() else c0.dtype),
                *self.phased_cell.nhwc(C, self.height, self.width), times)
            return to_nchw(h_t), (to_nchw(h_new), to_nchw(c_new))
        c_t, h_t = self.lstm(x, (c0, h0))
        k = phased_gate_k(self.phased_cell, times, C, *c_t.shape[2:])
        dt = h_t.dtype
        return h_t, ((k * h_t + (1.0 - k) * h0).to(dt),
                     (k * c_t + (1.0 - k) * c0).to(dt))


class RecurrentPhasedConvLayer(nn.Module):
    """RecurrentPhasedConvLayer (submodules.py:145-157): a 5x5 stride-2
    conv with the norm and ReLU, then a PhasedConvLSTM over the post-conv
    feature map (height x width).  Its norm runs in eval mode, in training
    too: JAX passes it no NormCtx (layers.py:834-842; ROADMAP queue 3)."""

    def __init__(self, in_ch: int, out_ch: int, height: int, width: int,
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = ConvLayer(in_ch, out_ch, 5, 2, 2, norm=norm)
        self.recurrent_block = PhasedConvLSTM(out_ch, out_ch, height, width)

    def forward(self, x: torch.Tensor, times: torch.Tensor, state,
                fused: bool = False):
        return self.recurrent_block(self.conv(x), times, state, fused=fused)
