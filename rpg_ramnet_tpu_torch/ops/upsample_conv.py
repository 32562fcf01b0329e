"""The fused decoder layer: bilinear 2x upsample + 5x5 conv + bias + ReLU,
with the skip sum fused in (kernel K8).

Counterpart of ``rpg_ramnet_tpu/ops/upsample_conv.py``
(``upsample_conv_fused``: Pallas ``_run``/``_kernel``):

    out = relu(conv5x5(upsample2x_bilinear(x + skip), W) + b)

the reference's UpsampleConvLayer (RAM_Net/model/submodules.py:69-97) on
the sum skip, with the resize's half-pixel centres and edge clamp and the
conv's zero padding.  The CUDA kernel (``csrc/upsample_conv.cu``) never
forms the 2x image: it runs the four 4x4 phase kernels (``phase_weights``)
over the clamped low-res tile and subtracts the border terms
(``edge_weights``) at the image's edge pixels; its header says what
bounds it and what the design does about it.  It runs
where ``models/statenet.py::forward_decoder_supers`` is allowed it and
``fused_decoder='on'``.

Tensors are NHWC: x, skip [B, H, W, C], out [B, 2H, 2W, Cout].  The layer
is an ``UpsampleConvLayer`` (its kernel-layout weights cached per weight
version and dtype, ``UpsampleConvLayer.fused_weights``) or a (w, b) pair,
w OIHW [Cout, C, 5, 5].  The wrapper runs the plain version
(``upsample_conv_fused_plain``, the two-stage layer) for a tensor on the
CPU and launches the kernel for a CUDA tensor, or raises.  Inference
only, as the JAX kernel (no VJP): it raises under autograd.
``upsample_conv_fused.launches`` counts K8's launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.layout import to_nchw, to_nhwc
from . import gru_hside

_P, _I = gru_hside._P, gru_hside._I
_SIGNATURES = {
    "ramnet_upsample_conv_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _P)),
    **gru_hside._ERR,
}
SOURCES = ("upsample_conv",)
TILE = 16          # low-res tile of one block: 16 x 16 pixels (32 x 32 out)
NC = 32            # output channels of one block, per phase
SLAB = 16          # input channels it stages per pass
_MAX_BLOCKS_Z = 65535

# Half-pixel bilinear 2x composed with the conv's 5 taps along one axis
# (JAX layers._S0/_S1): 2x row 2i + p = sum_a S[p][a, u] w[u] applied to
# the low-res rows i + a - 2 + p, a = 0..3, the rows clamped to the image.
_S = torch.tensor([[[0.25, 0.00, 0.00, 0.00, 0.00],
                    [0.75, 0.75, 0.25, 0.00, 0.00],
                    [0.00, 0.25, 0.75, 0.75, 0.25],
                    [0.00, 0.00, 0.00, 0.25, 0.75]],
                   [[0.75, 0.25, 0.00, 0.00, 0.00],
                    [0.25, 0.75, 0.75, 0.25, 0.00],
                    [0.00, 0.00, 0.25, 0.75, 0.75],
                    [0.00, 0.00, 0.00, 0.00, 0.25]]])
# The conv's taps (ky or kx) that fall outside the 2x image, by phase p of
# the output's first two rows (2x rows 0, 1: _FIRST) and last two (2H-2,
# 2H-1: _LAST); columns alike.
_FIRST = ((0, 1), (0,))
_LAST = ((4,), (3, 4))
# blocks of [Cout_pad, C] in the kernel's weight tensor: the phase kernels
# [p][a][q][b]; the edge terms [side: top, bottom, left, right][p][q][tap];
# the corner terms [top-left, top-right, bottom-left, bottom-right][p][q]
_N_MAIN, _N_EDGE, _N_CORNER = 64, 64, 16


def library():
    """The built and loaded K8 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("upsample_conv", _SIGNATURES)


def supports(x: torch.Tensor, cout: int,
             skip: Optional[torch.Tensor] = None) -> bool:
    """Whether K8 takes this NHWC input (and skip) and Cout: bf16, 4-D,
    contiguous (channels_last memory of the NCHW view: the wrapper
    copies nothing), C a multiple of 16 (the mma k-step), Cout a multiple
    of 8 (the mma n-tile) and the grid's batch dimension within CUDA's;
    skip None or of x's shape, dtype and layout."""
    if (x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or x.shape[-1] % SLAB or cout % 8
            or x.shape[0] * -(-cout // NC) > _MAX_BLOCKS_Z):
        return False
    return skip is None or (skip.shape == x.shape and skip.dtype == x.dtype
                            and skip.is_contiguous())


def phase_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW w [Cout, C, 5, 5] -> the four phase kernels [2 (p), 2 (q),
    4 (a), 4 (b), Cout, C] in float32: output pixel (2i + p, 2j + q) of the
    layer, away from the border, is sum_{a,b} Wp[p, q, a, b] @ s[i + a - 2
    + p, j + b - 2 + q] over the low-res s, clamped to the image (JAX
    ``layers._phase_kernels``, there [4, 4, C, Cout] per (p, q))."""
    S = _S.to(w.device)
    return torch.einsum("pau,oiuv,qbv->pqaboi", S, w.float(), S)


def _taps(taps, axis: int, w: torch.Tensor) -> torch.Tensor:
    return w.index_select(axis, torch.tensor(taps, device=w.device)).sum(axis)


def border_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The sums of w over its taps that fall outside the 2x image at the
    border, float32, from OIHW w [Cout, C, 5, 5]:
    rows [2 (first, last), 2 (p), 5 (kx), Cout, C]: over ky, at 2x rows
    p and 2H - 2 + p (JAX ``prep_weights``'s c_first / c_last);
    cols [2 (first, last), 2 (q), 5 (ky), Cout, C]: over kx, alike;
    corners [2 (first, last row), 2 (first, last col), 2 (p), 2 (q), Cout,
    C]: over both."""
    wf = w.float().permute(2, 3, 0, 1)                  # [ky, kx, Cout, C]
    rows = torch.stack([torch.stack([_taps(t, 0, wf) for t in side])
                        for side in (_FIRST, _LAST)])
    cols = torch.stack([torch.stack([_taps(t, 1, wf) for t in side])
                        for side in (_FIRST, _LAST)])
    corners = torch.stack([torch.stack([torch.stack([torch.stack(
        [_taps(tx, 0, _taps(ty, 0, wf)) for tx in hs]) for ty in vs])
        for hs in (_FIRST, _LAST)]) for vs in (_FIRST, _LAST)])
    return rows, cols, corners


def edge_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The border terms in the phase form, float32: edges [4 (top,
    bottom, left, right), 2 (p), 2 (q), 4 (tap), Cout, C] and corners
    [4 (top-left, top-right, bottom-left, bottom-right), 2 (p), 2 (q),
    Cout, C].  On the image's first low-res row (i = 0) the phase form
    over-counts sum_b edges[0, p, q, b] @ s[0, j + b - 2 + q] (the taps
    above the 2x image, which the clamped tile extends by the
    column-upsampled row 0); on the last row edges[1] alike; on the first
    and last columns edges[2], edges[3] with the tap a over rows
    i + a - 2 + p of column 0 (W - 1); at the four corner pixels the
    corner taps, counted in both an edge row and an edge column, come back
    as corners[k, p, q] @ s[corner]:

        out = phase - top - bottom - left - right + the corners
    """
    S = _S.to(w.device)
    rows, cols, corners = border_weights(w)
    top_bottom = torch.einsum("spvoi,qbv->spqboi", rows, S)
    left_right = torch.einsum("squoi,pau->spqaoi", cols, S)
    return (torch.cat([top_bottom, left_right]),
            corners.reshape(4, 2, 2, *w.shape[:2]))


def kernel_weights(w: torch.Tensor, b: Optional[torch.Tensor],
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weights: from OIHW w [Cout, C, 5, 5], the phase kernels
    (as [p][a][q][b]), the edge terms negated and the corner terms, each a
    [Cout_pad, C] block (zero past Cout), composed in float32 and rounded
    to ``dtype``: [144, Cout_pad, C], K-contiguous (the tensor cores' B
    operand); and the bias [Cout] rounded to ``dtype`` as the plain layer
    rounds it, in float32 (zeros when b is None)."""
    cout, C = w.shape[:2]
    edges, corners = edge_weights(w)
    blocks = torch.cat([
        phase_weights(w).permute(0, 2, 1, 3, 4, 5).reshape(_N_MAIN, cout, C),
        -edges.reshape(_N_EDGE, cout, C),
        corners.reshape(_N_CORNER, cout, C)])
    wk = F.pad(blocks, (0, 0, 0, -cout % NC)).to(dtype)
    bk = (torch.zeros(cout, device=w.device) if b is None
          else b.to(dtype).float().contiguous())
    return wk.contiguous(), bk


def _weights(layer_or_w_b) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if isinstance(layer_or_w_b, (tuple, list)):
        return tuple(layer_or_w_b)
    conv = layer_or_w_b.conv2d
    return conv.weight, conv.bias


def _activate(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    return torch.relu(y) if activation == "relu" else y


def upsample_conv_fused_plain(w: torch.Tensor, b: Optional[torch.Tensor],
                              x: torch.Tensor,
                              skip: Optional[torch.Tensor] = None,
                              activation: Optional[str] = "relu"
                              ) -> torch.Tensor:
    """K8's function in plain PyTorch, in x's dtype: the sum, the library
    bilinear resize (align_corners=False) and the library conv with w and
    b rounded to x's dtype, then the activation ('relu' or None); NHWC
    in and out.  The two-stage layer itself: the CPU implementation of
    ``upsample_conv_fused`` and the kernel's oracle on the card."""
    s = x if skip is None else x + skip.to(x.dtype)
    up = F.interpolate(to_nchw(s), scale_factor=2, mode="bilinear",
                       align_corners=False)
    y = F.conv2d(up, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 1, 2)
    return to_nhwc(_activate(y, activation))


def _check(w, b, x, skip, activation) -> None:
    if activation not in ("relu", None):
        raise ValueError(f"activation must be 'relu' or None, got "
                         f"{activation!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C], got {tuple(x.shape)}")
    C = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[1:]) != (C, 5, 5):
        raise ValueError(f"w must be OIHW [Cout, {C}, 5, 5], got "
                         f"{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"b must be [{w.shape[0]}], got {tuple(b.shape)}")
    if skip is not None and skip.shape != x.shape:
        raise ValueError(f"skip must be {tuple(x.shape)}, got "
                         f"{tuple(skip.shape)}")
    for name, t in (("w", w), ("b", b), ("skip", skip)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch(layer_or_w_b, w, b, x, skip, relu: bool,
            border_terms: bool) -> torch.Tensor:
    B, H, W, C = x.shape
    cout = w.shape[0]
    if not supports(x, cout, skip):
        raise ValueError(
            "the K8 kernel takes bf16 NHWC-contiguous x (and skip of its "
            "shape and layout), C % 16 == 0 and Cout % 8 == 0; got "
            f"{x.dtype} {tuple(x.shape)} strides {x.stride()}, Cout {cout}"
            + ("" if skip is None else f", skip strides {skip.stride()}"))
    wk, bk = (layer_or_w_b.fused_weights(x.dtype)
              if hasattr(layer_or_w_b, "fused_weights")
              else kernel_weights(w, b, x.dtype))
    tensors = (x, wk) if skip is None else (x, skip, wk)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel's tensors must be 16-byte aligned")
    lib = library()
    out = torch.empty((B, 2 * H, 2 * W, cout), dtype=x.dtype, device=x.device)
    err = lib.ramnet_upsample_conv_forward(
        x.data_ptr(), None if skip is None else skip.data_ptr(),
        wk.data_ptr(), bk.data_ptr(), out.data_ptr(), B, H, W, C, cout,
        wk.shape[1], NC, int(relu), int(border_terms),
        torch.cuda.current_stream(x.device).cuda_stream)
    gru_hside._raise_on(err, lib, "upsample_conv")
    upsample_conv_fused.launches += 1
    return out


def upsample_conv_fused(layer_or_w_b, x: torch.Tensor,
                        skip: Optional[torch.Tensor] = None,
                        activation: Optional[str] = "relu", *,
                        border_terms: bool = True) -> torch.Tensor:
    """relu(conv5x5(upsample2x_bilinear(x + skip), W) + b) [B, 2H, 2W,
    Cout] from NHWC x and skip [B, H, W, C] and an ``UpsampleConvLayer``
    or a (w OIHW, b) pair: K8 for CUDA tensors (raises where ``supports``
    does not hold), ``upsample_conv_fused_plain`` for CPU tensors.
    activation: 'relu' or None.  border_terms=False makes the kernel skip
    its border terms, so the outer two 2x rows and columns are wrong:
    only to time their share (CPU tensors raise).  Inference only: raises
    when autograd would need a gradient."""
    w, b = _weights(layer_or_w_b)
    _check(w, b, x, skip, activation)
    gru_hside.raise_under_autograd(
        "upsample_conv_fused", *(t for t in (x, skip, w, b) if t is not None),
        why="as the JAX kernel, it has no VJP")
    if gru_hside._device_of(x) == "cpu":
        if not border_terms:
            raise ValueError("border_terms=False is the kernel's alone")
        return upsample_conv_fused_plain(w, b, x, skip, activation)
    with torch.cuda.device(x.device):
        return _launch(layer_or_w_b, w, b, x, skip, activation == "relu",
                       border_terms)


upsample_conv_fused.launches = 0
