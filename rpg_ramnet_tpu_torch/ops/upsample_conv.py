"""The fused decoder layer: bilinear 2x upsample + 5x5 conv + bias + ReLU,
with the skip sum fused in (kernel K8).

Counterpart of ``rpg_ramnet_tpu/ops/upsample_conv.py``
(``upsample_conv_fused``: Pallas ``_run``/``_kernel``):

    out = relu(conv5x5(upsample2x_bilinear(x + skip), W) + b)

the reference's UpsampleConvLayer (RAM_Net/model/submodules.py:69-97) on
the sum skip, with the resize's half-pixel centres and edge clamp and the
conv's zero padding.  The CUDA kernel (``csrc/upsample_conv.cu``) builds
the 2x tile in shared memory and never writes it to device memory; its
header says what bounds it and what the design does about it.  It runs
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
                                          _I, _I, _I, _P)),
    **gru_hside._ERR,
}
SOURCES = ("upsample_conv",)
TILE = 16          # output tile of one block: 16 x 16 2x pixels
_LO = TILE // 2 + 4    # the low-res tile it stages, with a 2-pixel halo
_HI = TILE + 4         # the 2x tile it builds, with a 2-pixel halo
_MAX_BLOCKS_Z = 65535


def library():
    """The built and loaded K8 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("upsample_conv", _SIGNATURES)


def slab(C: int) -> Optional[int]:
    """Input channels the kernel stages per pass: the largest of 64, 32
    and 16 that divides C (None when none does)."""
    for cs in (64, 32, 16):
        if C % cs == 0:
            return cs
    return None


def smem_bytes(C: int) -> int:
    """Shared memory of one block: the low-res tile (with a 2-pixel halo)
    and the 2x tile (with a 2-pixel halo) of one slab, bf16, at pitch
    slab + 8."""
    return (_LO * _LO + _HI * _HI) * (slab(C) + 8) * 2


def supports(x: torch.Tensor, cout: int,
             skip: Optional[torch.Tensor] = None) -> bool:
    """Whether K8 takes this NHWC input (and skip) and Cout: bf16, 4-D,
    contiguous (channels_last memory of the NCHW view: the wrapper
    copies nothing), C a multiple of 16 (the mma k-step), Cout a multiple
    of 8 (the mma n-tile), the block's shared memory within Hopper's limit
    and the grid's batch dimension within CUDA's; skip None or of x's
    shape, dtype and layout."""
    if (x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or x.shape[-1] % 16 or cout % 8
            or smem_bytes(x.shape[-1]) > gru_hside._SMEM_MAX
            or x.shape[0] * -(-cout // 64) > _MAX_BLOCKS_Z):
        return False
    return skip is None or (skip.shape == x.shape and skip.dtype == x.dtype
                            and skip.is_contiguous())


def kernel_weights(w: torch.Tensor, b: Optional[torch.Tensor],
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weights: OIHW w [Cout, C, 5, 5] -> [25, Cout, C] (tap
    ky*5 + kx, output, input) in ``dtype``, contiguous (the tensor cores'
    B operand), and the bias [Cout] rounded to ``dtype`` as the plain
    layer rounds it, in float32 (zeros when b is None)."""
    wk = (w.permute(2, 3, 0, 1).reshape(25, w.shape[0], w.shape[1])
          .to(dtype).contiguous())
    bk = (torch.zeros(w.shape[0], device=w.device) if b is None
          else b.to(dtype).float().contiguous())
    return wk, bk


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


def _launch(layer_or_w_b, w, b, x, skip, relu: bool) -> torch.Tensor:
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
        slab(C), int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    gru_hside._raise_on(err, lib, "upsample_conv")
    upsample_conv_fused.launches += 1
    return out


def upsample_conv_fused(layer_or_w_b, x: torch.Tensor,
                        skip: Optional[torch.Tensor] = None,
                        activation: Optional[str] = "relu") -> torch.Tensor:
    """relu(conv5x5(upsample2x_bilinear(x + skip), W) + b) [B, 2H, 2W,
    Cout] from NHWC x and skip [B, H, W, C] and an ``UpsampleConvLayer``
    or a (w OIHW, b) pair: K8 for CUDA tensors (raises where ``supports``
    does not hold), ``upsample_conv_fused_plain`` for CPU tensors.
    activation: 'relu' or None.  Inference only: raises when autograd
    would need a gradient."""
    w, b = _weights(layer_or_w_b)
    _check(w, b, x, skip, activation)
    gru_hside.raise_under_autograd(
        "upsample_conv_fused", *(t for t in (x, skip, w, b) if t is not None),
        why="as the JAX kernel, it has no VJP")
    if gru_hside._device_of(x) == "cpu":
        return upsample_conv_fused_plain(w, b, x, skip, activation)
    with torch.cuda.device(x.device):
        return _launch(layer_or_w_b, w, b, x, skip, activation == "relu")


upsample_conv_fused.launches = 0
