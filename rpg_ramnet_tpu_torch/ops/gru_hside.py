"""The fused ConvGRU h-side cell (kernel K1): wrapper, plain version, count.

Counterpart of ``rpg_ramnet_tpu/ops/gru_hside.py::conv_gru_hside_fused``
(Pallas ``_run``/``_kernel``).  The CUDA kernel is ``csrc/gru_hside.cu``; its
header says what bounds it on an H100 and what the design does about it.

    z, r = sigmoid(conv3x3(h, W_ur) + gx[..., :2C])
    o    = tanh(conv3x3(bf16(r * h), W_o) + gx[..., 2C:])
    h'   = h * (1 - z) + o * z

Tensors are NHWC: h [B, H, W, C], gx [B, H, W, 3C] in (update, reset, out)
order with the biases folded in (``ConvGRU.x_gates``), and the h slices of
the gate weights folded by ``ConvGRU.hside_weights``: w_ur [9, 2C, C]
(update rows, then reset rows) and w_o [9, C, C], indexed (ky*3 + kx, out,
in): the tensor cores' B operand, contiguous along the contraction.

``conv_gru_hside`` runs ``conv_gru_hside_plain`` for a tensor on the CPU and
the kernel for a CUDA tensor; on a CUDA tensor it launches or raises.  The
kernel takes C % 16 == 0 (one mma k-step of channels); the plain version
any C % 8 == 0.  The kernel has no backward yet.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.layout import to_nchw, to_nhwc

# H x W output tiles the wrapper chooses from, largest first.  A block holds
# the h tile with a 2-pixel halo and a = r*h with a 1-pixel ring in shared
# memory; smaller tiles recompute more of the ring but give more blocks.
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
_SMEM_MAX = 232448           # bytes a block may use on Hopper
_SMEM_TWO_BLOCKS = 110 * 1024
_MIN_BLOCKS = 128            # about one block per SM of the 132

_TRAINING_NOT_PORTED = (
    "conv_gru_hside has no backward yet: the residual variant and its "
    "autograd.Function come with training (ROADMAP queue 2, K1 residual "
    "variant + queue 1, training).  Call it under torch.no_grad() or "
    "torch.inference_mode().")


def smem_bytes(tile_h: int, tile_w: int, C: int) -> int:
    """The h tile with its 2-pixel halo and the a tile with its 1-pixel
    ring, bf16, at the kernel's pixel pitch of C + 8."""
    return ((tile_h + 4) * (tile_w + 4) + (tile_h + 2) * (tile_w + 2)) \
        * (C + 8) * 2


def pick_tile(B: int, H: int, W: int, C: int) -> Optional[Tuple[int, int]]:
    """The largest tile that leaves room for two blocks per SM and still
    gives about one block per SM; else the smallest tile that fits.  None
    when no tile fits in shared memory."""
    fits = [t for t in _TILES if smem_bytes(*t, C) <= _SMEM_MAX]
    if not fits:
        return None
    for th, tw in fits:
        blocks = B * math.ceil(H / th) * math.ceil(W / tw)
        if smem_bytes(th, tw, C) <= _SMEM_TWO_BLOCKS and blocks >= _MIN_BLOCKS:
            return th, tw
    return fits[-1]


def supports(h: torch.Tensor) -> bool:
    """Whether the kernel takes this NHWC state's dtype and shape: bf16,
    4-D, C a multiple of 16 and a tile that fits in shared memory."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0 and pick_tile(*h.shape) is not None)


def conv_gru_hside_plain(h: torch.Tensor, gx: torch.Tensor,
                         w_ur: torch.Tensor, w_o: torch.Tensor
                         ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the convs and gates in
    float32 on the inputs' values, a = r*h rounded to h's dtype before the
    out-gate conv, h' rounded to h's dtype.  The CPU implementation of
    ``conv_gru_hside`` and the kernel's oracle on the card."""
    C = h.shape[-1]

    def unfold(w):  # [9, O, C] -> OIHW [O, C, 3, 3]
        return w.float().reshape(3, 3, -1, C).permute(2, 3, 0, 1)

    hf = to_nchw(h).float()
    g = to_nchw(gx).float()
    ur = torch.sigmoid(F.conv2d(hf, unfold(w_ur), None, 1, 1) + g[:, :2 * C])
    z, r = ur[:, :C], ur[:, C:]
    a = (r * hf).to(h.dtype).float()
    o = torch.tanh(F.conv2d(a, unfold(w_o), None, 1, 1) + g[:, 2 * C:])
    return to_nhwc((hf * (1.0 - z) + o * z).to(h.dtype)).contiguous()


def _check(h, gx, w_ur, w_o) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, gx, w_ur, w_o)):
        raise NotImplementedError(_TRAINING_NOT_PORTED)
    if h.dim() != 4:
        raise ValueError(f"h must be NHWC [B, H, W, C], got {tuple(h.shape)}")
    B, H, W, C = h.shape
    if C % 8:
        raise ValueError(f"C must be a multiple of 8, got {C}")
    for name, t, shape in (("gx", gx, (B, H, W, 3 * C)),
                           ("w_ur", w_ur, (9, 2 * C, C)),
                           ("w_o", w_o, (9, C, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")


_SIGNATURES = {
    "ramnet_gru_hside_forward": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p)),
    "ramnet_cuda_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def library():
    """The built and loaded kernel library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_hside", _SIGNATURES)


def _launch(h, gx, w_ur, w_o) -> torch.Tensor:
    if not (h.dtype == gx.dtype == w_ur.dtype == w_o.dtype == torch.bfloat16):
        raise TypeError("the CUDA kernel takes bf16 h, gx and weights; got "
                        f"{h.dtype}, {gx.dtype}, {w_ur.dtype}, {w_o.dtype}")
    B, H, W, C = h.shape
    if C % 16:
        raise ValueError(f"the CUDA kernel takes C % 16 == 0, got C={C}")
    if not (h.is_contiguous() and w_ur.is_contiguous()
            and w_o.is_contiguous()):
        raise ValueError("h, w_ur and w_o must be contiguous")
    if gx.stride()[1:] != (W * 3 * C, 3 * C, 1):
        raise ValueError("gx must be contiguous within each batch item "
                         f"(strides {gx.stride()})")
    gx_bstride = gx.stride(0) if B > 1 else H * W * 3 * C
    if gx_bstride % 8 or any(t.data_ptr() % 16 for t in (h, gx, w_ur, w_o)):
        raise ValueError("h, gx and the weights must be 16-byte aligned")
    tile = pick_tile(B, H, W, C)
    if tile is None:
        raise ValueError(f"C={C} does not fit the kernel's shared memory")
    lib = library()
    out = torch.empty_like(h)
    err = lib.ramnet_gru_hside_forward(
        h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
        out.data_ptr(), B, H, W, C, gx_bstride, tile[0], tile[1],
        torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError("gru_hside kernel launch failed: "
                           + lib.ramnet_cuda_error_string(err).decode())
    conv_gru_hside.launches += 1
    return out


def conv_gru_hside(h: torch.Tensor, gx: torch.Tensor, w_ur: torch.Tensor,
                   w_o: torch.Tensor) -> torch.Tensor:
    """h' [B, H, W, C] from NHWC h, gx and the folded weights: the CUDA
    kernel for CUDA tensors, ``conv_gru_hside_plain`` for CPU tensors.
    ``conv_gru_hside.launches`` counts kernel launches."""
    _check(h, gx, w_ur, w_o)
    if h.device.type == "cpu":
        return conv_gru_hside_plain(h, gx, w_ur, w_o)
    if h.device.type != "cuda":
        raise ValueError(f"no implementation for device {h.device}")
    with torch.cuda.device(h.device):
        return _launch(h, gx, w_ur, w_o)


conv_gru_hside.launches = 0
