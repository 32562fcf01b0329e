"""The cross-scale pair cell: the ConvGRU h-side cell of scales 0 and 1 in
one launch (kernel K9).

Counterpart of ``rpg_ramnet_tpu/ops/gru_pair.py`` (``conv_gru_hside_pair``:
Pallas ``_run_pair``/``_pair_kernel``).  Each scale computes K1's cell
(``ops/gru_hside.py``) on its own (h, gx, w_ur, w_o); the CUDA kernel
(``csrc/gru_cells.cu``) runs both scales' tiles as one grid, so a modality
step of the flagship's three scales takes two launches instead of three.
It runs where ``models/statenet.py::combine_hside`` is allowed the fused
cells and ``fused_pair='on'``; scale 2 stays a per-scale K1 launch.

Where JAX passes each scale's ConvGRU param dict and folds it, the port
passes the folded h-side weights (``ConvGRU.hside_weights``).  Tensors are
NHWC as in ``ops/gru_hside.py``; gx may be a view with a batch stride.
Inference only, as the JAX kernel (no VJP): the wrapper raises under
autograd.  ``conv_gru_hside_pair.launches`` counts K9's launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import gru_hside

_P, _I, _L = gru_hside._P, gru_hside._I, gru_hside._L
# csrc/gru_cells.cu: K9 here, K10b for ops/gru_stream.py
_SIGNATURES = {
    "ramnet_gru_pair_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                                     _I, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                                     _I, _I, _I, _P)),
    "ramnet_gru_stream_pair_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _P, _P, _P, _P, _P, _I,
                                            _I, _I, _I, _I, _P, _I, _P)),
    **gru_hside._ERR,
}


def library():
    """The built and loaded K9/K10b library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_cells", _SIGNATURES)


def supports_pair(h0: torch.Tensor, h1: torch.Tensor) -> bool:
    """Whether K9 takes these two NHWC states: each one K1 takes
    (``gru_hside.supports``), of one batch size."""
    return (gru_hside.supports(h0) and gru_hside.supports(h1)
            and h0.shape[0] == h1.shape[0])


def conv_gru_hside_pair_plain(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's arithmetic in plain PyTorch: two K1 plain cells.  The CPU
    implementation of ``conv_gru_hside_pair`` and the kernel's oracle on
    the card."""
    return (gru_hside.conv_gru_hside_plain(h0, gx0, w0_ur, w0_o),
            gru_hside.conv_gru_hside_plain(h1, gx1, w1_ur, w1_o))


def _launch(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o):
    args = []
    for h, gx, w_ur, w_o in ((h0, gx0, w0_ur, w0_o), (h1, gx1, w1_ur, w1_o)):
        gru_hside._check_launch(h, gx, w_ur, w_o)
        if not (h.is_contiguous() and w_ur.is_contiguous()
                and w_o.is_contiguous()):
            raise ValueError("h, w_ur and w_o must be contiguous")
        _, H, W, C = h.shape
        th, tw = gru_hside._tile(h, gru_hside.smem_bytes)
        out = torch.empty_like(h)
        args.append((out, (h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(),
                           w_o.data_ptr(), out.data_ptr(), H, W, C,
                           gru_hside._gx_bstride(h, gx), th, tw)))
    lib = library()
    err = lib.ramnet_gru_pair_forward(
        *args[0][1], *args[1][1], h0.shape[0],
        torch.cuda.current_stream(h0.device).cuda_stream)
    gru_hside._raise_on(err, lib, "gru_pair")
    conv_gru_hside_pair.launches += 1
    return args[0][0], args[1][0]


def conv_gru_hside_pair(h0: torch.Tensor, gx0: torch.Tensor,
                        w0_ur: torch.Tensor, w0_o: torch.Tensor,
                        h1: torch.Tensor, gx1: torch.Tensor,
                        w1_ur: torch.Tensor, w1_o: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h0', h1'): the h-side cells of two scales from NHWC h_i [B, H_i,
    W_i, C_i], gx_i [B, H_i, W_i, 3C_i] and the folded weights (rounded to
    h_i's dtype): K9 for CUDA tensors, ``conv_gru_hside_pair_plain`` for
    CPU tensors.  Inference only: raises when autograd would need a
    gradient."""
    gru_hside._check(h0, gx0, w0_ur, w0_o)
    gru_hside._check(h1, gx1, w1_ur, w1_o)
    if h0.shape[0] != h1.shape[0] or h0.device != h1.device:
        raise ValueError("the two scales must share batch size and device, "
                         f"got {tuple(h0.shape)} on {h0.device} and "
                         f"{tuple(h1.shape)} on {h1.device}")
    gru_hside.raise_under_autograd(
        "conv_gru_hside_pair", h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o,
        why="as the JAX kernel, it has no VJP")
    w0_ur, w0_o = w0_ur.to(h0.dtype), w0_o.to(h0.dtype)
    w1_ur, w1_o = w1_ur.to(h1.dtype), w1_o.to(h1.dtype)
    if gru_hside._device_of(h0) == "cpu":
        return conv_gru_hside_pair_plain(h0, gx0, w0_ur, w0_o,
                                         h1, gx1, w1_ur, w1_o)
    with torch.cuda.device(h0.device):
        return _launch(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o)


conv_gru_hside_pair.launches = 0
