"""The whole-chunk resident-state ConvGRU h-side cell (kernel K11).

Counterpart of ``rpg_ramnet_tpu/ops/gru_chunk.py``
(``conv_gru_hside_chunk``: Pallas ``_run_chunk``/``_kernel``).  It runs
all S = L*(K+1) sequential h-side steps of one scale of a chunk in one
launch: K event steps, then the image step, per package, each K1's cell
(``ops/gru_hside.py``) with the events or the image cell's weights by
s % (K+1).  The CUDA kernel (``csrc/gru_chunk.cu``) is a persistent
cooperative kernel with a grid-wide barrier between the steps.  It runs in
``ERGB2DepthRecurrent.forward_sequence_precomputed(chunk_cells=True)``:
batch 1, ConvGRU, bf16.

Where JAX passes the two ConvGRU param dicts and folds them, the port
passes the folded h-side weights (``ConvGRU.hside_weights``).  Inference
only, as the JAX kernel (no VJP): the wrapper raises under autograd.
``conv_gru_hside_chunk.launches`` counts K11's launches and
``conv_gru_hside_chunk.last_grid`` holds the grid of the last one.
"""
from __future__ import annotations

import ctypes

import torch

from . import gru_hside

_P, _I, _L = gru_hside._P, gru_hside._I, gru_hside._L
_SIGNATURES = {
    "ramnet_gru_chunk_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, ctypes.POINTER(ctypes.c_int),
                                      _P)),
    **gru_hside._ERR,
}


def library():
    """The built and loaded K11 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_chunk", _SIGNATURES)


def supports(h0: torch.Tensor) -> bool:
    """Whether K11 takes this NHWC initial state: batch 1 and a state K1
    takes (``gru_hside.supports``: bf16, C % 16 == 0, a tile that fits)."""
    return h0.dim() == 4 and h0.shape[0] == 1 and gru_hside.supports(h0)


def _check(p_ev, p_im, gx_steps, h0, K) -> None:
    if h0.dim() != 4 or h0.shape[0] != 1:
        raise ValueError(f"h0 must be NHWC [1, H, W, C], got {tuple(h0.shape)}")
    _, H, W, C = h0.shape
    if gx_steps.dim() != 4 or tuple(gx_steps.shape[1:]) != (H, W, 3 * C):
        raise ValueError(f"gx_steps must be [S, {H}, {W}, {3 * C}], got "
                         f"{tuple(gx_steps.shape)}")
    if K < 1 or gx_steps.shape[0] % (K + 1):
        raise ValueError(f"S = {gx_steps.shape[0]} steps is not a whole "
                         f"number of packages of K + 1 = {K + 1}")
    for w_ur, w_o in (p_ev, p_im):
        gru_hside._check(h0, gx_steps[:1], w_ur, w_o)


def conv_gru_hside_chunk_plain(p_ev, p_im, gx_steps, h0, K: int
                               ) -> torch.Tensor:
    """K11's arithmetic in plain PyTorch: a loop of K1 plain cells, the
    events weights at steps s % (K+1) < K and the image weights at the
    rest.  The CPU implementation of ``conv_gru_hside_chunk`` and the
    kernel's oracle on the card."""
    h, snaps = h0, []
    for s in range(gx_steps.shape[0]):
        w_ur, w_o = p_im if s % (K + 1) == K else p_ev
        h = gru_hside.conv_gru_hside_plain(h, gx_steps[s:s + 1], w_ur, w_o)
        snaps.append(h)
    return torch.cat(snaps)


def _launch(w_ur2, w_o2, gx_steps, h0, K, blocks):
    gru_hside._check_launch(h0, gx_steps, w_ur2, w_o2)
    if not all(t.is_contiguous() for t in (h0, gx_steps, w_ur2, w_o2)):
        raise ValueError("h0, gx_steps and the weights must be contiguous")
    S = gx_steps.shape[0]
    _, H, W, C = h0.shape
    th, tw = gru_hside._tile(h0, gru_hside.smem_bytes)
    snaps = torch.empty((S, H, W, C), dtype=h0.dtype, device=h0.device)
    grid = ctypes.c_int(0)
    lib = library()
    err = lib.ramnet_gru_chunk_forward(
        h0.data_ptr(), gx_steps.data_ptr(), w_ur2.data_ptr(), w_o2.data_ptr(),
        snaps.data_ptr(), S, K, H, W, C, th, tw, blocks, ctypes.byref(grid),
        torch.cuda.current_stream(h0.device).cuda_stream)
    gru_hside._raise_on(err, lib, f"gru_chunk (grid {grid.value})")
    conv_gru_hside_chunk.launches += 1
    conv_gru_hside_chunk.last_grid = grid.value
    return snaps


def conv_gru_hside_chunk(p_ev, p_im, gx_steps: torch.Tensor,
                         h0: torch.Tensor, K: int, blocks: int = 0
                         ) -> torch.Tensor:
    """The h trajectory [S, H, W, C] of one scale over a chunk: step s
    from snaps[s-1] (h0 at s = 0) and gx_steps[s].

    p_ev, p_im: the events and image cells' folded h-side weights
    (w_ur [9, 2C, C], w_o [9, C, C]), rounded to h0's dtype; gx_steps:
    [S, H, W, 3C] in step order (K event steps, then the image step, per
    package; biases folded in); h0: [1, H, W, C].  Row S-1 is the final
    state.  K11 for CUDA tensors, ``conv_gru_hside_chunk_plain`` for CPU
    tensors.  blocks: the kernel's grid (0: the tiles, capped at the
    blocks that can be resident at once); a grid larger than that fails
    the cooperative launch, which raises.  Inference only: raises when
    autograd would need a gradient."""
    _check(p_ev, p_im, gx_steps, h0, K)
    gru_hside.raise_under_autograd("conv_gru_hside_chunk", h0, gx_steps,
                                   *p_ev, *p_im,
                                   why="as the JAX kernel, it has no VJP")
    p_ev = tuple(w.to(h0.dtype) for w in p_ev)
    p_im = tuple(w.to(h0.dtype) for w in p_im)
    if gru_hside._device_of(h0) == "cpu":
        return conv_gru_hside_chunk_plain(p_ev, p_im, gx_steps, h0, K)
    w_ur2 = torch.stack([p_ev[0], p_im[0]])      # [2, 9, 2C, C]
    w_o2 = torch.stack([p_ev[1], p_im[1]])       # [2, 9, C, C]
    with torch.cuda.device(h0.device):
        return _launch(w_ur2, w_o2, gx_steps, h0, K, blocks)


conv_gru_hside_chunk.launches = 0
conv_gru_hside_chunk.last_grid = 0
