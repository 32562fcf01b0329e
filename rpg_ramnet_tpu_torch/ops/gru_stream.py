"""The gx-streaming ConvGRU h-side cells (kernels K10a and K10b).

Counterpart of ``rpg_ramnet_tpu/ops/gru_stream.py``: ``StreamPlan`` and
its ``step`` (Pallas ``_run_stream``/``_stream_kernel``, K10a), and
``stream_pair_step`` (``_run_stream_pair``/``_stream_pair_kernel``, K10b).
K10a is K1's cell (``ops/gru_hside.py``) reading its gx block from the
whole chunk's per-scale buffer gx_seq [S, H, W, 3C] at the step held by a
device int32 ``sel``, so no per-step slice of the buffer is made: K1's
tile under K1's plan (``plan_k1``) in ``csrc/gru_hside.cu``.  K10b is the
pair cell K9 (``ops/gru_pair.py``) with the same indexing, one ``sel`` for
scales 0 and 1: K1's tile under a K1 plan per scale (``plan_k9``) in
``csrc/gru_cells.cu``.
They run in
``ERGB2DepthRecurrent.forward_sequence_precomputed``'s stream branch
(``fused_stream='on'``): batch 1, ConvGRU, the states K1 takes
(``gru_hside.supports``).

The step index is the JAX package's: event sub-step k of package t reads
step t*K + k of the events buffer, the image step of package t step t of
the image buffer.  The JAX package's halo side arrays (``seq_halos``) are
not ported: they exist because a BlockSpec cannot fetch a one-row halo,
and the CUDA kernel reads those rows from the gx plane itself.  Inference
only (no VJP): the wrappers raise under autograd.
``conv_gru_hside_stream.launches`` and ``conv_gru_hside_stream_pair.launches``
count K10a's and K10b's launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import gru_hside, gru_pair
from .gru_hside import K1Plan


def _check(h, gx_seq, sel, w_ur, w_o) -> None:
    if h.dim() != 4 or h.shape[0] != 1:
        raise ValueError(f"h must be NHWC [1, H, W, C], got {tuple(h.shape)}")
    _, H, W, C = h.shape
    if gx_seq.dim() != 4 or tuple(gx_seq.shape[1:]) != (H, W, 3 * C):
        raise ValueError(f"gx_seq must be [S, {H}, {W}, {3 * C}], got "
                         f"{tuple(gx_seq.shape)}")
    gru_hside._check(h, gx_seq[:1], w_ur, w_o)
    if (tuple(sel.shape) != (1,) or sel.dtype != torch.int32
            or sel.device != h.device):
        raise ValueError(f"sel must be int32 [1] on {h.device}, got "
                         f"{sel.dtype} {tuple(sel.shape)} on {sel.device}")


def conv_gru_hside_stream_plain(h, gx_seq, sel, w_ur, w_o) -> torch.Tensor:
    """K10a's arithmetic in plain PyTorch: K1's plain cell on step ``sel``
    of gx_seq.  The CPU implementation of ``conv_gru_hside_stream`` and the
    kernel's oracle on the card."""
    gx = torch.index_select(gx_seq, 0, sel.long())
    return gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)


def _launch(h, gx_seq, sel, w_ur, w_o, plan=None):
    gru_hside._check_launch(h, gx_seq, w_ur, w_o)
    if not all(t.is_contiguous() for t in (h, gx_seq, w_ur, w_o)):
        raise ValueError("h, gx_seq, w_ur and w_o must be contiguous")
    _, H, W, C = h.shape
    plan = gru_hside._resolve_plan(h, plan, K1Plan, gru_hside.plan_k1,
                                   gru_hside.check_k1_plan, "K10a")
    lib = gru_hside.library()
    gru_hside.check_cluster_launch(h, plan, "K10a")
    out = torch.empty_like(h)
    err = lib.ramnet_gru_hside_forward_sel(
        h.data_ptr(), gx_seq.data_ptr(), sel.data_ptr(), w_ur.data_ptr(),
        w_o.data_ptr(), out.data_ptr(), H, W, C, gx_seq.shape[0], *plan,
        torch.cuda.current_stream(h.device).cuda_stream)
    gru_hside._raise_on(err, lib, f"gru_stream (plan {plan})")
    conv_gru_hside_stream.launches += 1
    return out


def conv_gru_hside_stream(h: torch.Tensor, gx_seq: torch.Tensor,
                          sel: torch.Tensor, w_ur: torch.Tensor,
                          w_o: torch.Tensor, _plan: Optional[K1Plan] = None
                          ) -> torch.Tensor:
    """h' [1, H, W, C] of K1's cell from NHWC h [1, H, W, C], step sel of
    gx_seq [S, H, W, 3C] and the folded weights (rounded to h's dtype):
    K10a for CUDA tensors, ``conv_gru_hside_stream_plain`` for CPU tensors.
    sel: int32 [1] on h's device, in [0, S) (the kernel clamps it there).
    Inference only: raises when autograd would need a gradient.  _plan: a
    ``K1Plan`` that replaces ``plan_k1``'s (tests and timing; checked on
    either device)."""
    _check(h, gx_seq, sel, w_ur, w_o)
    gru_hside.raise_under_autograd("conv_gru_hside_stream", h, gx_seq, w_ur,
                                   w_o, why="as the JAX kernel, it has no VJP")
    w_ur, w_o = w_ur.to(h.dtype), w_o.to(h.dtype)
    if gru_hside._device_of(h) == "cpu":
        if _plan is not None:
            gru_hside.check_k1_plan(K1Plan(*_plan), h.shape[-1])
        return conv_gru_hside_stream_plain(h, gx_seq, sel, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch(h, gx_seq, sel, w_ur, w_o, _plan)


def conv_gru_hside_stream_pair_plain(h0, gx0_seq, w0_ur, w0_o, h1, gx1_seq,
                                     w1_ur, w1_o, sel
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10b's arithmetic in plain PyTorch: K10a's plain version per scale,
    one sel for both."""
    return (conv_gru_hside_stream_plain(h0, gx0_seq, sel, w0_ur, w0_o),
            conv_gru_hside_stream_plain(h1, gx1_seq, sel, w1_ur, w1_o))


def _launch_pair(h0, gx0_seq, w0_ur, w0_o, h1, gx1_seq, w1_ur, w1_o, sel,
                 plans, first):
    plans, first = gru_pair.resolve_plans(h0.shape, h1.shape, plans, first,
                                          "K10b")
    outs, args = [], []
    for h, gx_seq, w_ur, w_o, plan in ((h0, gx0_seq, w0_ur, w0_o, plans[0]),
                                       (h1, gx1_seq, w1_ur, w1_o, plans[1])):
        gru_hside._check_launch(h, gx_seq, w_ur, w_o)
        if not all(t.is_contiguous() for t in (h, gx_seq, w_ur, w_o)):
            raise ValueError("h, gx_seq, w_ur and w_o must be contiguous")
        _, H, W, C = h.shape
        outs.append(torch.empty_like(h))
        args += [h.data_ptr(), gx_seq.data_ptr(), w_ur.data_ptr(),
                 w_o.data_ptr(), outs[-1].data_ptr(), H, W, C, *plan]
    lib = gru_pair.library()
    for h, plan in zip((h0, h1), plans):
        gru_hside.check_cluster_launch(h, plan, "K10b")
    err = lib.ramnet_gru_stream_pair_forward(
        *args, sel.data_ptr(), gx0_seq.shape[0], first,
        torch.cuda.current_stream(h0.device).cuda_stream)
    gru_hside._raise_on(err, lib, f"gru_stream_pair (plans {plans})")
    conv_gru_hside_stream_pair.launches += 1
    return tuple(outs)


def conv_gru_hside_stream_pair(h0, gx0_seq, w0_ur, w0_o, h1, gx1_seq, w1_ur,
                               w1_o, sel, _plan=None,
                               _first: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h0', h1'): ``conv_gru_hside_stream`` of scales 0 and 1 at one step
    sel in one launch: K10b for CUDA tensors,
    ``conv_gru_hside_stream_pair_plain`` for CPU tensors.  Inference
    only.  _plan, _first: a pair of ``K1Plan``s and the scale whose blocks
    come first, in place of ``gru_pair.plan_k9``'s and ``PAIR_FIRST`` (tests
    and timing; checked on either device)."""
    _check(h0, gx0_seq, sel, w0_ur, w0_o)
    _check(h1, gx1_seq, sel, w1_ur, w1_o)
    if gx0_seq.shape[0] != gx1_seq.shape[0]:
        raise ValueError("the two scales' buffers must hold the same steps, "
                         f"got {gx0_seq.shape[0]} and {gx1_seq.shape[0]}")
    gru_hside.raise_under_autograd(
        "conv_gru_hside_stream_pair", h0, gx0_seq, w0_ur, w0_o, h1, gx1_seq,
        w1_ur, w1_o, why="as the JAX kernel, it has no VJP")
    w0_ur, w0_o = w0_ur.to(h0.dtype), w0_o.to(h0.dtype)
    w1_ur, w1_o = w1_ur.to(h1.dtype), w1_o.to(h1.dtype)
    if gru_hside._device_of(h0) == "cpu":
        if _plan is not None or _first is not None:
            gru_pair.resolve_plans(h0.shape, h1.shape, _plan, _first, "K10b")
        return conv_gru_hside_stream_pair_plain(h0, gx0_seq, w0_ur, w0_o, h1,
                                                gx1_seq, w1_ur, w1_o, sel)
    with torch.cuda.device(h0.device):
        return _launch_pair(h0, gx0_seq, w0_ur, w0_o, h1, gx1_seq, w1_ur,
                            w1_o, sel, _plan, _first)


class StreamPlan:
    """Per-scale invariants of one chunk's stream cells, made once per
    chunk: both modalities' folded weights and the gx buffers as step
    sequences, with the device int32 step indices the cells read."""

    def __init__(self, p_ev, p_im, gx_ev: torch.Tensor, gx_im: torch.Tensor,
                 h0: torch.Tensor):
        """p_ev, p_im: the events and image cells' folded h-side weights
        (w_ur, w_o) (``ConvGRU.hside_weights``; JAX passes the param dicts
        and folds them here); gx_ev: NHWC [l, 1, K, H, W, 3C]; gx_im:
        [l, 1, H, W, 3C]; h0: [1, H, W, C]."""
        l, b, loop = gx_ev.shape[:3]
        if b != 1 or gx_im.shape[1] != 1:
            raise ValueError("stream cells are single-stream (batch 1)")
        self.loop = loop
        dt = h0.dtype
        self.gx_ev = gx_ev.reshape((l * loop,) + gx_ev.shape[3:]).contiguous()
        self.gx_im = gx_im.reshape((l,) + gx_im.shape[2:]).contiguous()
        self.w_ev = tuple(w.to(dt).contiguous() for w in p_ev)
        self.w_im = tuple(w.to(dt).contiguous() for w in p_im)
        self.sel_ev = torch.arange(l * loop, dtype=torch.int32,
                                   device=h0.device)
        self.sel_im = torch.arange(l, dtype=torch.int32, device=h0.device)

    def select(self, pkg_idx: int, k: Optional[int] = None):
        """(gx buffer, sel [1], (w_ur, w_o)) of event sub-step k of package
        pkg_idx when k is given, else of the package's image step."""
        if k is None:
            return (self.gx_im, self.sel_im[pkg_idx:pkg_idx + 1],
                    self.w_im)
        s = pkg_idx * self.loop + k
        return self.gx_ev, self.sel_ev[s:s + 1], self.w_ev

    def step(self, h: torch.Tensor, pkg_idx: int,
             k: Optional[int] = None) -> torch.Tensor:
        """One h-side completion (K10a): event sub-step k of package
        pkg_idx when k is given, else the package's image step.
        h: [1, H, W, C] -> [1, H, W, C]."""
        gx, sel, (w_ur, w_o) = self.select(pkg_idx, k)
        return conv_gru_hside_stream(h, gx, sel, w_ur, w_o)


def stream_pair_step(plan0: StreamPlan, plan1: StreamPlan, h0: torch.Tensor,
                     h1: torch.Tensor, pkg_idx: int, k: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One modality step's h-side completions of scales 0 and 1 in one
    launch (K10b), gx selected by the step index.  h_i: [1, H_i, W_i, C_i]
    -> the same."""
    gx0, sel, (w0_ur, w0_o) = plan0.select(pkg_idx, k)
    gx1, _, (w1_ur, w1_o) = plan1.select(pkg_idx, k)
    return conv_gru_hside_stream_pair(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur,
                                      w1_o, sel)


conv_gru_hside_stream.launches = 0
conv_gru_hside_stream_pair.launches = 0
