"""The cross-scale pair cell: the ConvGRU h-side cell of scales 0 and 1 in
one launch (kernel K9).

Counterpart of ``rpg_ramnet_tpu/ops/gru_pair.py`` (``conv_gru_hside_pair``:
Pallas ``_run_pair``/``_pair_kernel``).  Each scale computes K1's cell
(``ops/gru_hside.py``) on its own (h, gx, w_ur, w_o); the CUDA kernel
(``csrc/gru_cells.cu``) runs K1's tile body on both scales' tiles as one
grid, each scale under its own K1 plan (``plan_k9``), so a modality step
of the flagship's three scales takes two launches instead of three.  It
runs where ``models/statenet.py::combine_hside`` is allowed the fused
cells and ``fused_pair='on'``; scale 2 stays a per-scale K1 launch.  The
two-scale gx-streaming cell K10b (``ops/gru_stream.py``) is the same
kernel reading gx at a device step index.

Where JAX passes each scale's ConvGRU param dict and folds it, the port
passes the folded h-side weights (``ConvGRU.hside_weights``).  Tensors are
NHWC as in ``ops/gru_hside.py``; gx may be a view with a batch stride.
Inference only, as the JAX kernel (no VJP): the wrapper raises under
autograd.  ``conv_gru_hside_pair.launches`` counts K9's launches.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import gru_hside
from .gru_hside import K1Plan

_P, _I, _L = gru_hside._P, gru_hside._I, gru_hside._L
_PLAN = (_I,) * 5   # tile_h, tile_w, split, combo, ks
# csrc/gru_cells.cu: K9 here, K10b for ops/gru_stream.py
_SIGNATURES = {
    "ramnet_gru_pair_forward": (_I, (_P,) * 5 + (_I, _I, _I, _L) + _PLAN
                                + (_P,) * 5 + (_I, _I, _I, _L) + _PLAN
                                + (_I, _I, _P)),
    "ramnet_gru_stream_pair_forward": (_I, (_P,) * 5 + (_I,) * 3 + _PLAN
                                       + (_P,) * 5 + (_I,) * 3 + _PLAN
                                       + (_P, _I, _I, _P)),
    **gru_hside._ERR,
}
# The scale whose tile rows come first in the launch's grid (PairGrid).
# At the flagship pair (two waves of one block per SM) scale 1 first took
# 111.2 us a launch against 112.8 for scale 0 first on an H100 (PERF.md
# §6).
PAIR_FIRST = 1


def library():
    """The built and loaded K9/K10b library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_cells", _SIGNATURES)


def supports_pair(h0: torch.Tensor, h1: torch.Tensor) -> bool:
    """Whether K9 takes these two NHWC states: each one K1 takes
    (``gru_hside.supports``), of one batch size."""
    return (gru_hside.supports(h0) and gru_hside.supports(h1)
            and h0.shape[0] == h1.shape[0])


@functools.lru_cache(maxsize=None)
def plan_k9(shape0: Sequence[int], shape1: Sequence[int]
            ) -> Optional[Tuple[K1Plan, K1Plan]]:
    """K9's and K10b's plans for NHWC states of shapes shape0 and shape1 [B,
    H, W, C] (tuples): one warp-job combo for both scales (one kernel body
    serves both, csrc/gru_cells.cu), each scale under K1's cheapest plan on
    it (``_k1_cost``, the plan_k1 model), the combo of least summed cost,
    the first of equals; None where no combo has a plan at both scales."""
    def cheapest(shape, combo):
        return min((p for p in gru_hside.k1_plans(*shape) if p.combo == combo),
                   key=lambda p: gru_hside._k1_cost(p, *shape), default=None)

    pairs = [(cheapest(shape0, c), cheapest(shape1, c))
             for c in range(len(gru_hside.K1_COMBOS))]
    return min((pair for pair in pairs if None not in pair), default=None,
               key=lambda pair: sum(gru_hside._k1_cost(p, *s)
                                    for p, s in zip(pair, (shape0, shape1))))


class PairGrid(NamedTuple):
    """How a launch lays both scales' blocks out (csrc/gru_hside_tile.cuh,
    PairTile): K1's grid (x: tile column * split + rank, y: tile row, z:
    batch item) with scale s on tile rows [row0[s], row0[s] + rows[s]) and
    columns [0, cols[s]), clusters of ``cluster`` blocks along x; ``grid``
    (x, y, z) blocks in all."""
    cluster: int
    row0: Tuple[int, int]
    rows: Tuple[int, int]
    cols: Tuple[int, int]
    grid: Tuple[int, int, int]


def pair_grid(plans, B: int, hw0: Sequence[int], hw1: Sequence[int],
              first: int = PAIR_FIRST) -> PairGrid:
    """The grid of plans (K1Plan per scale) on B items of [H, W] planes hw0
    and hw1, scale ``first``'s tile rows first (gru_cells.cu's
    pair_grid)."""
    cluster = max(p.split for p in plans)
    rows = tuple(math.ceil(H / p.tile_h)
                 for p, (H, _) in zip(plans, (hw0, hw1)))
    cols = tuple(math.ceil(W / p.tile_w) * p.split
                 for p, (_, W) in zip(plans, (hw0, hw1)))
    row0 = [0, 0]
    row0[1 - first] = rows[first]
    x = math.ceil(max(cols) / cluster) * cluster
    return PairGrid(cluster, tuple(row0), rows, cols, (x, sum(rows), B))


def k9_plan_kinds(shape0: Sequence[int], shape1: Sequence[int]) -> list:
    """Every kind of K9/K10b launch at a pair of NHWC shapes, as (plans,
    first): the planner's pair with ``PAIR_FIRST``, the same with the other
    order, every pair of K1 plan kinds of the two scales on one combo
    (``k1_plan_kinds``: splits 1 + 1 and 1 + 2, each combo), a 2 + 2 pair
    where both widths split, and a split-1 scale 0 with an odd count of
    tile columns beside a split-2 scale 1 (padding blocks in clusters of
    2), in both orders: the launches a card test runs to cover every path
    of the pair grid and every kernel instance."""
    shapes = (tuple(shape0), tuple(shape1))
    planned = plan_k9(*shapes)
    kinds = [(planned, PAIR_FIRST), (planned, 1 - PAIR_FIRST)]
    kinds += [(pair, PAIR_FIRST) for pair in itertools.product(
        *(gru_hside.k1_plan_kinds(*s) for s in shapes))
        if pair[0].combo == pair[1].combo and pair != planned]
    splits = [(s[-1] // 16) % 2 == 0 for s in shapes]
    if all(splits):
        kinds.append((tuple(p._replace(split=2) for p in planned), PAIR_FIRST))
    _, _, W, C0 = shapes[0]
    odd = next((K1Plan(th, tw, 1, planned[0].combo, 16)
                for th in range(12, 0, -1) for tw in range(24, 0, -1)
                if -(-W // tw) % 2 and gru_hside.k1_smem_bytes(
                    th, tw, C0, 1, 16) <= gru_hside._SMEM_MAX), None)
    if splits[1] and odd is not None:
        kinds += [((odd, planned[1]._replace(split=2)), f) for f in (0, 1)]
    return kinds


def pair_weight_bytes(plans, shape0, shape1) -> int:
    """The weight bytes one launch streams into shared memory: both scales'
    ``k1_weight_bytes``."""
    return sum(gru_hside.k1_weight_bytes(p, *s)
               for p, s in zip(plans, (shape0, shape1)))


def resolve_plans(shape0, shape1, plans, first, what: str):
    """``plan_k9``'s plans, or the given pair of K1 plans once each passes
    ``check_k1_plan`` at its scale's C; first: the scale whose blocks come
    first (``PAIR_FIRST`` when None)."""
    if first is None:
        first = PAIR_FIRST
    if first not in (0, 1):
        raise ValueError(f"{what}: first must be 0 or 1, got {first!r}")
    if plans is None:
        plans = plan_k9(tuple(shape0), tuple(shape1))
        if plans is None:
            raise ValueError(f"C={shape0[-1]}, {shape1[-1]} do not fit "
                             f"{what}'s shared memory")
        return plans, first
    if len(plans) != 2:
        raise ValueError(f"{what} takes a plan per scale, got {plans!r}")
    plans = tuple(K1Plan(*p) for p in plans)
    for p, s in zip(plans, (shape0, shape1)):
        gru_hside.check_k1_plan(p, s[-1])
    if plans[0].combo != plans[1].combo:
        raise ValueError(f"{what} runs one warp-job combo for both scales, "
                         f"got {plans}")
    return plans, first


def conv_gru_hside_pair_plain(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's arithmetic in plain PyTorch: two K1 plain cells.  The CPU
    implementation of ``conv_gru_hside_pair`` and the kernel's oracle on
    the card."""
    return (gru_hside.conv_gru_hside_plain(h0, gx0, w0_ur, w0_o),
            gru_hside.conv_gru_hside_plain(h1, gx1, w1_ur, w1_o))


def _launch(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o, plans, first):
    plans, first = resolve_plans(h0.shape, h1.shape, plans, first, "K9")
    args = []
    for (h, gx, w_ur, w_o), plan in zip(((h0, gx0, w0_ur, w0_o),
                                         (h1, gx1, w1_ur, w1_o)), plans):
        gru_hside._check_launch(h, gx, w_ur, w_o)
        if not (h.is_contiguous() and w_ur.is_contiguous()
                and w_o.is_contiguous()):
            raise ValueError("h, w_ur and w_o must be contiguous")
        _, H, W, C = h.shape
        out = torch.empty_like(h)
        args.append((out, (h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(),
                           w_o.data_ptr(), out.data_ptr(), H, W, C,
                           gru_hside._gx_bstride(h, gx), *plan)))
    lib = library()
    for h, plan in zip((h0, h1), plans):
        gru_hside.check_cluster_launch(h, plan, "K9")
    err = lib.ramnet_gru_pair_forward(
        *args[0][1], *args[1][1], h0.shape[0], first,
        torch.cuda.current_stream(h0.device).cuda_stream)
    gru_hside._raise_on(err, lib, f"gru_pair (plans {plans})")
    conv_gru_hside_pair.launches += 1
    return args[0][0], args[1][0]


def conv_gru_hside_pair(h0: torch.Tensor, gx0: torch.Tensor,
                        w0_ur: torch.Tensor, w0_o: torch.Tensor,
                        h1: torch.Tensor, gx1: torch.Tensor,
                        w1_ur: torch.Tensor, w1_o: torch.Tensor,
                        _plan=None, _first: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h0', h1'): the h-side cells of two scales from NHWC h_i [B, H_i,
    W_i, C_i], gx_i [B, H_i, W_i, 3C_i] and the folded weights (rounded to
    h_i's dtype): K9 for CUDA tensors, ``conv_gru_hside_pair_plain`` for
    CPU tensors.  Inference only: raises when autograd would need a
    gradient.  _plan: a pair of ``K1Plan``s (scale 0's, scale 1's, on one
    combo) that replaces ``plan_k9``'s, _first the scale whose blocks come
    first in
    place of ``PAIR_FIRST`` (tests and timing; checked on either
    device)."""
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
        if _plan is not None or _first is not None:
            resolve_plans(h0.shape, h1.shape, _plan, _first, "K9")
        return conv_gru_hside_pair_plain(h0, gx0, w0_ur, w0_o,
                                         h1, gx1, w1_ur, w1_o)
    with torch.cuda.device(h0.device):
        return _launch(h0, gx0, w0_ur, w0_o, h1, gx1, w1_ur, w1_o, _plan,
                       _first)


conv_gru_hside_pair.launches = 0
