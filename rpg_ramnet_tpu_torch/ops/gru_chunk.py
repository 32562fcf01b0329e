"""The whole-chunk resident-state ConvGRU h-side cell (kernel K11).

Counterpart of ``rpg_ramnet_tpu/ops/gru_chunk.py``
(``conv_gru_hside_chunk``: Pallas ``_run_chunk``/``_kernel``).  It runs
all S = L*(K+1) sequential h-side steps of one scale of a chunk in one
launch: K event steps, then the image step, per package, each K1's cell
(``ops/gru_hside.py``) with the events or the image cell's weights by
s % (K+1).  The CUDA kernel (``csrc/gru_chunk.cu``) is a persistent
cooperative kernel on K1's tile with a grid-wide barrier between the
steps, under a K1 plan (``plan_k11``: ``plan_k1``'s where its clusters all
fit on the card at once, so each block keeps one tile for every step).  It
runs in ``ERGB2DepthRecurrent.forward_sequence_precomputed(chunk_cells=True)``:
batch 1, ConvGRU, bf16.

Where JAX passes the two ConvGRU param dicts and folds them, the port
passes the folded h-side weights (``ConvGRU.hside_weights``).  Inference
only, as the JAX kernel (no VJP): the wrapper raises under autograd.
``conv_gru_hside_chunk.launches`` counts K11's launches, and
``conv_gru_hside_chunk.last_grid`` and ``.last_plan`` hold the grid and
the plan of the last one.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Tuple

import torch

from . import gru_hside
from .gru_hside import K1Plan

_P, _I = gru_hside._P, gru_hside._I
_SIGNATURES = {
    "ramnet_gru_chunk_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _P)),
    "ramnet_gru_chunk_max_active_clusters": (_I, (_I,) * 6),
    **gru_hside._ERR,
}
# K11's warp jobs (indices of gru_hside.K1_COMBOS): combo 0 is not built,
# because inside K11's walk its body spills (csrc/gru_chunk.cu::kernel_of)
K11_COMBOS = (1, 2)
# bytes of static shared memory K11's kernel holds beside K1's footprint
# (the tile's K1Args, its origin and the block's walk), at most
K11_STATIC_SMEM = 256


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


def tiles(plan: K1Plan, H: int, W: int) -> int:
    """The pixel tiles of one [H, W] plane under a plan: the clusters one
    step needs."""
    return math.ceil(H / plan.tile_h) * math.ceil(W / plan.tile_w)


def k11_plans(H: int, W: int, C: int, max_split: int = 2) -> List[K1Plan]:
    """The plans K11 weighs at [1, H, W, C]: ``k1_plans``' with a combo K11
    builds (``K11_COMBOS``) whose footprint, with K11's static shared
    memory, fits in a block's.  A split-2 plan joins a cluster launch to a
    cooperative one, which the H100 takes, its grid barrier holding across
    clusters (PERF.md §6)."""
    return [p for p in gru_hside.k1_plans(1, H, W, C, max_split)
            if p.combo in K11_COMBOS and _smem_fits(p, C)]


def _smem_fits(plan: K1Plan, C: int) -> bool:
    return (gru_hside.k1_smem_bytes(plan.tile_h, plan.tile_w, C, plan.split,
                                    plan.ks) + K11_STATIC_SMEM
            <= gru_hside._SMEM_MAX)


def plan_k11(H: int, W: int, C: int, resident: Callable[[K1Plan], int],
             max_split: int = 2) -> Optional[K1Plan]:
    """K11's plan at [1, H, W, C]: the cheapest by ``_k1_cost`` among
    ``k11_plans`` whose clusters (one per tile) all fit on the card at once
    (``plan_k1``'s wherever that one is among them), else the cheapest of
    all (its blocks then loop over the tiles).  resident(plan): the
    clusters of the plan the card holds at once (K11's own kernel
    instance, see ``resident_clusters``).  None where no plan fits in
    shared memory."""
    plans = k11_plans(H, W, C, max_split)
    if not plans:
        return None
    ranked = sorted(plans, key=lambda p: gru_hside._k1_cost(p, 1, H, W, C))
    for plan in ranked:   # sorted is stable: the first of equals first
        if tiles(plan, H, W) <= resident(plan):
            return plan
    return ranked[0]


def k11_plan_kinds(H: int, W: int, C: int, resident: Callable[[K1Plan], int]
                   ) -> List[K1Plan]:
    """One plan per (split, combo) K11 can run at [1, H, W, C], the
    planner's own first (``gru_hside._plan_kinds``): the plans a card test
    runs to cover every code path K11's planner may take."""
    return gru_hside._plan_kinds(
        k11_plans(H, W, C), lambda p: gru_hside._k1_cost(p, 1, H, W, C),
        plan_k11(H, W, C, resident))


def k11_grid(plan: K1Plan, H: int, W: int, blocks: int, resident: int) -> int:
    """The blocks of a K11 launch: ``blocks`` rounded up to a multiple of
    the plan's split, or with blocks 0 one cluster per tile, capped at the
    ``resident`` clusters that fit at once (the blocks then loop over the
    tiles).  Raises on a negative count."""
    if blocks < 0:
        raise ValueError(f"blocks must be 0 or positive, got {blocks}")
    if blocks:
        return math.ceil(blocks / plan.split) * plan.split
    return max(1, min(tiles(plan, H, W), resident)) * plan.split


@functools.lru_cache(maxsize=None)
def resident_clusters(device: int, C: int, plan: K1Plan) -> int:
    """How many clusters of K11's kernel under the plan the device holds
    at once (cudaOccupancyMaxActiveClusters, asked once per plan)."""
    with torch.cuda.device(device):
        n = library().ramnet_gru_chunk_max_active_clusters(C, *plan)
    if n < 0:
        raise RuntimeError(f"K11 cannot run plan {plan} at C={C}")
    return n


@functools.lru_cache(maxsize=None)
def device_plan(device: int, H: int, W: int, C: int) -> Optional[K1Plan]:
    """``plan_k11`` on the device (asked once per shape): the plan K11
    runs at [1, H, W, C] there when no plan is given."""
    return plan_k11(H, W, C, lambda p: resident_clusters(device, C, p))


def _resolve(h0, plan, blocks) -> Tuple[K1Plan, int]:
    """(plan, blocks) of a launch on h0's device: the given plan (checked)
    or ``plan_k11``'s, and ``k11_grid``'s blocks."""
    _, H, W, C = h0.shape
    dev = h0.device.index
    if plan is None:
        plan = device_plan(dev, H, W, C)
        if plan is None:
            raise ValueError(f"C={C} does not fit K11's shared memory")
    else:
        plan = _checked(plan, C)
    return plan, k11_grid(plan, H, W, blocks, resident_clusters(dev, C, plan))


def _checked(plan, C: int) -> K1Plan:
    """The plan as a ``K1Plan`` once K11 can run it at width C."""
    plan = K1Plan(*plan)
    gru_hside.check_k1_plan(plan, C)
    if plan.combo not in K11_COMBOS:
        raise ValueError(f"K11 takes combos {K11_COMBOS}, got {plan}")
    if not _smem_fits(plan, C):
        raise ValueError(f"K11 plan {plan} needs more shared memory at C={C} "
                         f"than a block has")
    return plan


def _launch(w_ur2, w_o2, gx_steps, h0, K, blocks, plan):
    gru_hside._check_launch(h0, gx_steps, w_ur2, w_o2)
    if not all(t.is_contiguous() for t in (h0, gx_steps, w_ur2, w_o2)):
        raise ValueError("h0, gx_steps and the weights must be contiguous")
    S = gx_steps.shape[0]
    _, H, W, C = h0.shape
    plan, grid = _resolve(h0, plan, blocks)
    gru_hside.check_cluster_launch(h0, plan, "K11")
    snaps = torch.empty((S, H, W, C), dtype=h0.dtype, device=h0.device)
    lib = library()
    err = lib.ramnet_gru_chunk_forward(
        h0.data_ptr(), gx_steps.data_ptr(), w_ur2.data_ptr(), w_o2.data_ptr(),
        snaps.data_ptr(), S, K, H, W, C, *plan, grid,
        torch.cuda.current_stream(h0.device).cuda_stream)
    gru_hside._raise_on(err, lib, f"gru_chunk (plan {plan}, grid {grid})")
    conv_gru_hside_chunk.launches += 1
    conv_gru_hside_chunk.last_grid = grid
    conv_gru_hside_chunk.last_plan = plan
    return snaps


def conv_gru_hside_chunk(p_ev, p_im, gx_steps: torch.Tensor,
                         h0: torch.Tensor, K: int, blocks: int = 0,
                         _plan: Optional[K1Plan] = None) -> torch.Tensor:
    """The h trajectory [S, H, W, C] of one scale over a chunk: step s
    from snaps[s-1] (h0 at s = 0) and gx_steps[s].

    p_ev, p_im: the events and image cells' folded h-side weights
    (w_ur [9, 2C, C], w_o [9, C, C]), rounded to h0's dtype; gx_steps:
    [S, H, W, 3C] in step order (K event steps, then the image step, per
    package; biases folded in); h0: [1, H, W, C].  Row S-1 is the final
    state.  K11 for CUDA tensors, ``conv_gru_hside_chunk_plain`` for CPU
    tensors.  blocks: the kernel's grid, rounded up to a multiple of the
    plan's split (0: one cluster per tile, capped at the clusters that fit
    at once; ``k11_grid``); a grid larger than what fits fails the
    cooperative launch, which raises.  Inference only: raises when
    autograd would need a gradient.  _plan: a ``K1Plan`` that replaces
    ``plan_k11``'s (tests and timing; checked on either device)."""
    _check(p_ev, p_im, gx_steps, h0, K)
    gru_hside.raise_under_autograd("conv_gru_hside_chunk", h0, gx_steps,
                                   *p_ev, *p_im,
                                   why="as the JAX kernel, it has no VJP")
    p_ev = tuple(w.to(h0.dtype) for w in p_ev)
    p_im = tuple(w.to(h0.dtype) for w in p_im)
    if gru_hside._device_of(h0) == "cpu":
        if _plan is not None:
            _checked(_plan, h0.shape[-1])
        if blocks < 0:
            raise ValueError(f"blocks must be 0 or positive, got {blocks}")
        return conv_gru_hside_chunk_plain(p_ev, p_im, gx_steps, h0, K)
    w_ur2 = torch.stack([p_ev[0], p_im[0]])      # [2, 9, 2C, C]
    w_o2 = torch.stack([p_ev[1], p_im[1]])       # [2, 9, C, C]
    with torch.cuda.device(h0.device):
        return _launch(w_ur2, w_o2, gx_steps, h0, K, blocks, _plan)


conv_gru_hside_chunk.launches = 0
conv_gru_hside_chunk.last_grid = 0
conv_gru_hside_chunk.last_plan = None
