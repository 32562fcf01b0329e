"""The fused ConvGRU h-side cell: forward (K1), its residual variant for
training (K1-res), its backward (K2), and the autograd.Function over them.

Counterpart of ``rpg_ramnet_tpu/ops/gru_hside.py``: ``conv_gru_hside_fused``
and its custom VJP (``_gru_hside_cell``: Pallas ``_run``/``_kernel`` and
``_kernel_res`` forward, ``_run_bwd``/``_bwd_kernel`` or
``_gru_hside_bwd_xla`` backward).  The CUDA kernels are
``csrc/gru_hside.cu`` (K1, K1-res) and ``csrc/gru_hside_bwd.cu`` (K2); their
headers say what bounds them on an H100 and what the design does about it.

    z, r = sigmoid(conv3x3(h, W_ur) + gx[..., :2C])
    o    = tanh(conv3x3(bf16(r * h), W_o) + gx[..., 2C:])
    h'   = h * (1 - z) + o * z

Tensors are NHWC: h [B, H, W, C], gx [B, H, W, 3C] in (update, reset, out)
order with the biases folded in (``ConvGRU.x_gates``), and the h slices of
the gate weights folded by ``ConvGRU.hside_weights``: w_ur [9, 2C, C]
(update rows, then reset rows) and w_o [9, C, C], indexed (ky*3 + kx, out,
in): the tensor cores' B operand, contiguous along the contraction.  acts
[B, H, W, 3C] = (z, r, o) in h's dtype.

Each kernel has a plain PyTorch version here (``*_plain``), and each wrapper
runs it for a tensor on the CPU and launches the kernel for a CUDA tensor;
on a CUDA tensor it launches or raises.  ``<wrapper>.launches`` counts the
kernel's launches.  The kernels take bf16 and C % 16 == 0 (one mma k-step of
channels); the plain versions any float dtype and C % 8 == 0.

``conv_gru_hside`` is the entry point: without autograd it runs K1; when a
gradient is needed it runs ``ConvGRUHside``, whose forward runs K1-res and
whose backward runs K2 for dh and dgx and two library convolutions for the
weight gradients (the counterpart of ``_dconv_w``, which the JAX package
also leaves to XLA).  K2 reads the weights in the forward's layout and runs
on its own tile (``csrc/gru_hside_bwd_tile.cuh``) under a plan per shape
(``plan_k2``).

``conv_gru_full`` is the whole cell on cat(x, h) with biases, for the
per-package streaming path where no gx exists: kernel K5
(``csrc/gru_full.cu``, on its own tile ``csrc/gru_full_tile.cuh`` under a
plan per shape, ``plan_k5``), the counterpart of ``conv_gru_full_fused``
(``_run_full``/``_full_kernel``).  Inference only, as the JAX kernel (no
VJP).  Its weights are ``ConvGRU.full_weights``: w_ur [9, 2C, 2C] (update
rows, then reset rows; x columns, then h columns), w_o [9, C, 2C], biases
b_ur [2C] and b_o [C] in float32.

``conv_lstm_hside`` is the ConvLSTM h-side cell for the ConvLSTM state
combination: kernel K3 (``csrc/lstm_hside.cu``), the counterpart of
``conv_lstm_hside_fused`` (``_run_lstm``/``_lstm_kernel``).  From the conv
operand h, the cell input c and gx [B, H, W, 4C] in (in, remember, out,
cell) order with the biases folded in (``ConvLSTM.x_gates``):

    i, f, o = sigmoid(conv3x3(h, W4) + gx[i, f, o]);  u = tanh(... + gx[u])
    c' = f * c + i * u;   h' = o * tanh(c')

with w4 [9, 4C, C] = ``ConvLSTM.hside_weights``.  When a gradient is
needed it runs ``ConvLSTMHside``, the counterpart of ``_lstm_hside_cell``'s
custom VJP: its forward runs K3-res (``_lstm_kernel_res``), which also
writes acts [B, H, W, 4C] = (i, f, o, u) in h's dtype, and its backward
``conv_lstm_hside_bwd`` (``_lstm_hside_bwd``: elementwise gate grads and
two library convolutions, XLA in the JAX package too).  The phased cell K4
and its residual variant K4-res are the same source with a template flag
(``ops/phased_cell.py``).  All four run on one tile
(``csrc/lstm_hside_tile.cuh``; K3 and K4 without the acts) under a plan per
kernel and shape (``plan_lstm``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.layout import to_nchw, to_nhwc

# H x W output tiles pick_tile chooses from, largest first: the tiles of
# the first kernel design, whose footprints (smem_bytes, smem_bytes_bwd)
# stay terms of the gate ``supports`` so that it gives the answers it gave;
# no kernel runs them.  K1, K1-res, K10a, K11, K9 and K10b run plan_k1's
# plans (below; K11 through ops/gru_chunk.py::plan_k11, K9 and K10b through
# ops/gru_pair.py::plan_k9), K2 its own (plan_k2), K3, K4, K3-res and
# K4-res theirs (plan_lstm), K5 its own (plan_k5).
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
_SMEM_MAX = 232448           # bytes a block may use on Hopper
_SMEM_TWO_BLOCKS = 110 * 1024
_MIN_BLOCKS = 128            # about one block per SM of the 132


def smem_bytes(tile_h: int, tile_w: int, C: int) -> int:
    """The first h-side design's footprint (the h tile with its 2-pixel
    halo and the a tile with its 1-pixel ring, bf16, at pitch C + 8), kept
    as a term of ``supports`` so that the gate gives the answers it gave;
    K1 and its variants run ``plan_k1``'s plans (``k1_smem_bytes``)."""
    return ((tile_h + 4) * (tile_w + 4) + (tile_h + 2) * (tile_w + 2)) \
        * (C + 8) * 2


def smem_bytes_bwd(tile_h: int, tile_w: int, C: int) -> int:
    """The first K2 design's footprint (dpre_o with a 2-pixel ring at pitch
    C + 8, [dpre_z | dpre_r] with a 1-pixel ring at pitch 2C + 8, both
    bf16, and da*r at the tile in f32), kept as a term of ``supports`` so
    that the gate gives the answers it gave; K2 runs ``plan_k2``'s plans
    (``k2_smem_bytes``)."""
    return ((tile_h + 4) * (tile_w + 4) * (C + 8) * 2
            + (tile_h + 2) * (tile_w + 2) * (2 * C + 8) * 2
            + tile_h * tile_w * C * 4)


def pick_tile(B: int, H: int, W: int, C: int, smem=smem_bytes
              ) -> Optional[Tuple[int, int]]:
    """The largest tile that leaves room for two blocks per SM and still
    gives about one block per SM; else the smallest tile that fits.  None
    when no tile fits in shared memory.  smem: the kernel's footprint."""
    fits = [t for t in _TILES if smem(*t, C) <= _SMEM_MAX]
    if not fits:
        return None
    for th, tw in fits:
        blocks = B * math.ceil(H / th) * math.ceil(W / tw)
        if smem(th, tw, C) <= _SMEM_TWO_BLOCKS and blocks >= _MIN_BLOCKS:
            return th, tw
    return fits[-1]


# -- K1's plan -------------------------------------------------------------
# A K1 block (csrc/gru_hside_tile.cuh) holds the h tile with its 2-pixel
# halo and the a tile with its 1-pixel ring at pitch C + 8, a ring of
# weight slabs and a gx tile where its outputs are staged; `split` blocks
# of a cluster share a pixel tile and take C/split output channels each.
# Each of its 8 warps owns one job per pass over the weights: (MR, NR)
# m16 x n8 tiles of r, (MC, NC) of z and of o.  K1-res stages three
# outputs to K1's one, so the two may get different plans.

K1_COMBOS = ((6, 4, 4, 4), (3, 4, 2, 4), (2, 4, 2, 2))   # (MR, NR, MC, NC)
# K1's and K3-res's/K4-res's plans alike: tile sides, blocks per tile, input
# channels per weight slab (widest first) and the least width that splits
# (the split pays only with wide weights)
_TILE_SIDES = (1, 2, 4, 7, 8, 12, 14, 16)
_SPLITS = (1, 2)
_SLABS = (64, 32, 16)
_MIN_SPLIT_C = 128
_WARPS = 8
# The planner's cost model: a launch takes waves of blocks, and a block's
# microseconds are linear in what it does (k1_cost_terms): mma.sync per
# k16 step on its busiest sub-partition, in passes with two warps on it
# and with one (latency unhidden); the weight bytes it streams; the h, gx,
# h' (and acts) bytes it moves; its weight slabs (each a cp.async group
# and a barrier); a constant, and one more for a cluster and for combo 2.
# The weights are the non-negative least-squares fit (relative error) of
# `gru_hside_timing.py --fit gru_hside_sweep.jsonl` to the plans its
# --sweep timed on an H100 80GB HBM3 at 700 W (936 plans, median error
# 2.5%, the swept best at the six timed shapes; PERF.md §6).  A wave is one
# block per SM, 132: at the planned footprints one block fits per SM and
# 66 clusters of 2 at once (`gru_hside_timing.py`'s max_active_clusters).
_K1_MODEL = {"mma": 0.00355, "mma_lone": 0.0046, "weight_bytes": 1.8e-05,
             "io_bytes": 9.82e-05, "slabs": 0.555, "block": 2.59,
             "split": 2.9, "combo2": 1.88}
_WAVE_BLOCKS = 132


class K1Plan(NamedTuple):
    """How K1 and K1-res run one shape: the output tile, the blocks per
    cluster (each C/split channels), the warp jobs (an index of
    K1_COMBOS) and the input channels per weight slab."""
    tile_h: int
    tile_w: int
    split: int
    combo: int
    ks: int


def k1_smem_bytes(tile_h: int, tile_w: int, C: int, split: int, ks: int,
                  residuals: bool = False) -> int:
    """Shared memory of one K1 (K1-res) block in bytes
    (csrc/gru_hside_tile.cuh's k1_smem_bytes): the h and a tiles at pitch
    C + 8, the weight ring, 2 slabs x 2*cn rows at pitch ks + 8, and the gx
    tile, the larger of the a tile's pixels at pitch cn + 8 and the output
    tile's at 2*cn + 8 (K1-res 3*cn + 8), bf16; cn = C/split."""
    cn = C // split
    gx = max((tile_h + 2) * (tile_w + 2) * (cn + 8),
             tile_h * tile_w * ((3 if residuals else 2) * cn + 8))
    return ((tile_h + 4) * (tile_w + 4) * (C + 8)
            + (tile_h + 2) * (tile_w + 2) * (C + 8)
            + 2 * 2 * cn * (ks + 8) + gx) * 2


def _k1_jobs(plan: K1Plan, C: int) -> Tuple[int, int]:
    """(r jobs, z/o jobs) of one block."""
    mr, nr, mc, nc = K1_COMBOS[plan.combo]
    cn = C // plan.split
    return (math.ceil((plan.tile_h + 2) * (plan.tile_w + 2) / (16 * mr))
            * math.ceil(cn / (8 * nr)),
            math.ceil(plan.tile_h * plan.tile_w / (16 * mc))
            * math.ceil(cn / (8 * nc)))


def plan_blocks(plan, B: int, H: int, W: int) -> int:
    """The blocks a launch of a K1, K2 or K3-res/K4-res plan runs (a K2
    plan has no split)."""
    return (B * math.ceil(H / plan.tile_h) * math.ceil(W / plan.tile_w)
            * getattr(plan, "split", 1))


def plan_waves(plan, B: int, H: int, W: int) -> int:
    """The waves of blocks a launch takes, ``_WAVE_BLOCKS`` at once."""
    return math.ceil(plan_blocks(plan, B, H, W) / _WAVE_BLOCKS)


def _busiest(jobs: int, per_job: int, lone: bool) -> int:
    """per_job summed on a block's busiest sub-partition over the passes
    with two warps on it (lone: with one, whose latency nothing hides)."""
    return sum((2 if a > 4 else 1) * per_job for a in (
        min(_WARPS, jobs - _WARPS * p) for p in range(math.ceil(jobs / _WARPS)))
        if (a <= 4) == lone)


def k1_weight_bytes(plan: K1Plan, B: int, H: int, W: int, C: int) -> int:
    """The weight bytes one launch streams from L2 into shared memory: per
    block and pass over the weights, its C/split rows of Wr (phase r) or of
    Wz and Wo (phase z/o), 9 taps x C inputs, bf16."""
    jr, jc = _k1_jobs(plan, C)
    rows = math.ceil(jr / _WARPS) + 2 * math.ceil(jc / _WARPS)
    return plan_blocks(plan, B, H, W) * rows * (C // plan.split) * 9 * C * 2


def check_k1_plan(plan: K1Plan, C: int, residuals: bool = False) -> None:
    """Raise ValueError unless K1 (residuals: K1-res) can run this plan at
    width C."""
    ok = (plan.tile_h >= 1 and plan.tile_w >= 1
          and plan.split in _SPLITS and (C // 16) % plan.split == 0
          and 0 <= plan.combo < len(K1_COMBOS) and plan.ks in _SLABS
          and C % plan.ks == 0)
    if not ok:
        raise ValueError(f"K1 cannot run plan {plan} at C={C}: split in "
                         f"{_SPLITS} dividing C/16, combo < "
                         f"{len(K1_COMBOS)}, ks in {_SLABS} dividing C")
    smem = k1_smem_bytes(plan.tile_h, plan.tile_w, C, plan.split, plan.ks,
                         residuals)
    if smem > _SMEM_MAX:
        raise ValueError(f"K1 plan {plan} needs {smem} bytes of shared "
                         f"memory at C={C}, over {_SMEM_MAX}")


def k1_cost_terms(plan: K1Plan, C: int, residuals: bool = False) -> dict:
    """What one block of a plan does, in the units of ``_K1_MODEL``."""
    mr, nr, mc, nc = K1_COMBOS[plan.combo]
    jr, jc = _k1_jobs(plan, C)

    pr, pc = math.ceil(jr / _WARPS), math.ceil(jc / _WARPS)
    cn, th, tw = C // plan.split, plan.tile_h, plan.tile_w
    return {
        "mma": (_busiest(jr, mr * nr, False) + _busiest(jc, 2 * mc * nc, False))
        * 9 * C / 16,
        "mma_lone": (_busiest(jr, mr * nr, True) + _busiest(jc, 2 * mc * nc, True))
        * 9 * C / 16,
        "weight_bytes": (pr + 2 * pc) * 9 * C * cn * 2,
        "io_bytes": ((th + 4) * (tw + 4) * C + (th + 2) * (tw + 2) * cn
                     + th * tw * (5 if residuals else 3) * cn) * 2,
        "slabs": (pr + pc) * 9 * (C // plan.ks),
        "block": 1.0, "split": float(plan.split > 1),
        "combo2": float(plan.combo == 2)}


def _k1_cost(plan: K1Plan, B: int, H: int, W: int, C: int,
             residuals: bool = False) -> float:
    """The planner's estimate of a launch's microseconds (``_K1_MODEL``)."""
    terms = k1_cost_terms(plan, C, residuals)
    return plan_waves(plan, B, H, W) * sum(_K1_MODEL[k] * v
                                         for k, v in terms.items())


def _plans(make, H: int, W: int, C: int, max_split: int, combos: int,
           smem, splits=_SPLITS) -> list:
    """Every plan make(tile_h, tile_w, split, combo, ks) of tiles clipped
    to the image, splits (1 below C = _MIN_SPLIT_C, else those of
    ``splits`` dividing C/16 up to max_split) and combos, each with the
    widest slab dividing C whose footprint smem(tile_h, tile_w, split, ks)
    fits in shared memory."""
    if C % 16:
        return []
    plans = []
    tiles = sorted({(min(th, H), min(tw, W)) for th in _TILE_SIDES
                    for tw in _TILE_SIDES})
    for split in splits:
        if split > max_split or (C // 16) % split or (
                split > 1 and C < _MIN_SPLIT_C):
            continue
        for th, tw in tiles:
            for combo in range(combos):
                for ks in _SLABS:
                    if C % ks == 0 and smem(th, tw, split, ks) <= _SMEM_MAX:
                        plans.append(make(th, tw, split, combo, ks))
                        break
    return plans


def _plan_kinds(plans, cost, chosen) -> list:
    """One plan per (split, combo) among plans (the cheapest of each by
    cost), chosen first: the plans a card test runs to cover every code
    path a planner may take."""
    best = {}
    for p in sorted(plans, key=cost):
        best.setdefault((getattr(p, "split", 1), p.combo), p)
    return [chosen] + [p for p in best.values() if p != chosen]


def k1_plans(B: int, H: int, W: int, C: int, max_split: int = 2,
             residuals: bool = False) -> List[K1Plan]:
    """Every plan the planner weighs for this shape of K1 (residuals:
    K1-res) (``_plans``)."""
    return _plans(K1Plan, H, W, C, max_split, len(K1_COMBOS),
                  lambda th, tw, split, ks: k1_smem_bytes(th, tw, C, split, ks,
                                                          residuals))


@functools.lru_cache(maxsize=None)
def plan_k1(B: int, H: int, W: int, C: int, max_split: int = 2,
            residuals: bool = False) -> Optional[K1Plan]:
    """The plan of least estimated cost (``_k1_cost``) among ``k1_plans``,
    the first of equals; None when none fits in shared memory."""
    plans = k1_plans(B, H, W, C, max_split, residuals)
    if not plans:
        return None
    return min(plans, key=lambda p: _k1_cost(p, B, H, W, C, residuals))


def k1_plan_kinds(B: int, H: int, W: int, C: int, residuals: bool = False
                  ) -> List[K1Plan]:
    """One plan per (split, combo) the planner can pick at this shape, the
    planner's own first (``_plan_kinds``)."""
    return _plan_kinds(k1_plans(B, H, W, C, residuals=residuals),
                       lambda p: _k1_cost(p, B, H, W, C, residuals),
                       plan_k1(B, H, W, C, residuals=residuals))


# -- K3's, K4's, K3-res's and K4-res's plan -----------------------------------
# A block of the ConvLSTM tile (csrc/lstm_hside_tile.cuh) holds the conv
# operand's tile with its 1-pixel halo at pitch C + 8, a ring of two weight
# slabs (one tap x ks inputs x the block's 4*cn gate rows) and the io tile,
# where gx and c arrive and the outputs (K3-res, K4-res: and acts) are
# staged; `split` blocks share a pixel tile and take C/split channels each.
# Each of its 8 warps owns one job per pass over the weights: 16*MR pixels
# x 16 channels x the 4 gates.  K3 and K4 (residuals False) keep no acts,
# so their io tile is narrower and their plans may differ from the
# training variants'.

LSTM_COMBOS = (4, 3, 2)   # MR: m16 tiles of a warp job
# Blocks per pixel tile the kernel takes (a plain grid axis, no cluster)
# and the most each kernel's planner weighs: K3 and K4 (residuals False)
# up to 4, which their B=1 sweep picks at every shape with C >= 128 (its
# weight bytes halve again against 2, PERF.md §6), K3-res and K4-res (True)
# up to 2, as their B=8 sweep was timed
_LSTM_SPLITS = (1, 2, 4)
_LSTM_MAX_SPLIT = {False: 4, True: 2}
# The planner's cost model, in the terms of lstm_cost_terms, for the four
# kernels: a launch takes waves of blocks (_WAVE_BLOCKS at once: one block
# fits per SM), a block's microseconds are linear in what it does.  The
# weights are the non-negative least-squares fit of `gru_hside_timing.py
# --lstm --fit lstm_hside_sweep.jsonl` to the plans its --sweep timed on an
# H100 80GB HBM3 at 700 W (3500 plans: K3-res and K4-res at B=8, K3 and K4
# at B=1; median error 2.9%; within 5% of the swept best at every timed
# shape but 32x44x256, where it is within 6%: PERF.md §6).
_LSTM_MODEL = {"mma": 0.00309, "mma_lone": 0.0044, "weight_bytes": 1.63e-05,
               "io_bytes": 7.38e-05, "slabs": 0.626, "time_gate": 0.000855,
               "a_conflicts": 0.000353, "block": 1.5}


class LstmPlan(NamedTuple):
    """How K3, K4, K3-res or K4-res runs one shape: the output tile, the
    blocks per tile (each C/split channels), the warp jobs (an index of
    LSTM_COMBOS) and the input channels per weight slab."""
    tile_h: int
    tile_w: int
    split: int
    combo: int
    ks: int


def lstm_smem_bytes(tile_h: int, tile_w: int, C: int, split: int, ks: int,
                    phased: bool = False, residuals: bool = False) -> int:
    """Shared memory of one K3 (phased: K4; residuals: K3-res, K4-res)
    block in bytes (csrc/lstm_hside_tile.cuh's lstm_smem_bytes): the h tile
    with its 1-pixel halo at pitch C + 8, the weight ring, 2 slabs x 4*cn
    rows at pitch ks + 8, and the io tile, 5*cn + 8 per output pixel (K3-res
    6*cn + 8, K4-res 7*cn + 8), bf16; cn = C/split."""
    cn, px = C // split, tile_h * tile_w
    slots = (7 if phased else 6) if residuals else 5
    return ((tile_h + 2) * (tile_w + 2) * (C + 8) + 2 * 4 * cn * (ks + 8)
            + px * (slots * cn + 8)) * 2


def lstm_jobs(plan: LstmPlan, C: int) -> int:
    """The warp jobs of one block: 16*MR pixels x 16 channels each."""
    return (math.ceil(plan.tile_h * plan.tile_w / (16 * LSTM_COMBOS[plan.combo]))
            * (C // plan.split // 16))


def lstm_weight_bytes(plan: LstmPlan, B: int, H: int, W: int, C: int) -> int:
    """The weight bytes one launch streams from L2 into shared memory: per
    block and pass over the weights its 4*C/split gate rows, 9 taps x C
    inputs, bf16."""
    passes = math.ceil(lstm_jobs(plan, C) / _WARPS)
    return (plan_blocks(plan, B, H, W) * passes * 4 * (C // plan.split)
            * 9 * C * 2)


def _lstm_name(phased: bool, residuals: bool) -> str:
    return f"K{4 if phased else 3}{'-res' if residuals else ''}"


def check_lstm_plan(plan: LstmPlan, C: int, phased: bool = False,
                    residuals: bool = False) -> None:
    """Raise ValueError unless K3 (phased: K4; residuals: K3-res, K4-res)
    can run this plan at width C."""
    name = _lstm_name(phased, residuals)
    ok = (plan.tile_h >= 1 and plan.tile_w >= 1 and C % 16 == 0
          and plan.split in _LSTM_SPLITS and (C // 16) % plan.split == 0
          and 0 <= plan.combo < len(LSTM_COMBOS) and plan.ks in _SLABS
          and C % plan.ks == 0)
    if not ok:
        raise ValueError(f"{name} cannot run plan {plan} at C={C}: "
                         f"C % 16 == 0, split in {_LSTM_SPLITS} dividing "
                         f"C/16, combo < {len(LSTM_COMBOS)}, ks in "
                         f"{_SLABS} dividing C")
    smem = lstm_smem_bytes(plan.tile_h, plan.tile_w, C, plan.split, plan.ks,
                           phased, residuals)
    if smem > _SMEM_MAX:
        raise ValueError(f"{name} plan {plan} needs {smem} bytes of shared "
                         f"memory at C={C}, over {_SMEM_MAX}")


def _ldmatrix_conflicts(n_px: int, width: int, pitch: int, mt: int) -> int:
    """The extra shared-memory wavefronts of the A-fragment ldmatrix loads
    of one k16 step over n_px pixels (rows of ``width`` pixels) taken in
    jobs of mt m16 tiles from a source tile ``pitch`` pixels wide: the 8
    pixels of a matrix load conflict where their source indices y*pitch + x
    repeat mod 8 (the pixel pitch C + 8 is an odd multiple of 16 bytes when
    C % 16 == 0), as they do where a group wraps a row narrower than 8 or
    not a multiple of it."""
    extra = 0
    for m in range(0, math.ceil(n_px / (16 * mt)) * 16 * mt, 8):
        pix = {min(m + r, n_px - 1) for r in range(8)}
        banks = [((p // width) * pitch + p % width) % 8 for p in pix]
        extra += max(banks.count(b) for b in banks) - 1
    return extra


def _lstm_a_conflicts(plan: LstmPlan, C: int) -> int:
    """The extra shared-memory wavefronts of a block's A-fragment ldmatrix
    per k16 step, summed over its jobs (``_ldmatrix_conflicts`` on the h
    tile)."""
    tw = plan.tile_w
    return 2 * _ldmatrix_conflicts(plan.tile_h * tw, tw, tw + 2,
                                   LSTM_COMBOS[plan.combo]) * (C // plan.split // 16)


def lstm_cost_terms(plan: LstmPlan, C: int, phased: bool = False,
                    residuals: bool = False) -> dict:
    """What one block of a plan does, in the units of ``_LSTM_MODEL``:
    mma.sync per k16 step on its busiest sub-partition, over the passes
    with two warps on it and with one (latency unhidden); the weight bytes
    it streams; the h, c, gx and outputs (residuals: and acts; phased: and
    tau, phase) bytes it moves; its weight slabs (each a cp.async group and
    a barrier); K4's time gates (one per pixel and channel); its A-fragment
    bank conflicts over the K walk; a constant."""
    jobs = lstm_jobs(plan, C)
    per_job = 8 * LSTM_COMBOS[plan.combo]   # 4 gates x MR x 2 n8 tiles
    warps = [min(_WARPS, jobs - _WARPS * p)
             for p in range(math.ceil(jobs / _WARPS))]
    cn, th, tw = C // plan.split, plan.tile_h, plan.tile_w
    maps = ((13 if phased else 11) if residuals else (8 if phased else 7))
    return {
        "mma": sum(2 * per_job for a in warps if a > 4) * 9 * C / 16,
        "mma_lone": sum(per_job for a in warps if a <= 4) * 9 * C / 16,
        "weight_bytes": len(warps) * 9 * 4 * cn * C * 2,
        "io_bytes": ((th + 2) * (tw + 2) * C + th * tw * maps * cn) * 2
        + (th * tw * 2 * cn * 4 if phased else 0),
        "slabs": len(warps) * 9 * (C // plan.ks),
        "time_gate": th * tw * cn if phased else 0,
        "a_conflicts": len(warps) * _lstm_a_conflicts(plan, C) * 9 * C / 16,
        "block": 1.0}


def _lstm_cost(plan: LstmPlan, B: int, H: int, W: int, C: int,
               phased: bool = False, residuals: bool = False) -> float:
    """The planner's estimate of a launch's microseconds (``_LSTM_MODEL``)."""
    terms = lstm_cost_terms(plan, C, phased, residuals)
    return plan_waves(plan, B, H, W) * sum(_LSTM_MODEL[k] * v
                                           for k, v in terms.items())


def lstm_plans(B: int, H: int, W: int, C: int, phased: bool = False,
               max_split: Optional[int] = None, residuals: bool = False
               ) -> List[LstmPlan]:
    """Every plan the planner weighs for this shape of K3 (phased: K4;
    residuals: K3-res, K4-res) (``_plans``; max_split None: the kernel's
    own, ``_LSTM_MAX_SPLIT``)."""
    if max_split is None:
        max_split = _LSTM_MAX_SPLIT[residuals]
    return _plans(LstmPlan, H, W, C, max_split, len(LSTM_COMBOS),
                  lambda th, tw, split, ks: lstm_smem_bytes(
                      th, tw, C, split, ks, phased, residuals), _LSTM_SPLITS)


@functools.lru_cache(maxsize=None)
def plan_lstm(B: int, H: int, W: int, C: int, phased: bool = False,
              max_split: Optional[int] = None, residuals: bool = False
              ) -> Optional[LstmPlan]:
    """K3's (phased: K4's; residuals: K3-res's, K4-res's) plan: the least
    estimated cost (``_lstm_cost``) among ``lstm_plans``, the first of
    equals; None when none fits in shared memory."""
    plans = lstm_plans(B, H, W, C, phased, max_split, residuals)
    if not plans:
        return None
    return min(plans, key=lambda p: _lstm_cost(p, B, H, W, C, phased,
                                               residuals))


def lstm_plan_kinds(B: int, H: int, W: int, C: int, phased: bool = False,
                    residuals: bool = False) -> List[LstmPlan]:
    """One plan per (split, combo) the planner can pick at this shape, the
    planner's own first (``_plan_kinds``)."""
    return _plan_kinds(
        lstm_plans(B, H, W, C, phased, residuals=residuals),
        lambda p: _lstm_cost(p, B, H, W, C, phased, residuals),
        plan_lstm(B, H, W, C, phased, residuals=residuals))


# -- K2's plan ---------------------------------------------------------------
# A K2 block (csrc/gru_hside_bwd_tile.cuh) holds dpre_o with its 2-pixel
# ring at pitch C + 8, [dpre_z | dpre_r] with its 1-pixel ring at 2C + 8, a
# ring of two weight slabs (one tap x ks contraction rows x the block's cn
# channels), the io tile (h and r of its channels on the 1-pixel ring, then
# dh staged) and g*(1 - z) + da*r at the tile in f32, all C channels (no
# split: a cluster split of 2 at C >= 128 timed within the run-to-run
# spread of the best unsplit plan, PERF.md §6).  Each of its 8 warps owns
# one job per pass over the weights: (MR, NR) m16 x n8 tiles of da, (MC,
# NC) of dh.

K2_COMBOS = ((4, 4, 2, 8), (3, 4, 2, 4), (2, 4, 1, 4))   # (MR, NR, MC, NC)
# The planner's cost model, in the terms of k2_cost_terms: a launch takes
# waves of blocks (_WAVE_BLOCKS at once: one block fits per SM), a block's
# microseconds are linear in what it does.  The weights are the
# non-negative least-squares fit of `gru_hside_timing.py --bwd --fit
# gru_hside_bwd_sweep.jsonl` to the plans its --sweep timed on an H100 80GB
# HBM3 at 700 W (308 plans, median error 8.7%, within 3.3% of the swept
# best at the three timed shapes; PERF.md §6).
_K2_MODEL = {"mma": 0.00832, "mma_lone": 0.0107, "weight_bytes": 9.72e-06,
             "io_bytes": 4.24e-05, "slabs": 0.184, "a_conflicts": 0.00156}


class K2Plan(NamedTuple):
    """How K2 runs one shape: the output tile, the warp jobs (an index of
    K2_COMBOS) and the contraction rows per weight slab."""
    tile_h: int
    tile_w: int
    combo: int
    ks: int


def k2_smem_bytes(tile_h: int, tile_w: int, C: int, ks: int) -> int:
    """Shared memory of one K2 block in bytes
    (csrc/gru_hside_bwd_tile.cuh's k2_smem_bytes): the dpre_o tile with its
    2-pixel ring at pitch C + 8, the [dpre_z | dpre_r] tile and the io tile
    (h and r, later dh) with the 1-pixel ring at 2C + 8, the weight ring, 2
    slabs x ks rows at pitch C + 8, bf16; the tile's C f32."""
    ring, px = (tile_h + 2) * (tile_w + 2), tile_h * tile_w
    return ((tile_h + 4) * (tile_w + 4) * (C + 8) + 2 * ring * (2 * C + 8)
            + 2 * ks * (C + 8)) * 2 + px * C * 4


def _k2_jobs(plan: K2Plan, C: int) -> Tuple[int, int]:
    """(phase-da jobs, phase-dh jobs) of one block."""
    mr, nr, mc, nc = K2_COMBOS[plan.combo]
    return (math.ceil((plan.tile_h + 2) * (plan.tile_w + 2) / (16 * mr))
            * math.ceil(C / (8 * nr)),
            math.ceil(plan.tile_h * plan.tile_w / (16 * mc))
            * math.ceil(C / (8 * nc)))


def k2_weight_bytes(plan: K2Plan, B: int, H: int, W: int, C: int) -> int:
    """The weight bytes one launch streams from L2 into shared memory: per
    block and pass over the weights, Wo (phase da, 9 taps x C x C) or Wur
    (phase dh, 9 taps x 2C x C), bf16."""
    jd, jh = _k2_jobs(plan, C)
    rows = math.ceil(jd / _WARPS) + 2 * math.ceil(jh / _WARPS)
    return plan_blocks(plan, B, H, W) * rows * C * 9 * C * 2


def check_k2_plan(plan: K2Plan, C: int) -> None:
    """Raise ValueError unless K2 can run this plan at width C."""
    ok = (plan.tile_h >= 1 and plan.tile_w >= 1 and C % 16 == 0
          and 0 <= plan.combo < len(K2_COMBOS) and plan.ks in _SLABS
          and C % plan.ks == 0)
    if not ok:
        raise ValueError(f"K2 cannot run plan {plan} at C={C}: C % 16 == 0, "
                         f"combo < {len(K2_COMBOS)}, ks in {_SLABS} "
                         "dividing C")
    smem = k2_smem_bytes(plan.tile_h, plan.tile_w, C, plan.ks)
    if smem > _SMEM_MAX:
        raise ValueError(f"K2 plan {plan} needs {smem} bytes of shared "
                         f"memory at C={C}, over {_SMEM_MAX}")


def k2_cost_terms(plan: K2Plan, C: int) -> dict:
    """What one block of a plan does, in the units of ``_K2_MODEL``:
    mma.sync per k16 step on its busiest sub-partition, over the passes
    with two warps on it and with one (latency unhidden); the weight bytes
    it streams; the g, h, acts, dh and dgx bytes it moves (g, z, o on the
    2-pixel ring and h on the 1-pixel ring for all C, h and r of its
    channels there, its dgx and dh at the tile); its weight slabs (each a
    cp.async group and a barrier); its A-fragment bank conflicts over the
    K walk (``_ldmatrix_conflicts`` on the dpre_o and [dpre_z | dpre_r]
    tiles).  (A constant per block, as K1's model has, fitted to 0 on K2's
    sweep.)"""
    mr, nr, mc, nc = K2_COMBOS[plan.combo]
    jd, jh = _k2_jobs(plan, C)

    pd, ph = math.ceil(jd / _WARPS), math.ceil(jh / _WARPS)
    th, tw = plan.tile_h, plan.tile_w
    return {
        "mma": (_busiest(jd, mr * nr, False) + 2 * _busiest(jh, mc * nc, False))
        * 9 * C / 16,
        "mma_lone": (_busiest(jd, mr * nr, True) + 2 * _busiest(jh, mc * nc, True))
        * 9 * C / 16,
        "weight_bytes": (pd + 2 * ph) * 9 * C * C * 2,
        "io_bytes": ((th + 4) * (tw + 4) * 3 * C
                     + (th + 2) * (tw + 2) * 3 * C + th * tw * 4 * C) * 2,
        "slabs": (pd + 2 * ph) * 9 * (C // plan.ks),
        "a_conflicts": (pd * math.ceil(C / (8 * nr)) * _ldmatrix_conflicts(
            (th + 2) * (tw + 2), tw + 2, tw + 4, mr)
            + 2 * ph * math.ceil(C / (8 * nc)) * _ldmatrix_conflicts(
                th * tw, tw, tw + 2, mc)) * 9 * C / 16}


def _k2_cost(plan: K2Plan, B: int, H: int, W: int, C: int) -> float:
    """The planner's estimate of a launch's microseconds (``_K2_MODEL``)."""
    terms = k2_cost_terms(plan, C)
    return plan_waves(plan, B, H, W) * sum(_K2_MODEL[k] * v
                                         for k, v in terms.items())


def k2_plans(B: int, H: int, W: int, C: int) -> List[K2Plan]:
    """Every plan the planner weighs for this shape of K2 (``_plans``
    without a split)."""
    return _plans(lambda th, tw, split, combo, ks: K2Plan(th, tw, combo, ks),
                  H, W, C, 1, len(K2_COMBOS),
                  lambda th, tw, split, ks: k2_smem_bytes(th, tw, C, ks))


@functools.lru_cache(maxsize=None)
def plan_k2(B: int, H: int, W: int, C: int) -> Optional[K2Plan]:
    """K2's plan: the least estimated cost (``_k2_cost``) among
    ``k2_plans``, the first of equals; None when none fits in shared
    memory."""
    plans = k2_plans(B, H, W, C)
    if not plans:
        return None
    return min(plans, key=lambda p: _k2_cost(p, B, H, W, C))


def k2_plan_kinds(B: int, H: int, W: int, C: int) -> List[K2Plan]:
    """One plan per combo the planner can pick at this shape, the
    planner's own first (``_plan_kinds``)."""
    return _plan_kinds(k2_plans(B, H, W, C),
                       lambda p: _k2_cost(p, B, H, W, C), plan_k2(B, H, W, C))


# -- K5's plan ---------------------------------------------------------------
# A K5 block (csrc/gru_full_tile.cuh) holds the x and h tiles with their
# 2-pixel halo and the a tile with its 1-pixel ring at pitch C + 8, a ring
# of two weight slabs (one tap x ks of the 2C inputs x the block's output
# rows) and h' staged at the output tile; `split` blocks of a cluster share
# a pixel tile and take C/split output channels each.  Each of its 8 warps
# owns one job per pass over the weights: (MR, NR) m16 x n8 tiles of r,
# (MC, NC) of z and of o.

K5_COMBOS = ((6, 4, 4, 4), (4, 4, 2, 4), (2, 4, 2, 2), (3, 4, 1, 4))
# The planner's cost model, in the terms of k5_cost_terms: a launch takes
# waves of blocks (_WAVE_BLOCKS at once: one block fits per SM), a block's
# microseconds are linear in what it does.  The weights are the
# non-negative least-squares fit of `gru_hside_timing.py --full --fit
# gru_full_sweep.jsonl` to the plans its --sweep timed on an H100 80GB HBM3
# at 700 W (703 plans, median error 1.7%, within 2% of the swept best at
# the three timed shapes; PERF.md §6).
_K5_MODEL = {"mma": 0.00372, "mma_lone": 0.0049, "weight_bytes": 1.86e-05,
             "io_bytes": 0.000117, "slabs": 0.306, "a_conflicts": 0.000763,
             "block": 2.89, "split": 0.858}


class K5Plan(NamedTuple):
    """How K5 runs one shape: the output tile, the blocks per cluster (each
    C/split channels), the warp jobs (an index of K5_COMBOS) and the input
    channels per weight slab."""
    tile_h: int
    tile_w: int
    split: int
    combo: int
    ks: int


def k5_smem_bytes(tile_h: int, tile_w: int, C: int, split: int,
                  ks: int) -> int:
    """Shared memory of one K5 block in bytes (csrc/gru_full_tile.cuh's
    k5_smem_bytes): the x and h tiles with their 2-pixel halo and the a
    tile with its 1-pixel ring at pitch C + 8, the weight ring, 2 slabs x
    2*cn rows at pitch ks + 8, and h' at the output tile at pitch cn + 8,
    bf16; cn = C/split."""
    cn = C // split
    return ((tile_h + 4) * (tile_w + 4) * 2 * (C + 8)
            + (tile_h + 2) * (tile_w + 2) * (C + 8)
            + 2 * 2 * cn * (ks + 8) + tile_h * tile_w * (cn + 8)) * 2


def _k5_jobs(plan: K5Plan, C: int) -> Tuple[int, int]:
    """(r jobs, z/o jobs) of one block."""
    mr, nr, mc, nc = K5_COMBOS[plan.combo]
    cn = C // plan.split
    return (math.ceil((plan.tile_h + 2) * (plan.tile_w + 2) / (16 * mr))
            * math.ceil(cn / (8 * nr)),
            math.ceil(plan.tile_h * plan.tile_w / (16 * mc))
            * math.ceil(cn / (8 * nc)))


def k5_weight_bytes(plan: K5Plan, B: int, H: int, W: int, C: int) -> int:
    """The weight bytes one launch streams from L2 into shared memory: per
    block and pass over the weights, its C/split rows of Wr (phase r) or of
    Wz and Wo (phase z/o), 9 taps x 2C inputs, bf16."""
    jr, jc = _k5_jobs(plan, C)
    rows = math.ceil(jr / _WARPS) + 2 * math.ceil(jc / _WARPS)
    return plan_blocks(plan, B, H, W) * rows * (C // plan.split) * 9 * 2 * C * 2


def check_k5_plan(plan: K5Plan, C: int) -> None:
    """Raise ValueError unless K5 can run this plan at width C."""
    ok = (plan.tile_h >= 1 and plan.tile_w >= 1 and C % 16 == 0
          and plan.split in _SPLITS and (C // 16) % plan.split == 0
          and 0 <= plan.combo < len(K5_COMBOS) and plan.ks in _SLABS
          and C % plan.ks == 0)
    if not ok:
        raise ValueError(f"K5 cannot run plan {plan} at C={C}: C % 16 == 0, "
                         f"split in {_SPLITS} dividing C/16, combo < "
                         f"{len(K5_COMBOS)}, ks in {_SLABS} dividing C")
    smem = k5_smem_bytes(plan.tile_h, plan.tile_w, C, plan.split, plan.ks)
    if smem > _SMEM_MAX:
        raise ValueError(f"K5 plan {plan} needs {smem} bytes of shared "
                         f"memory at C={C}, over {_SMEM_MAX}")


def k5_cost_terms(plan: K5Plan, C: int) -> dict:
    """What one block of a plan does, in the units of ``_K5_MODEL``:
    mma.sync per k16 step on its busiest sub-partition, over the passes
    with two warps on it and with one (latency unhidden); the weight bytes
    it streams; the x, h and h' bytes it moves; its weight slabs (each a
    cp.async group and a barrier); its A-fragment bank conflicts over the
    K walk (``_ldmatrix_conflicts``: phase r on the x and h tiles, phase z/o
    on them and on the a tile); a constant, and one more for a cluster."""
    mr, nr, mc, nc = K5_COMBOS[plan.combo]
    jr, jc = _k5_jobs(plan, C)
    pr, pc = math.ceil(jr / _WARPS), math.ceil(jc / _WARPS)
    cn, th, tw = C // plan.split, plan.tile_h, plan.tile_w
    k16 = 9 * C // 16   # k16 steps of one half of the K walk
    nj_r, nj_c = math.ceil(cn / (8 * nr)), math.ceil(cn / (8 * nc))
    conf_x = _ldmatrix_conflicts(th * tw, tw, tw + 4, mc)
    return {
        "mma": (_busiest(jr, mr * nr, False) + _busiest(jc, 2 * mc * nc, False))
        * 2 * k16,
        "mma_lone": (_busiest(jr, mr * nr, True) + _busiest(jc, 2 * mc * nc, True))
        * 2 * k16,
        "weight_bytes": (pr + 2 * pc) * 9 * 2 * C * cn * 2,
        "io_bytes": ((th + 4) * (tw + 4) * 2 * C + th * tw * cn) * 2,
        "slabs": (pr + pc) * 18 * (C // plan.ks),
        "a_conflicts": (2 * nj_r * _ldmatrix_conflicts(
            (th + 2) * (tw + 2), tw + 2, tw + 4, mr)
            + nj_c * (2 * conf_x + _ldmatrix_conflicts(th * tw, tw, tw + 2, mc)))
        * k16,
        "block": 1.0, "split": float(plan.split > 1)}


def _k5_cost(plan: K5Plan, B: int, H: int, W: int, C: int) -> float:
    """The planner's estimate of a launch's microseconds (``_K5_MODEL``)."""
    terms = k5_cost_terms(plan, C)
    return plan_waves(plan, B, H, W) * sum(_K5_MODEL[k] * v
                                         for k, v in terms.items())


def k5_plans(B: int, H: int, W: int, C: int, max_split: int = 2
             ) -> List[K5Plan]:
    """Every plan the planner weighs for this shape of K5 (``_plans``)."""
    return _plans(K5Plan, H, W, C, max_split, len(K5_COMBOS),
                  lambda th, tw, split, ks: k5_smem_bytes(th, tw, C, split, ks))


@functools.lru_cache(maxsize=None)
def plan_k5(B: int, H: int, W: int, C: int, max_split: int = 2
            ) -> Optional[K5Plan]:
    """K5's plan: the least estimated cost (``_k5_cost``) among
    ``k5_plans``, the first of equals; None when none fits in shared
    memory."""
    plans = k5_plans(B, H, W, C, max_split)
    if not plans:
        return None
    return min(plans, key=lambda p: _k5_cost(p, B, H, W, C))


def k5_plan_kinds(B: int, H: int, W: int, C: int) -> List[K5Plan]:
    """One plan per (split, combo) the planner can pick at this shape, the
    planner's own first (``_plan_kinds``)."""
    return _plan_kinds(k5_plans(B, H, W, C),
                       lambda p: _k5_cost(p, B, H, W, C), plan_k5(B, H, W, C))


def supports(h: torch.Tensor) -> bool:
    """Whether the kernels take this NHWC state's dtype and shape: bf16,
    4-D, C a multiple of 16, a K1 plan and a tile of the pair variants and
    of the first backward design that fit in shared memory (a K2 plan
    exists wherever they do)."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0 and pick_tile(*h.shape) is not None
            and plan_k1(*h.shape, residuals=True) is not None
            and pick_tile(*h.shape, smem=smem_bytes_bwd) is not None)


def supports_full(h: torch.Tensor) -> bool:
    """Whether K5 takes this NHWC state (and an x of its shape): bf16,
    4-D, C a multiple of 16 and a plan of K5 that fits in shared
    memory."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0 and plan_k5(*h.shape) is not None)


def supports_lstm(h: torch.Tensor) -> bool:
    """Whether K3 and K4 (and under autograd K3-res and K4-res) take this
    NHWC state: bf16, 4-D, C a multiple of 16 and a plan of K4-res, whose
    footprint is the largest of the four at every plan, so each of them
    has a plan wherever it has one."""
    return (h.dtype == torch.bfloat16 and h.dim() == 4
            and h.shape[-1] % 16 == 0
            and plan_lstm(*h.shape, phased=True, residuals=True) is not None)


# -- plain versions ---------------------------------------------------------


def _work_dtype(h: torch.Tensor) -> torch.dtype:
    """float32 for bf16/f32 states, float64 for float64 (gradcheck)."""
    return torch.promote_types(h.dtype, torch.float32)


def _oihw(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Folded [9, O, C] -> OIHW [O, C, 3, 3]."""
    return w.to(dt).reshape(3, 3, w.shape[1], w.shape[2]).permute(2, 3, 0, 1)


def _cell_plain(h, gx, w_ur, w_o):
    """(h', z, r, o) NCHW: convs and gates in the work dtype on the inputs'
    values (weights rounded to h's dtype), a = r*h rounded to h's dtype
    before the out-gate conv, h' rounded to h's dtype."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    hf = to_nchw(h).to(dt)
    g = to_nchw(gx).to(dt)
    ur = torch.sigmoid(F.conv2d(hf, _oihw(w_ur.to(h.dtype), dt), None, 1, 1)
                       + g[:, :2 * C])
    z, r = ur[:, :C], ur[:, C:]
    a = (r * hf).to(h.dtype).to(dt)
    o = torch.tanh(F.conv2d(a, _oihw(w_o.to(h.dtype), dt), None, 1, 1)
                   + g[:, 2 * C:])
    return (hf * (1.0 - z) + o * z).to(h.dtype), z, r, o


def conv_gru_hside_plain(h: torch.Tensor, gx: torch.Tensor,
                         w_ur: torch.Tensor, w_o: torch.Tensor
                         ) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch (``_cell_plain``): the CPU
    implementation of ``conv_gru_hside`` and the kernel's oracle on the
    card."""
    return to_nhwc(_cell_plain(h, gx, w_ur, w_o)[0]).contiguous()


def conv_gru_hside_res_plain(h: torch.Tensor, gx: torch.Tensor,
                             w_ur: torch.Tensor, w_o: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-res in plain PyTorch: (h', acts = (z, r, o) in h's dtype)."""
    h_new, z, r, o = _cell_plain(h, gx, w_ur, w_o)
    acts = torch.cat([z, r, o], dim=1).to(h.dtype)
    return to_nhwc(h_new).contiguous(), to_nhwc(acts).contiguous()


def conv_gru_hside_bwd_plain(g: torch.Tensor, h: torch.Tensor,
                             acts: torch.Tensor, w_ur: torch.Tensor,
                             w_o: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 in plain PyTorch, the counterpart of ``_gru_hside_bwd_xla``:
    (dh, dgx) in h's dtype from the cotangent g of h', with the gate chain
    in the work dtype and the transposed convs on operands rounded to h's
    dtype."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    a = to_nchw(acts).to(dt)
    z, r, o = a[:, :C], a[:, C:2 * C], a[:, 2 * C:]
    hf = to_nchw(h).to(dt)
    gf = to_nchw(g).to(dt)

    def rounded(x):
        return x.to(h.dtype).to(dt)

    dpre_o = (gf * z) * (1.0 - o * o)
    dpre_z = gf * (o - hf) * z * (1.0 - z)
    da = F.conv_transpose2d(rounded(dpre_o), _oihw(w_o.to(h.dtype), dt),
                            None, 1, 1)
    dpre_r = (da * hf) * r * (1.0 - r)
    dh = gf * (1.0 - z) + da * r
    dh = dh + F.conv_transpose2d(rounded(torch.cat([dpre_z, dpre_r], 1)),
                                 _oihw(w_ur.to(h.dtype), dt), None, 1, 1)
    dgx = torch.cat([dpre_z, dpre_r, dpre_o], 1).to(h.dtype)
    return to_nhwc(dh.to(h.dtype)).contiguous(), to_nhwc(dgx).contiguous()


def conv_gru_full_plain(x: torch.Tensor, h: torch.Tensor,
                        w_ur: torch.Tensor, w_o: torch.Tensor,
                        b_ur: torch.Tensor, b_o: torch.Tensor
                        ) -> torch.Tensor:
    """K5's arithmetic in plain PyTorch: convs and gates in the work dtype
    on x and the weights rounded to h's dtype, float32 biases,
    a = bf16(r*h) before the out gate's conv on cat(x, a), h' rounded to
    h's dtype.  The CPU implementation of ``conv_gru_full`` and the
    kernel's oracle on the card."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    xf = to_nchw(x.to(h.dtype)).to(dt)
    hf = to_nchw(h).to(dt)
    ur = torch.sigmoid(F.conv2d(torch.cat([xf, hf], 1),
                                _oihw(w_ur.to(h.dtype), dt), b_ur.to(dt), 1, 1))
    z, r = ur[:, :C], ur[:, C:]
    a = (r * hf).to(h.dtype).to(dt)
    o = torch.tanh(F.conv2d(torch.cat([xf, a], 1),
                            _oihw(w_o.to(h.dtype), dt), b_o.to(dt), 1, 1))
    return to_nhwc((hf * (1.0 - z) + o * z).to(h.dtype)).contiguous()


def lstm_gates_plain(h: torch.Tensor, gx: torch.Tensor, w4: torch.Tensor):
    """The ConvLSTM gate activations (i, f, o, u), NCHW in the work dtype:
    the conv of h with w4 (rounded to h's dtype) plus gx, then the
    activations (the shared body of K3's and K4's plain versions)."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    g = (F.conv2d(to_nchw(h).to(dt), _oihw(w4.to(h.dtype), dt), None, 1, 1)
         + to_nchw(gx).to(dt))
    return (torch.sigmoid(g[:, :C]), torch.sigmoid(g[:, C:2 * C]),
            torch.sigmoid(g[:, 2 * C:3 * C]), torch.tanh(g[:, 3 * C:]))


def _lstm_cell_plain(h, c, gx, w4):
    """(h', c', (i, f, o, u)) NCHW in the work dtype."""
    gates = lstm_gates_plain(h, gx, w4)
    i, f, o, u = gates
    cell = f * to_nchw(c).to(i.dtype) + i * u
    return o * torch.tanh(cell), cell, gates


def conv_lstm_hside_plain(h: torch.Tensor, c: torch.Tensor, gx: torch.Tensor,
                          w4: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's arithmetic in plain PyTorch: gates and cell in the work dtype,
    (h', c') rounded to h's dtype, h' from the unrounded c'.  The CPU
    implementation of ``conv_lstm_hside`` and the kernel's oracle on the
    card."""
    hid, cell, _ = _lstm_cell_plain(h, c, gx, w4)
    return (to_nhwc(hid.to(h.dtype)).contiguous(),
            to_nhwc(cell.to(h.dtype)).contiguous())


def conv_lstm_hside_res_plain(h: torch.Tensor, c: torch.Tensor,
                              gx: torch.Tensor, w4: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """K3-res in plain PyTorch: (h', c') as ``conv_lstm_hside_plain`` and
    acts [B, H, W, 4C] = (i, f, o, u) rounded to h's dtype."""
    hid, cell, gates = _lstm_cell_plain(h, c, gx, w4)
    return tuple(to_nhwc(v.to(h.dtype)).contiguous()
                 for v in (hid, cell, torch.cat(gates, 1)))


def _wgrad(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The gradient of a bias-free 3x3 'same' conv's weight from its
    NHWC input x and the NCHW-shaped output cotangent d, as a library
    convolution in x's dtype (f32 accumulation), folded [9, rows, C]: the
    counterpart of ``_dconv_w``."""
    rows, C = d.shape[1], x.shape[-1]
    w = torch.nn.grad.conv2d_weight(to_nchw(x), (rows, C, 3, 3),
                                    d.to(x.dtype), padding=1)
    return w.permute(2, 3, 0, 1).reshape(9, rows, C)


def hside_weight_grads(h: torch.Tensor, acts: torch.Tensor,
                       dgx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The h-side weight gradients, folded [9, 2C, C] and [9, C, C]
    (``_wgrad``): W_ur's from h and dgx's (z, r) part, W_o's from
    a = bf16(r*h) and dgx's o part, as ``_gru_hside_bwd_xla``."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    a = (acts[..., C:2 * C].to(dt) * h.to(dt)).to(h.dtype)
    ds = to_nchw(dgx)
    return _wgrad(h, ds[:, :2 * C]), _wgrad(a, ds[:, 2 * C:])


def conv_lstm_hside_bwd(g_hid: torch.Tensor, g_cell: torch.Tensor,
                        h: torch.Tensor, c: torch.Tensor,
                        cell_new: torch.Tensor, acts: torch.Tensor,
                        w4: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The ConvLSTM h-side cell's backward, the counterpart of
    ``_lstm_hside_bwd``: from the cotangents of (h', c') and the residuals
    (h, c, c' and acts = (i, f, o, u) of K3-res), (dh, dc, dgx, dw4).  The
    gate gradients in the work dtype from acts; dh by a transposed
    convolution of dgx rounded to h's dtype with w4 rounded to h's dtype,
    f32 accumulation; dw4 folded [9, 4C, C] by ``_wgrad``; dc = dc' * f.
    dh and dc in h's dtype, dgx in the work dtype (the caller rounds it
    to gx's), dw4 in h's dtype.  Library convolutions and elementwise ops,
    as the JAX package leaves them to XLA: no kernel."""
    C = h.shape[-1]
    dt = _work_dtype(h)
    i, f, o, u = acts.to(dt).split(C, dim=-1)
    t = torch.tanh(cell_new.to(dt))
    gh = g_hid.to(dt)
    dcn = gh * o * (1.0 - t * t) + g_cell.to(dt)
    dg = torch.cat([(dcn * u) * i * (1.0 - i), (dcn * c.to(dt)) * f * (1.0 - f),
                    (gh * t) * o * (1.0 - o), (dcn * i) * (1.0 - u * u)], -1)
    ds = to_nchw(dg.to(h.dtype))
    dh = F.conv_transpose2d(ds.to(dt), _oihw(w4.to(h.dtype), dt), None, 1, 1)
    return (to_nhwc(dh.to(h.dtype)).contiguous(), (dcn * f).to(h.dtype), dg,
            _wgrad(h, ds))


# -- the kernels ------------------------------------------------------------


def _check(h, gx, w_ur, w_o) -> None:
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


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ERR = {"ramnet_cuda_error_string": (ctypes.c_char_p, (_I,))}
_FWD_SIGNATURES = {
    "ramnet_gru_hside_forward": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _L, _I, _I, _I, _I, _I, _P)),
    "ramnet_gru_hside_forward_res": (_I, (_P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _L, _I, _I, _I, _I, _I,
                                          _P)),
    "ramnet_gru_hside_forward_sel": (_I, (_P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _I, _P)),
    "ramnet_cluster_launch_supported": (_I, (_I,)),
    "ramnet_gru_hside_max_active_clusters": (_I, (_I,) * 7),
    **_ERR,
}
_BWD_SIGNATURES = {
    "ramnet_gru_hside_backward": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _I, _I, _P)),
    **_ERR,
}
_FULL_SIGNATURES = {
    "ramnet_gru_full_forward": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _P)),
    **_ERR,
}
_F = ctypes.c_float
_LSTM_SIGNATURES = {
    "ramnet_lstm_hside_forward": (_I, (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _L, _I, _I, _I, _I, _I, _P)),
    "ramnet_lstm_hside_forward_res": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                           _I, _I, _L, _I, _I, _I, _I, _I,
                                           _P)),
    "ramnet_lstm_phased_forward": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _L, _I, _I,
                                        _I, _I, _I, _F, _F, _P)),
    "ramnet_lstm_phased_forward_res": (_I, (_P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _P, _P, _I, _I, _I, _I, _L,
                                            _I, _I, _I, _I, _I, _F, _F, _P)),
    "ramnet_lstm_blocks_per_sm": (_I, (_I,) * 8),
    **_ERR,
}
# csrc/<name>.cu; gru_hside holds K1, K1-res and the gx-streaming cell K10a
# (ops/gru_stream.py), lstm_hside K3, the phased cell K4 and their residual
# variants K3-res and K4-res, gru_cells the pair cells K9 and K10b
# (ops/gru_pair.py, ops/gru_stream.py), gru_chunk the whole-chunk cell K11
# (ops/gru_chunk.py); the last three on K1's tile
SOURCES = ("gru_hside", "gru_hside_bwd", "gru_full", "lstm_hside",
           "gru_cells", "gru_chunk")


def library():
    """The built and loaded K1/K1-res/K10a library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_hside", _FWD_SIGNATURES)


def library_bwd():
    """The built and loaded K2 library (nvcc on first use)."""
    from .. import kernels
    return kernels.library("gru_hside_bwd", _BWD_SIGNATURES)


# K5 with the IEEE gates (expf, a correctly rounded division, tanhf) in
# place of ex2/rcp: the build its errors and times are measured against
# (csrc/gru_full_tile.cuh)
K5_EXACT_GATES = ("RAMNET_K5_EXACT_GATES",)


def library_full(defines=()):
    """The built and loaded K5 library (nvcc on first use);
    ``K5_EXACT_GATES`` for the IEEE-gate build."""
    from .. import kernels
    return kernels.library("gru_full", _FULL_SIGNATURES, defines)


# K3, K4, K3-res and K4-res with the IEEE gates (expf, a correctly rounded
# division, tanhf) in place of ex2/rcp: the build their errors and times
# are measured against (csrc/lstm_hside_tile.cuh)
LSTM_EXACT_GATES = ("RAMNET_LSTM_EXACT_GATES",)


def library_lstm(defines=()):
    """The built and loaded K3/K4 (and K3-res/K4-res) library (nvcc on first
    use); ``LSTM_EXACT_GATES`` for the IEEE-gate build."""
    from .. import kernels
    return kernels.library("lstm_hside", _LSTM_SIGNATURES, defines)


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ramnet_cuda_error_string(err).decode())


def _check_launch(*tensors) -> None:
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("the CUDA kernels take bf16 tensors; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if tensors[0].shape[-1] % 16:
        raise ValueError("the CUDA kernels take C % 16 == 0, got "
                         f"C={tensors[0].shape[-1]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernels' tensors must be 16-byte aligned")


def _gx_bstride(h, gx, gates: int = 3) -> int:
    B, H, W, C = h.shape
    if gx.stride()[1:] != (W * gates * C, gates * C, 1):
        raise ValueError("gx must be contiguous within each batch item "
                         f"(strides {gx.stride()})")
    stride = gx.stride(0) if B > 1 else H * W * gates * C
    if stride % 8:
        raise ValueError("gx's batch stride must keep 16-byte alignment")
    return stride


def _resolve_plan(h, plan, make, planner, check, what: str):
    """planner(*h.shape), the planner's plan for h's shape, or the given
    plan as make(*plan) once check(plan, C) passes; what names the kernel
    in the error when no plan fits."""
    C = h.shape[-1]
    if plan is None:
        plan = planner(*h.shape)
        if plan is None:
            raise ValueError(f"C={C} does not fit {what}'s shared memory")
        return plan
    plan = make(*plan)
    check(plan, C)
    return plan


@functools.lru_cache(maxsize=None)
def _cluster_launch_supported(device: int) -> bool:
    """Whether the device launches thread-block clusters (asked once)."""
    return bool(library().ramnet_cluster_launch_supported(device))


def check_cluster_launch(h, plan, what: str) -> None:
    """Raise unless h's device can launch the plan's clusters (a plan with
    split > 1 needs thread-block cluster launch)."""
    if plan.split > 1 and not _cluster_launch_supported(h.device.index):
        raise RuntimeError(f"{what} plan {plan} needs a thread-block cluster "
                           f"launch, which {h.device} does not support")


def _launch(h, gx, w_ur, w_o, residuals: bool, plan=None):
    _check_launch(h, gx, w_ur, w_o)
    if not (h.is_contiguous() and w_ur.is_contiguous()
            and w_o.is_contiguous()):
        raise ValueError("h, w_ur and w_o must be contiguous")
    B, H, W, C = h.shape
    gx_bstride = _gx_bstride(h, gx)
    plan = _resolve_plan(h, plan, K1Plan,
                         functools.partial(plan_k1, residuals=residuals),
                         functools.partial(check_k1_plan, residuals=residuals),
                         "K1")
    lib = library()
    check_cluster_launch(h, plan, "K1")
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if residuals:
        acts = torch.empty((B, H, W, 3 * C), dtype=h.dtype, device=h.device)
        err = lib.ramnet_gru_hside_forward_res(
            h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
            out.data_ptr(), acts.data_ptr(), B, H, W, C, gx_bstride, *plan,
            stream)
        _raise_on(err, lib, f"gru_hside_res (plan {plan})")
        conv_gru_hside_res.launches += 1
        return out, acts
    err = lib.ramnet_gru_hside_forward(
        h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
        out.data_ptr(), B, H, W, C, gx_bstride, *plan, stream)
    _raise_on(err, lib, f"gru_hside (plan {plan})")
    conv_gru_hside.launches += 1
    return out


def _launch_bwd(g, h, acts, w_ur, w_o, plan=None):
    B, H, W, C = h.shape
    g, h, acts = g.contiguous(), h.contiguous(), acts.contiguous()
    w_ur, w_o = w_ur.contiguous(), w_o.contiguous()
    _check_launch(h, g, acts, w_ur, w_o)
    plan = _resolve_plan(h, plan, K2Plan, plan_k2, check_k2_plan, "K2")
    lib = library_bwd()
    dh = torch.empty_like(h)
    dgx = torch.empty((B, H, W, 3 * C), dtype=h.dtype, device=h.device)
    err = lib.ramnet_gru_hside_backward(
        g.data_ptr(), h.data_ptr(), acts.data_ptr(), w_ur.data_ptr(),
        w_o.data_ptr(), dh.data_ptr(), dgx.data_ptr(), B, H, W, C, *plan,
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(err, lib, f"gru_hside_bwd (plan {plan})")
    conv_gru_hside_bwd.launches += 1
    return dh, dgx


def _check_full(x, h, w_ur, w_o, b_ur, b_o) -> None:
    if h.dim() != 4:
        raise ValueError(f"h must be NHWC [B, H, W, C], got {tuple(h.shape)}")
    C = h.shape[-1]
    if C % 8:
        raise ValueError(f"C must be a multiple of 8, got {C}")
    for name, t, shape in (("x", x, tuple(h.shape)),
                           ("w_ur", w_ur, (9, 2 * C, 2 * C)),
                           ("w_o", w_o, (9, C, 2 * C)),
                           ("b_ur", b_ur, (2 * C,)), ("b_o", b_o, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")


def _launch_full(x, h, w_ur, w_o, b_ur, b_o, plan=None):
    x, h = x.to(h.dtype).contiguous(), h.contiguous()
    w_ur, w_o = w_ur.to(h.dtype).contiguous(), w_o.to(h.dtype).contiguous()
    b_ur, b_o = b_ur.float().contiguous(), b_o.float().contiguous()
    _check_launch(h, x, w_ur, w_o)
    if b_ur.data_ptr() % 16 or b_o.data_ptr() % 16:
        raise ValueError("the kernels' tensors must be 16-byte aligned")
    B, H, W, C = h.shape
    plan = _resolve_plan(h, plan, K5Plan, plan_k5, check_k5_plan, "K5")
    if plan.split > 1 and not _cluster_launch_supported(h.device.index):
        raise RuntimeError(f"K5 plan {plan} needs a thread-block cluster "
                           f"launch, which {h.device} does not support")
    lib = library_full()
    out = torch.empty_like(h)
    err = lib.ramnet_gru_full_forward(
        x.data_ptr(), h.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
        b_ur.data_ptr(), b_o.data_ptr(), out.data_ptr(), B, H, W, C, *plan,
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(err, lib, f"gru_full (plan {plan})")
    conv_gru_full.launches += 1
    return out


def check_lstm(h, c, gx, w4) -> None:
    """Shapes and devices of a ConvLSTM cell's operands (K3, K4)."""
    if h.dim() != 4:
        raise ValueError(f"h must be NHWC [B, H, W, C], got {tuple(h.shape)}")
    B, H, W, C = h.shape
    if C % 8:
        raise ValueError(f"C must be a multiple of 8, got {C}")
    for name, t, shape in (("c", c, (B, H, W, C)), ("gx", gx, (B, H, W, 4 * C)),
                           ("w4", w4, (9, 4 * C, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")


def raise_under_autograd(name: str, *tensors, why: str) -> None:
    """The inference-only kernels have no gradient: raise when autograd
    would need one.  why: why none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no gradient (inference only; {why}): "
                           "run it under no_grad or inference_mode")


def launch_lstm(h, c, gx, w4, phased=None, residuals: bool = False,
                plan: Optional[LstmPlan] = None):
    """K3 (phased None: returns (h', c')) or K4 (phased = (tau, phase, t,
    leak, ratio_on): returns (h_t, h_new, c_new)) on h's stream; with
    residuals K3-res or K4-res, which also return acts [B, H, W, 4C]; all
    on the tile under ``plan`` (``plan_lstm``'s for the kernel when
    None)."""
    h, c, w4 = h.contiguous(), c.contiguous(), w4.to(h.dtype).contiguous()
    _check_launch(h, c, gx, w4)
    B, H, W, C = h.shape
    gx_bstride = _gx_bstride(h, gx, gates=4)
    kw = {"phased": phased is not None, "residuals": residuals}
    name = _lstm_name(**kw)
    plan = _resolve_plan(h, plan, LstmPlan, functools.partial(plan_lstm, **kw),
                         functools.partial(check_lstm_plan, **kw), name)
    lib = library_lstm()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    n_out = 2 if phased is None else 3
    outs = tuple(torch.empty_like(h) for _ in range(n_out))
    if residuals:
        outs += (torch.empty((B, H, W, 4 * C), dtype=h.dtype,
                             device=h.device),)
    ptrs = [o.data_ptr() for o in outs]
    if phased is None:
        fn = (lib.ramnet_lstm_hside_forward_res if residuals
              else lib.ramnet_lstm_hside_forward)
        err = fn(h.data_ptr(), c.data_ptr(), gx.data_ptr(), w4.data_ptr(),
                 *ptrs, B, H, W, C, gx_bstride, *plan, stream)
        _raise_on(err, lib, f"{name} (plan {plan})")
        return outs
    tau, phase, t, leak, ratio_on = phased
    t = t.contiguous()
    if any(x.dtype != torch.float32 or not x.is_contiguous()
           or x.data_ptr() % 16 for x in (tau, phase)) or t.dtype != torch.float32:
        raise ValueError("tau, phase and t must be float32, tau and phase "
                         "contiguous and 16-byte aligned")
    fn = (lib.ramnet_lstm_phased_forward_res if residuals
          else lib.ramnet_lstm_phased_forward)
    err = fn(h.data_ptr(), c.data_ptr(), gx.data_ptr(), w4.data_ptr(),
             tau.data_ptr(), phase.data_ptr(), t.data_ptr(), *ptrs, B, H, W, C,
             gx_bstride, *plan, float(leak), float(ratio_on), stream)
    _raise_on(err, lib, f"{name} (plan {plan})")
    return outs


def _device_of(h: torch.Tensor) -> str:
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no implementation for device {h.device}")
    return h.device.type


def conv_gru_hside_res(h: torch.Tensor, gx: torch.Tensor, w_ur: torch.Tensor,
                       w_o: torch.Tensor, _plan: Optional[K1Plan] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', acts): K1-res for CUDA tensors, ``conv_gru_hside_res_plain`` for
    CPU tensors.  ``conv_gru_hside_res.launches`` counts kernel launches.
    _plan: a ``K1Plan`` that replaces ``plan_k1``'s (tests and timing;
    checked on either device)."""
    _check(h, gx, w_ur, w_o)
    if _device_of(h) == "cpu":
        if _plan is not None:
            check_k1_plan(K1Plan(*_plan), h.shape[-1], residuals=True)
        return conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch(h, gx, w_ur, w_o, residuals=True, plan=_plan)


def conv_gru_hside_bwd(g: torch.Tensor, h: torch.Tensor, acts: torch.Tensor,
                       w_ur: torch.Tensor, w_o: torch.Tensor,
                       _plan: Optional[K2Plan] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, dgx): K2 for CUDA tensors, ``conv_gru_hside_bwd_plain`` for CPU
    tensors.  ``conv_gru_hside_bwd.launches`` counts kernel launches.
    _plan: a ``K2Plan`` that replaces ``plan_k2``'s (tests and timing;
    checked on either device)."""
    _check(h, acts, w_ur, w_o)
    if tuple(g.shape) != tuple(h.shape):
        raise ValueError(f"g must be {tuple(h.shape)}, got {tuple(g.shape)}")
    if _device_of(h) == "cpu":
        if _plan is not None:
            check_k2_plan(K2Plan(*_plan), h.shape[-1])
        return conv_gru_hside_bwd_plain(g, h, acts, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch_bwd(g, h, acts, w_ur, w_o, _plan)


class ConvGRUHside(torch.autograd.Function):
    """h' = cell(h, gx, w_ur, w_o) with gradients for all four inputs.
    The forward runs K1-res and saves (h, acts, the weights in h's dtype)
    when a gradient is needed, K1 otherwise; the backward runs K2 for dh
    and dgx and ``hside_weight_grads``.  Weights may be float32 masters:
    they are rounded to h's dtype for the kernels and their gradients are
    returned in their own dtype."""

    @staticmethod
    def forward(ctx, h, gx, w_ur, w_o):
        wk_ur = w_ur.to(h.dtype).contiguous()
        wk_o = w_o.to(h.dtype).contiguous()
        if not any(ctx.needs_input_grad):
            return conv_gru_hside(h, gx, wk_ur, wk_o)
        h_new, acts = conv_gru_hside_res(h, gx, wk_ur, wk_o)
        ctx.save_for_backward(h, acts, wk_ur, wk_o)
        ctx.dtypes = (gx.dtype, w_ur.dtype, w_o.dtype)
        return h_new

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, acts, w_ur, w_o = ctx.saved_tensors
        dh, dgx = conv_gru_hside_bwd(g.to(h.dtype), h, acts, w_ur, w_o)
        gx_dt, wur_dt, wo_dt = ctx.dtypes
        dw_ur = dw_o = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dw_ur, dw_o = hside_weight_grads(h, acts, dgx)
            dw_ur, dw_o = dw_ur.to(wur_dt), dw_o.to(wo_dt)
        return dh, dgx.to(gx_dt), dw_ur, dw_o


def conv_gru_hside(h: torch.Tensor, gx: torch.Tensor, w_ur: torch.Tensor,
                   w_o: torch.Tensor, _plan: Optional[K1Plan] = None
                   ) -> torch.Tensor:
    """h' [B, H, W, C] from NHWC h, gx and the folded weights (rounded to
    h's dtype).  When autograd needs a gradient of any input this is
    ``ConvGRUHside``; otherwise K1 for CUDA tensors and
    ``conv_gru_hside_plain`` for CPU tensors.  ``conv_gru_hside.launches``
    counts K1's launches.  _plan: a ``K1Plan`` that replaces
    ``plan_k1``'s for K1 (tests and timing; checked on either device)."""
    _check(h, gx, w_ur, w_o)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, gx, w_ur, w_o)):
        return ConvGRUHside.apply(h, gx, w_ur, w_o)
    w_ur, w_o = w_ur.to(h.dtype), w_o.to(h.dtype)
    if _device_of(h) == "cpu":
        if _plan is not None:
            check_k1_plan(K1Plan(*_plan), h.shape[-1])
        return conv_gru_hside_plain(h, gx, w_ur, w_o)
    with torch.cuda.device(h.device):
        return _launch(h, gx, w_ur, w_o, residuals=False, plan=_plan)


def conv_gru_full(x: torch.Tensor, h: torch.Tensor, w_ur: torch.Tensor,
                  w_o: torch.Tensor, b_ur: torch.Tensor, b_o: torch.Tensor,
                  _plan: Optional[K5Plan] = None) -> torch.Tensor:
    """h' [B, H, W, C] of the whole ConvGRU cell from NHWC x and h (of one
    shape) and ``ConvGRU.full_weights``: K5 for CUDA tensors,
    ``conv_gru_full_plain`` for CPU tensors.  Inference only: raises when
    autograd would need a gradient.  ``conv_gru_full.launches`` counts
    K5's launches.  _plan: a ``K5Plan`` that replaces ``plan_k5``'s (tests
    and timing; checked on either device)."""
    _check_full(x, h, w_ur, w_o, b_ur, b_o)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, w_ur, w_o, b_ur, b_o)):
        raise RuntimeError("conv_gru_full has no gradient (inference only, "
                           "as the JAX kernel): run it under no_grad or "
                           "inference_mode")
    if _device_of(h) == "cpu":
        if _plan is not None:
            check_k5_plan(K5Plan(*_plan), h.shape[-1])
        return conv_gru_full_plain(x, h, w_ur, w_o, b_ur, b_o)
    with torch.cuda.device(h.device):
        return _launch_full(x, h, w_ur, w_o, b_ur, b_o, _plan)


def conv_lstm_hside_res(h: torch.Tensor, c: torch.Tensor, gx: torch.Tensor,
                        w4: torch.Tensor, _plan: Optional[LstmPlan] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(h', c', acts): K3-res for CUDA tensors, ``conv_lstm_hside_res_plain``
    for CPU tensors.  ``conv_lstm_hside_res.launches`` counts kernel
    launches.  _plan: an ``LstmPlan`` that replaces ``plan_lstm``'s (tests
    and timing; checked on either device)."""
    check_lstm(h, c, gx, w4)
    if _device_of(h) == "cpu":
        if _plan is not None:
            check_lstm_plan(LstmPlan(*_plan), h.shape[-1], residuals=True)
        return conv_lstm_hside_res_plain(h, c, gx, w4)
    with torch.cuda.device(h.device):
        out = launch_lstm(h, c, gx, w4, residuals=True, plan=_plan)
    conv_lstm_hside_res.launches += 1
    return out


class ConvLSTMHside(torch.autograd.Function):
    """(h', c') = cell(h, c, gx, w4) with gradients for all four inputs.
    The forward runs K3-res and saves (h, c, c', acts, the weight in h's
    dtype) when a gradient is needed, K3 otherwise; the backward is
    ``conv_lstm_hside_bwd``.  The weight may be the float32 master: it is
    rounded to h's dtype for the kernel and its gradient is returned in
    its own dtype, dgx in gx's."""

    @staticmethod
    def forward(ctx, h, c, gx, w4):
        wk = w4.to(h.dtype).contiguous()
        if not any(ctx.needs_input_grad):
            return conv_lstm_hside(h, c, gx, wk)
        hid, cell, acts = conv_lstm_hside_res(h, c, gx, wk)
        ctx.save_for_backward(h, c, cell, acts, wk)
        ctx.dtypes = (gx.dtype, w4.dtype)
        return hid, cell

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_hid, g_cell):
        h, c, cell, acts, wk = ctx.saved_tensors
        dh, dc, dgx, dw = conv_lstm_hside_bwd(g_hid, g_cell, h, c, cell, acts,
                                              wk)
        gx_dt, w_dt = ctx.dtypes
        return dh, dc, dgx.to(gx_dt), dw.to(w_dt)


def conv_lstm_hside(h: torch.Tensor, c: torch.Tensor, gx: torch.Tensor,
                    w4: torch.Tensor, _plan: Optional[LstmPlan] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') [B, H, W, C] of the ConvLSTM h-side cell from NHWC h
    (the conv operand), c (the cell input), gx [B, H, W, 4C] and
    ``ConvLSTM.hside_weights`` (rounded to h's dtype).  When autograd needs
    a gradient of any input this is ``ConvLSTMHside``; otherwise K3 for
    CUDA tensors and ``conv_lstm_hside_plain`` for CPU tensors.
    ``conv_lstm_hside.launches`` counts K3's launches.  _plan: an
    ``LstmPlan`` that replaces ``plan_lstm``'s for K3 (tests and timing;
    checked on either device)."""
    check_lstm(h, c, gx, w4)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, c, gx, w4)):
        return ConvLSTMHside.apply(h, c, gx, w4)
    if _device_of(h) == "cpu":
        if _plan is not None:
            check_lstm_plan(LstmPlan(*_plan), h.shape[-1])
        return conv_lstm_hside_plain(h, c, gx, w4)
    with torch.cuda.device(h.device):
        out = launch_lstm(h, c, gx, w4, plan=_plan)
    conv_lstm_hside.launches += 1
    return out


conv_gru_hside.launches = 0
conv_gru_hside_res.launches = 0
conv_gru_hside_bwd.launches = 0
conv_gru_full.launches = 0
conv_lstm_hside.launches = 0
conv_lstm_hside_res.launches = 0
