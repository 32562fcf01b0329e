#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths at the full width of the flagship EventScape
recipe (configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json,
bf16, 3 encoders, base 32, K=5), with random weights and synthetic data
made from --seed: offline chunked depth inference
(``rpg_ramnet_tpu_torch.eval.run_chunked_streaming``) at 256x512; TBPTT
training with trainer.precompute_x set in code (``python -m
rpg_ramnet_tpu_torch.train``, run in-process) at B=16, L=10, crop 224; the
per-package streaming engine at 256x512 with fused_gru='on' set in code
(``python -m rpg_ramnet_tpu_torch.eval``, in-process); the live path
(``python -m rpg_ramnet_tpu_torch.stream``, in-process) on a 346x260
event log; and the phased irregular-timestamp regime (BASELINE config 3:
the same recipe with phased ConvLSTM encoders and the ConvLSTM state
combination, set in code as the JAX bench does) at 256x352 through the eval
entry point, per package and chunked, with the flagship's ConvLSTM
state-combination variant on the chunked engine; the decoder's opt-in
formulations (fused_decoder='on': kernel K8; composed_decoder='on')
through the chunked engine and the eval entry point's per-package engine;
and TBPTT training of the phased regime (fused_gru='on', B=8, L=10, crop
224, through the training entry point) with a first step of the
ConvLSTM state combination.  It imports nothing of JAX or of the JAX
package.

Phases, each printed as one JSON line:
  1. device        the card, its power limit, the nvcc builds (in parallel;
                   lstm_hside.cu and gru_full.cu also with their IEEE
                   gates);
  2. kernel        K1 against its plain PyTorch version on the card, at the
                   three inference widths, one ragged shape and the edge
                   shapes (H or W below the tile, H = W = 1, C = 16, 48,
                   96, B = 3), under every (split, combo) plan K1's planner
                   can pick at each (its own pick through the wrapper's
                   default path);
  3. slice         two sequences (40 and 8 packages) through the inference
                   path with chunk 16: K1's launch count, finite predictions
                   in [0, 1], the first chunk against fused_gru='off';
  4. timing        K1 and its plain version per cell (device time: the
                   launches queued behind a sleep kernel; K1 also
                   unqueued, its wrapper's time; with K1's plan, device us
                   per launch, weight MB per launch, registers and spills),
                   the slice's maps/s;
  5. kernel_train  K1-res, K2 and the ConvGRUHside Function against their
                   plain versions at the three training shapes (B=16) and
                   one ragged shape; K1-res (h', acts) and K2 (dh, dgx:
                   max and mean error) also under every plan kind there
                   and at the edge shapes;
  6. train         the first step's loss and gradients against
                   fused_gru='off', then the entry point for TRAIN_STEPS
                   optimizer steps and one validation batch on a synthetic
                   on-disk split: finite losses, the K1-res, K2 and K1
                   launch counts, peak memory;
  7. timing_train  training sequences/s with the kernels and with 'off',
                   K1-res and K2 per cell against their plain versions
                   (queued, as phase 4; each kernel also its wrapper's
                   time, its plan, device us, weight MB, registers and
                   spills);
  8. kernel_stream K5 against its plain version at the three per-package
                   shapes, one ragged shape and K1's edge shapes, under
                   every (split, combo) plan K5's planner can pick at each
                   (its own pick through the wrapper's default path), and
                   the IEEE-gate build under the planner's plan; K6 (with
                   and without stats)
                   and K7 (float32 and bf16 factors) on each of their
                   paths (one-pass, tiled) against their plain versions
                   on 5x260x346 at 1M events, one stream window (`live`),
                   800 ragged windows in one launch sequence (`batch800`,
                   one window empty), a sparse padded case, 2^17 events
                   in one band of rows and 1M unsorted events;
  9. stream        the per-package engine through the eval entry point on
                   two sequences (40 and 8 packages): K5's launch count,
                   finite predictions in [0, 1], all of them against
                   fused_gru='off'; then the stream entry point on 20
                   windows of 0.35 events per pixel with --voxel_backend
                   auto (K6), pallas (K7) and scatter, in turns forward
                   and back: the launch counts, every window's grid
                   against its plain version, finite depth maps, K7's
                   against K6's, the wall per window of each backend;
                   the voxelizer entry point on batch800's windows with
                   K6 and K7 (one launch sequence each, the tiled path)
                   against the plain scatter;
 10. timing_stream per-package latency (median, p90) and depth maps/s with
                   K5 and with 'off', K5 per cell against its plain
                   version and the layer 'off' runs (queued, in mirrored
                   turns; K5 and the layer also unqueued, their wrappers'
                   time; K5's plan, device us, weight MB, registers and
                   spills), the voxelizers' device time (torch.profiler)
                   and wrapper time (CUDA events) at 1M, live and
                   batch800 on the path each size picks and K6 on the
                   other, beside index_add_'s and (at 1M) the plain
                   versions', in mirrored turns;
 11. kernel_phased K3 and K4 against their plain versions at the three
                   phased shapes, one ragged shape and the three flagship
                   shapes, under every (split, combo) plan their planner
                   can pick at each (its own pick through the wrapper's
                   default path), and the IEEE-gate build under the
                   planner's plan;
 12. phased        the eval entry point on a synthetic on-disk split with
                   timestamps (two sequences, PHASED_SEQ_LENGTHS packages)
                   at 256x352 with fused_gru='on': K4's and K3's launch
                   counts, finite predictions in [0, 1], all of them
                   against 'off'; again with --scan_chunk PHASED_CHUNK
                   (padded packages counted); then the flagship with the
                   ConvLSTM state combination on run_chunked_streaming
                   under 'auto': K3's count, the first chunk against 'off';
 13. timing_phased phased per-package latency (median, p90) and maps/s,
                   phased chunked maps/s, K3 and K4 per cell against their
                   plain versions (queued, as phase 4; also the kernels'
                   wrapper time, plan, device us, weight MB, registers and
                   spills); K3 at the flagship shapes, where the ConvLSTM
                   state combination runs it, the same, beside the layer
                   fused_gru='off' runs there;
 14. kernel_chunked the chunked path's launch variants against their plain
                   versions: K9 at the flagship scales 0+1 and a ragged B=2
                   pair and K10b at the flagship pair, each under every
                   kind of pair launch (gru_pair.k9_plan_kinds: splits
                   1 + 2, 1 + 1 and 2 + 2, every combo, padding blocks,
                   both block orders), K10b also at steps past
                   either end of its buffer; the registers and spills of
                   every K9/K10b instance; K10a and K10b at the flagship
                   shapes at a step of a 96-step buffer, K11 over S = 96
                   steps (K=5) at each flagship scale, every step against
                   one plain cell on the kernel's previous step; K10a and K11 under every
                   plan kind their planners can pick there, at a ragged
                   shape and at K1's edge shapes (H or W below the tile,
                   C = 16, 48; K11 over two packages), and K11 on a
                   looping grid of 5 blocks at each flagship scale;
 15. chunked_variants the slice's two sequences through run_chunked_streaming
                   with fused_pair='on', fused_stream='on' and both, then
                   forward_sequence_precomputed(chunk_cells=True) over the
                   same chunks: each variant's launch counts, finite
                   predictions in [0, 1], the first chunk against
                   fused_gru='off'; maps/s of every variant beside the
                   default path (K1) and 'off' in mirrored turns; K9, K10a,
                   K10b and K11 per launch against their plain versions
                   (queued), K9 and K10b also beside the two K1 launches
                   they replace, all four also unqueued (wrapper time),
                   with their plans, weight MB per launch, registers and
                   spills;
 16. kernel_decoder, decoder  K8 and the composed layers against the
                   two-stage layers at the three flagship decoder layers
                   (decode batches 96 and 6, with and without the skip)
                   and a ragged layer, K8 also at its border shapes (H, W
                   in {1, 2, 3}); the slice's sequences through
                   run_chunked_streaming with fused_decoder='on' (K8's
                   launch count) and with composed_decoder='on', the first
                   chunk against fused_gru='off'; the eval entry point's
                   per-package engine with fused_decoder='on' (K8's count)
                   against the two-stage layers; maps/s of the two-stage
                   layers, K8 and the composed layers in mirrored turns
                   and their chunk's forward alone (ms per chunk),
                   per-package latency with K8, and per layer K8 (and
                   without its border terms), the two-stage and the
                   composed layer at both batches by CUDA events, K8's
                   device time by torch.profiler;
 17. kernel_train_lstm K3-res and K4-res against their plain versions at
                   the phased training shapes (B=8) and one ragged shape
                   under every plan kind their planner can pick there (max
                   and mean abs error), and the ConvLSTMHside and
                   PhasedCell Functions' gradients against the plain
                   layers' autograd in float32; again with the IEEE-gate
                   build of the kernels (the planner's plans);
 18. train_phased  the phased recipe's first step (loss, every gradient,
                   tau and phase included) against fused_gru='off', then
                   the entry point for TRAIN_STEPS steps and one
                   validation batch on a synthetic split with timestamps:
                   finite losses, the K4-res, K3-res, K4 and K3 launch
                   counts, peak memory; the flagship with the ConvLSTM
                   state combination and precompute_x: its first step
                   against 'off' and K3-res's count;
 19. timing_train_phased phased training sequences/s with 'on' and 'off',
                   K3-res and K4-res per cell against their plain
                   versions (queued, as phase 4; also the kernels' wrapper
                   time, plan, device us, weight MB, registers and
                   spills).
Then the card's name and power limit as nvidia-smi gives them, the kernel
summary (with each kernel's bound: the larger of its MACs at the bf16
dense peak and its bytes at the HBM rate), and last {"ok": true,
"device": {...}}.  Exits non-zero, without
that last line, if there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

H, W, CHUNK = 256, 512, 16
SEQ_LENGTHS = (40, 8)
CONFIG = "configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json"
ROOT = os.path.dirname(os.path.abspath(__file__))
CELL_TOL = 2e-2    # one cell in bf16: eps 7.8e-3, a few roundings stack
K1_TOL = 8e-3      # K1, K1-res (h', acts): two bf16 steps near 1, f32 gates
SLICE_TOL = 5e-2   # sigmoid predictions after L*(K+1) bf16 cells
# (B, H, W, C): the flagship h-side shapes, and a ragged one with B > 1
# whose gx is a strided view, as forward_sequence_precomputed passes it
FLAGSHIP_CELLS = ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256))
RAGGED_CELL = (2, 30, 45, 96)
# K1's and K1-res's edge shapes: H or W below the tile, H = W = 1, C = 16,
# 48 and 96, B > 1 with a strided gx
K1_EDGE_CELLS = ((1, 5, 40, 64), (2, 9, 3, 128), (1, 3, 37, 256),
                 (1, 1, 1, 64), (2, 1, 1, 256), (1, 20, 24, 16),
                 (2, 17, 19, 48), (3, 33, 21, 96))
# training: the flagship recipe's batch, window and crop; its h-side shapes
# at the three scales, and a ragged one with B > 1 and a strided gx
TRAIN_B, TRAIN_L, TRAIN_CROP, TRAIN_STEPS = 16, 10, 224, 2
TRAIN_CELLS = ((16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256))
RAGGED_TRAIN_CELL = (3, 30, 45, 96)
GRAD_TOL = 2e-2    # K2 / Function gradients: max abs error over the plain
                   # version's max magnitude (a few bf16 roundings)
LOSS_TOL = 2e-2    # first step, kernels vs 'off': relative loss difference
COS_TOL = 0.95     # first step, kernels vs 'off': least per-tensor cosine
# the live path: the DAVIS346 sensor of the reference's streaming demo,
# 1M events for the voxelizer times, 20 windows of 0.35 events per pixel
VOX_GRID = (5, 260, 346)            # num_bins, height, width
VOX_EVENTS = 1 << 20
VOX_TOL = 1e-4                      # relative to the grid's magnitude, as
                                    # tests/test_ops.py:97 (atomic order)
VOX_BF16_TOL = 5e-2                 # bf16 factors, tests/test_ops.py:85
STREAM_WINDOWS, STREAM_EVENTS_PER_PIXEL = 20, 0.35
# the voxelizers' timing sizes, (windows, events per window) on VOX_GRID:
# the JAX bench's leg (bench.py:735), one window of the stream entry, and
# one training batch's windows (B=16 x L=10 x K=5) at the raw pipeline's
# 32768 bucket (rpg_ramnet_tpu/data/raw_pipeline.py:27)
VOX_SIZES = {"1M": (1, VOX_EVENTS),
             "live": (1, int(VOX_GRID[1] * VOX_GRID[2] * STREAM_EVENTS_PER_PIXEL)),
             "batch800": (800, 32768)}
VOX_TURNS = 2       # mirrored rounds: each call is timed 2 * VOX_TURNS times
STREAM_BACKENDS = ("auto", "pallas", "scatter")   # phase 9's voxel backends
# the phased regime (BASELINE config 3, bench.py:615-621 of the JAX
# package): MVSEC-sized 256x352, two sequences, the tail one shorter than a
# chunk (cut: the data); its h-side shapes at the three scales, and a
# ragged one with B > 1 and a strided gx
PHASED_H, PHASED_W, PHASED_CHUNK = 256, 352, 8
PHASED_SEQ_LENGTHS = (24, 6)
PHASED = {"recurrent_block_type": "convlstm", "state_combination": "convlstm",
          "use_phased_arch": True, "spatial_resolution": [PHASED_H, PHASED_W]}
PHASED_CELLS = ((1, 128, 176, 64), (1, 64, 88, 128), (1, 32, 44, 256))
RAGGED_LSTM_CELL = (3, 30, 45, 96)
# the chunked path's launch variants (phases 14-15): a ragged pair of
# scales with B=2 and strided gx views for K9, and the step of the 96-step
# gx buffers that K10a and K10b read
RAGGED_PAIR = ((2, 30, 45, 96), (2, 15, 23, 32))
STREAM_STEP = 37
# K10a's and K11's shapes beside the flagship ones (batch 1): a ragged one
# and K1's edge shapes (H or W below the tile, H = W = 1, C = 16, 48); K11
# runs two packages there (EDGE_STEPS), and a looping grid of LOOP_BLOCKS
# blocks at each flagship scale
VARIANT_EDGE_CELLS = ((1, 30, 45, 96), (1, 5, 40, 64), (1, 9, 3, 128),
                      (1, 3, 37, 256), (1, 1, 1, 64), (1, 20, 24, 16),
                      (1, 17, 19, 48))
EDGE_STEPS = 12
LOOP_BLOCKS = 5
VARIANTS = (("pair", {"fused_pair": "on"}), ("stream", {"fused_stream": "on"}),
            ("stream_pair", {"fused_pair": "on", "fused_stream": "on"}))
# the decoder (phase 16): the flagship decoder layers at 256x512 as (C,
# Cout, H, W) of the layer's input (layer 0 takes no skip), the decode
# batches of the chunked engine (CHUNK packages x (K+1) maps) and of the
# per-package engine (K+1 maps), one ragged layer that K8's gate admits
# (odd H and W, 16-channel slabs, three n8 tiles), the decoder options,
# and the per-package split of the eval entry point's run (cut: the data)
DECODER_LAYERS = ((256, 128, 32, 64), (128, 64, 64, 128), (64, 32, 128, 256))
DECODER_BATCHES = (96, 6)
RAGGED_DECODER = (3, 48, 24, 13, 27)            # B, C, Cout, H, W
# K8's border shapes: H, W in {1, 2, 3} (its top and bottom, left and
# right border terms on the same pixels), Cout 24 (a ragged channel slice)
# and 128
BORDER_DECODER = tuple((2, 32, cout, h, w) for cout in (24, 128)
                       for h in (1, 2, 3) for w in (1, 2, 3))
DECODER_TOL = 2e-2   # max abs error over the plain version's max magnitude
DECODER_VARIANTS = (("k8", {"fused_decoder": "on"}),
                    ("composed", {"composed_decoder": "on"}))
TWO_STAGE = {"composed_decoder": "off"}        # neither option, at any batch
DECODER_SEQ_LENGTHS = (6, 3)
# phased training (BASELINE config 3's MVSEC fine-tuning recipe, JAX
# bench.py:1075-1082 train_phased_bf16_deferred_seq_per_sec_B8_L10_224):
# the phased overrides with spatial_resolution = the crop, fused_gru 'on'
# (phased configs cannot precompute the x side), B=8, L=10, 224^2, two
# steps (cut: the data); its cell shapes at the three scales
PHASED_TRAIN_B = 8
PHASED_TRAIN_CELLS = ((8, 112, 112, 64), (8, 56, 56, 128), (8, 28, 28, 256))
# the card's published peaks (H100 SXM, dense bf16; HBM3)
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
# per cell: (MACs per pixel / C^2, bytes moved per pixel / C, weight
# bytes / C^2[, bytes per pixel of the map / C, read once whatever the
# batch]): K1 reads h, gx and writes h'; K1-res also acts; K2 reads g, h,
# acts and writes dh, dgx; K5 reads x, h and writes h'; K3 reads h, c, gx
# (4C) and writes h', c'; K3-res also acts (4C); K4 reads h, c, gx, the
# f32 tau and phase [H, W, C] and writes three maps; K4-res also acts; a
# K11 step reads gx and writes its snapshot (h0 and the events and image
# weights once per launch, counted per step here: far below the
# operations' time)
CELL_WORK = {"k1": (27, 10, 54), "k1_res": (27, 16, 54), "k2": (27, 18, 54),
             "k5": (54, 6, 108), "k3": (36, 16, 72), "k3_res": (36, 24, 72),
             "k4": (36, 18, 72, 8), "k4_res": (36, 26, 72, 8),
             "k11_step": (27, 8, 108)}


def decoder_bound(batch):
    """(least ms, 'operations' or 'bytes') of the three flagship decoder
    layers at one decode batch, summed: per layer the larger of its least
    MACs (the bilinear 2x composed into four 4x4 phase kernels: 16*C*Cout
    per 2x pixel) at the bf16 dense peak and its bytes (x, the skip of
    layers 1 and 2, out, each once; the weights) at the HBM rate."""
    by = {"operations": 0.0, "bytes": 0.0}
    for i, (C, Cout, h, w) in enumerate(DECODER_LAYERS):
        t_ops = 2 * 4 * h * w * 16 * C * Cout * batch / PEAK_FLOPS
        io = batch * h * w * C * 2 * (2 if i else 1) + batch * 4 * h * w * Cout * 2
        t_bytes = (io + 25 * C * Cout * 2) / HBM_BYTES_PER_S
        by["operations" if t_ops >= t_bytes else "bytes"] += max(t_ops, t_bytes)
    return sum(by.values()) * 1e3, max(by, key=by.get)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_cell_inputs(shape, dev, gen, strided_gx=False):
    """NHWC h in (-1, 1), gx ~ N(0, 1) and a ConvGRU's folded h-side
    weights, bf16 on ``dev``."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import ConvGRU
    B, Hc, Wc, C = shape
    cell = ConvGRU(C, C)
    cell.reset_parameters_(gen)
    cell.to(device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights()
    h = (torch.rand((B, Hc, Wc, C), generator=gen) * 2 - 1).to(dev, torch.bfloat16)
    if strided_gx:   # step 1 of a [B, 2, H, W, 3C] buffer
        gx = torch.randn((B, 2, Hc, Wc, 3 * C), generator=gen)
        gx = gx.to(dev, torch.bfloat16)[:, 1]
    else:
        gx = torch.randn((B, Hc, Wc, 3 * C), generator=gen).to(dev, torch.bfloat16)
    return cell, h, gx, w_ur, w_o


def make_bwd_inputs(shape, dev, gen):
    """(g, h, acts, w_ur, w_o) of one K2 call: make_cell_inputs' h and
    weights, acts from the plain K1-res on them, g ~ N(0, 1); bf16 on
    ``dev``."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    _, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen)
    g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    _, acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    return g, h, acts, w_ur, w_o


def plan_name(plan) -> str:
    """A K1 or K3-res/K4-res plan as tile/split/combo/slab width, a K2 plan
    (no split) as tile/combo/slab width."""
    split = f"/s{plan.split}" if hasattr(plan, "split") else ""
    return f"{plan.tile_h}x{plan.tile_w}{split}/c{plan.combo}/k{plan.ks}"


def k1_plan_errors(shape, dev, gen, residuals):
    """{plan: max abs error} of K1 (h') or K1-res (h' and acts) against its
    plain version at one shape (gx strided where B > 1), under every plan
    kind the planner can pick there; its own pick through the wrapper's
    default path."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    _, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen,
                                           strided_gx=shape[0] > 1)
    if residuals:
        want = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    else:
        want = (gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o),)
    errs = {}
    for i, plan in enumerate(gru_hside.k1_plan_kinds(*shape,
                                                     residuals=residuals)):
        kw = {"_plan": plan} if i else {}
        if residuals:
            got = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o, **kw)
        else:
            got = (gru_hside.conv_gru_hside(h, gx, w_ur, w_o, **kw),)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        errs[plan_name(plan)] = err
        if not (err <= K1_TOL):
            raise AssertionError(f"K1{'-res' if residuals else ''} vs plain at "
                                 f"{shape}, plan {plan}: max abs err {err} > "
                                 f"{K1_TOL}")
    return errs


def ptxas_by_kernel(log):
    """{mangled kernel name: {"registers": n, "spill_stores": b,
    "spill_loads": b}} from nvcc -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def kernel_ptxas(ptxas, residuals, combo=None):
    """The ptxas entry of K1 (residuals False) or K1-res: of
    k1_kernel<kRes, MR, NR, MC, NC> for a combo, or with combo None of the
    first design's gru_hside_kernel<kRes> (when gru_hside_timing.py --root
    times an older tree)."""
    flag = f"ILb{int(residuals)}E"
    for name, info in ptxas.items():
        if combo is not None and "k1_kernel" in name and \
                (flag + "".join(f"Li{v}E" for v in combo) + "E") in name:
            return info
        if combo is None and "gru_hside_kernel" in name and flag in name:
            return info
    return None


def k2_ptxas(ptxas, combo=None):
    """The ptxas entry of K2: of k2_kernel<MR, NR, MC, NC> for a combo, or
    with combo None of the first design's gru_hside_bwd_kernel (when
    gru_hside_timing.py --root times an older tree)."""
    for name, info in ptxas.items():
        if combo is not None and "k2_kernel" in name and \
                "I" + "".join(f"Li{v}E" for v in combo) + "E" in name:
            return info
        if combo is None and "gru_hside_bwd_kernel" in name:
            return info
    return None


def k2_plan_errors(shape, dev, gen):
    """{plan: [dh, dgx max abs error over the plain version's max
    magnitude, and their mean abs errors]} of K2 at one shape under every
    plan kind its planner can pick there (its own pick through the
    wrapper's default path), against its plain version."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    g, h, acts, w_ur, w_o = make_bwd_inputs(shape, dev, gen)
    want = gru_hside.conv_gru_hside_bwd_plain(g, h, acts, w_ur, w_o)
    errs = {}
    for i, plan in enumerate(gru_hside.k2_plan_kinds(*shape)):
        kw = {"_plan": plan} if i else {}
        got = gru_hside.conv_gru_hside_bwd(g, h, acts, w_ur, w_o, **kw)
        torch.cuda.synchronize()
        e = [rel_err(a, b) for a, b in zip(got, want)]
        errs[plan_name(plan)] = e + [(a.float() - b.float()).abs().mean().item()
                                     for a, b in zip(got, want)]
        if not (max(e) <= GRAD_TOL):
            raise AssertionError(f"K2 vs plain at {shape}, plan {plan}: "
                                 f"relative errors {e} > {GRAD_TOL}")
    return errs


def kernel_check(dev, gen):
    """Max abs error of K1 against its plain version per shape and plan."""
    return {"x".join(map(str, shape)): k1_plan_errors(shape, dev, gen, False)
            for shape in FLAGSHIP_CELLS + (RAGGED_CELL,) + K1_EDGE_CELLS}


def k1_report(kind, shape, fn):
    """K1's (kind 'k1') or K1-res's plan at shape, its mean device us per
    launch of fn (torch.profiler), the weight MB one launch streams into
    shared memory, and the kernel's registers and spills (ptxas)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    plan = gru_hside.plan_k1(*shape, residuals=kind == "k1_res")
    dev_us, records = launch_device_us(fn, 10)
    return {"plan": plan._asdict(), "device_us": dev_us,
            "device_records": records,
            "weight_mb": gru_hside.k1_weight_bytes(plan, *shape) / 1e6,
            "ptxas": kernel_ptxas(
                ptxas_by_kernel(kernels.build_log.get("gru_hside", "")),
                kind == "k1_res", gru_hside.K1_COMBOS[plan.combo])}


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def train_kernel_check(dev, gen):
    """K1-res (h', acts: max abs error), K2 (dh, dgx) and the ConvGRUHside
    Function (dh, dgx, dw_ur, dw_o; max abs error over the plain version's
    max magnitude) against their plain versions, per shape; K1-res and K2
    also under every plan kind their planners can pick, there and at the
    edge shapes."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    rows = []
    for shape in TRAIN_CELLS + (RAGGED_TRAIN_CELL,):
        res_plans = k1_plan_errors(shape, dev, gen, True)
        _, h, gx, w_ur, w_o = make_cell_inputs(
            shape, dev, gen, strided_gx=shape == RAGGED_TRAIN_CELL)
        g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        got_h, got_acts = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o)
        want_h, want_acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
        dh, dgx = gru_hside.conv_gru_hside_bwd(g, h, want_acts, w_ur, w_o)
        want_dh, want_dgx = gru_hside.conv_gru_hside_bwd_plain(
            g, h, want_acts, w_ur, w_o)
        args = [t.detach().clone().requires_grad_() for t in (h, gx, w_ur, w_o)]
        fn_grads = torch.autograd.grad(gru_hside.ConvGRUHside.apply(*args),
                                       args, g)
        want_fn = (want_dh, want_dgx) + gru_hside.hside_weight_grads(
            h, want_acts, want_dgx)
        torch.cuda.synchronize()
        row = {"shape": list(shape),
               "res_h_err": (got_h.float() - want_h.float()).abs().max().item(),
               "res_acts_err": (got_acts.float() - want_acts.float()).abs().max().item(),
               "bwd_dh_abs_err": (dh.float() - want_dh.float()).abs().max().item(),
               "bwd_dgx_abs_err": (dgx.float() - want_dgx.float()).abs().max().item(),
               "bwd_dh_rel": rel_err(dh, want_dh),
               "bwd_dgx_rel": rel_err(dgx, want_dgx),
               "fn_rel": [rel_err(a, b) for a, b in zip(fn_grads, want_fn)],
               "res_plans": res_plans}
        rows.append(row)
        if not (max(row["res_h_err"], row["res_acts_err"]) <= K1_TOL):
            raise AssertionError(f"K1-res vs plain at {shape}: {row}")
        if not (max([row["bwd_dh_rel"], row["bwd_dgx_rel"]] + row["fn_rel"])
                <= GRAD_TOL):
            raise AssertionError(f"K2 / Function vs plain at {shape}: {row}")
        row["bwd_plans"] = k2_plan_errors(shape, dev, gen)
    edges = {"x".join(map(str, shape)): {"k1_res": k1_plan_errors(shape, dev, gen, True),
                                         "k2": k2_plan_errors(shape, dev, gen)}
             for shape in K1_EDGE_CELLS}
    return rows, edges


def cuda_time_us(fn, iters, queued=False):
    """Microseconds per call of fn by CUDA events over iters calls, after
    three warm-up calls.  queued: the calls wait behind a sleep kernel
    (200k cycles a call, or twice the host's enqueue time of one call at
    2 GHz where that is longer), so the events time the device and not
    the host's launch overhead."""
    import torch
    for _ in range(3):
        fn()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        # the sleep outlasts the host's enqueue of the calls (one timed
        # here), so the events see no gap the host leaves
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda._sleep(max(200_000, int(4e9 * host_s)) * iters)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / iters


def device_time_us(fn, calls):
    """(device us per call, {kernel name: us per call}) of fn: the kernel,
    memset and copy durations torch.profiler records over ``calls`` calls
    after one warm-up call.  Where the profiler records no device time,
    the CUDA events time of a CUDA graph's replay of the calls (no
    names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0.0) + e.device_time / calls
    if sum(names.values()) > 0:
        return sum(names.values()), names
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_us(graph.replay, 3) / calls, {}


def launch_device_us(fn, calls):
    """(mean device us per launch, launches recorded) of fn, which
    launches one kernel per call, over ``calls`` calls after one warm-up
    call, from torch.profiler's kernel records.  The mean is over the
    records: after earlier profiling in the same process the profiler
    drops some (4 of 10 K8 launches recorded late in a full run), which
    would cut a sum divided by the calls.  Where it records none, the
    CUDA events time of a CUDA graph's replay of the calls (0 recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not times:
        return device_time_us(fn, calls)[0], 0
    return sum(times) / len(times), len(times)


def time_train_cells(dev, gen, iters=20):
    """Microseconds per cell of K1-res and K2 and of their plain versions
    at the training shapes, in turns plain, kernel, kernel, plain; each
    kernel also unqueued (its wrapper's time), with its plan, device us
    per launch, weight MB per launch, registers and spills."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    import torch
    rows = []
    for shape in TRAIN_CELLS:
        _, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen)
        g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        _, acts = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o)
        row = {"shape": list(shape)}
        for name, kern, plain in (
                ("res", lambda: gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o),
                 lambda: gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)),
                ("bwd", lambda: gru_hside.conv_gru_hside_bwd(g, h, acts, w_ur, w_o),
                 lambda: gru_hside.conv_gru_hside_bwd_plain(g, h, acts, w_ur, w_o))):
            p1, k1, k2, p2 = (cuda_time_us(f, iters, queued=True)
                              for f in (plain, kern, kern, plain))
            row.update({f"{name}_kernel_us": min(k1, k2),
                        f"{name}_plain_us": min(p1, p2),
                        f"{name}_us_runs_p_k_k_p": [p1, k1, k2, p2]})
            if name == "res":
                row["res_k1"] = k1_report("k1_res", shape, kern)
                row["res_k1"]["wrapper_us"] = min(cuda_time_us(kern, iters)
                                                  for _ in range(2))
            else:
                row["bwd_k2"] = k2_report(shape, kern)
                row["bwd_k2"]["wrapper_us"] = min(cuda_time_us(kern, iters)
                                                  for _ in range(2))
        rows.append(row)
    return rows


def k2_report(shape, fn):
    """K2's plan at shape, its mean device us per launch of fn
    (torch.profiler), the weight MB one launch streams into shared memory,
    and the kernel's registers and spills (ptxas)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    plan = gru_hside.plan_k2(*shape)
    dev_us, records = launch_device_us(fn, 10)
    return {"plan": plan._asdict(), "device_us": dev_us,
            "device_records": records,
            "weight_mb": gru_hside.k2_weight_bytes(plan, *shape) / 1e6,
            "ptxas": k2_ptxas(ptxas_by_kernel(kernels.build_log.get("gru_hside_bwd", "")),
                              gru_hside.K2_COMBOS[plan.combo])}


def time_cells(dev, gen, iters=50):
    """Microseconds per cell, kernel and plain version (and the plain
    layer the 'off' policy runs), in turns plain, kernel, kernel, plain,
    queued (device time); K1's also unqueued (its wrapper's time)."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw

    def cuda_us(fn):
        return cuda_time_us(fn, iters, queued=True)

    rows = []
    for shape in FLAGSHIP_CELLS:
        cell, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen)
        kern = lambda: gru_hside.conv_gru_hside(h, gx, w_ur, w_o)  # noqa: E731
        plain = lambda: gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)  # noqa: E731
        layer = lambda: cell.hside(to_nchw(gx), to_nchw(h))  # noqa: E731
        p1, k1, k2, p2 = cuda_us(plain), cuda_us(kern), cuda_us(kern), cuda_us(plain)
        rows.append({"shape": list(shape), "kernel_us": min(k1, k2),
                     "plain_us": min(p1, p2), "plain_layer_bf16_us": cuda_us(layer),
                     "kernel_us_runs": [k1, k2], "plain_us_runs": [p1, p2],
                     "kernel_wrapper_us": min(cuda_time_us(kern, iters)
                                              for _ in range(2)),
                     **k1_report("k1", shape, kern)})
    return rows


class SyntheticSequence:
    """One recorded sequence in the dataset contract of
    run_chunked_streaming: item i is {'events': [1, K, h, w, 5],
    'image': [1, h, w, 1]}, events ~ N(0, 1), frames ~ U(0, 1); with
    times, also 'times_events' [1, K] and 'times_image' [1], stamps 10 ms
    apart."""

    def __init__(self, n, K, rng, h=H, w=W, times=False):
        import numpy as np
        self.events = rng.standard_normal((n, K, h, w, 5), dtype="float32")
        self.image = rng.random((n, h, w, 1), dtype="float32")
        self.times = (0.01 * np.arange(n * K, dtype=np.float32)).reshape(n, K) \
            if times else None

    def __len__(self):
        return len(self.events)

    def __getitem__(self, i):
        item = {"events": self.events[i:i + 1], "image": self.image[i:i + 1]}
        if self.times is not None:
            item["times_events"] = self.times[i:i + 1]
            item["times_image"] = self.times[i:i + 1, -1]
        return item


class SyntheticDataset:
    def __init__(self, lengths, K, seed, **kw):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.datasets = [SyntheticSequence(n, K, rng, **kw) for n in lengths]


def run_slice(model, dataset, keep=None, chunk=CHUNK):
    """run_chunked_streaming over the dataset, every prediction copied to
    the host and checked.  Returns the predictions of the items in
    ``keep`` (global indices; all when None) and counts of items,
    non-finite values and values outside [0, 1]."""
    import numpy as np
    from rpg_ramnet_tpu_torch.eval import run_chunked_streaming
    kept, stats = {}, {"items": 0, "nonfinite": 0, "out_of_range": 0}

    def on_prediction(gidx, preds, item, seq_pos):
        stats["items"] += 1
        for v in preds.values():
            stats["nonfinite"] += int((~np.isfinite(v)).sum())
            stats["out_of_range"] += int(((v < 0) | (v > 1)).sum())
        if keep is None or gidx in keep:
            kept[gidx] = preds

    run_chunked_streaming(dataset, model, chunk=chunk,
                          on_prediction=on_prediction)
    return kept, stats


def check_no_jax():
    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "rpg_ramnet_tpu"))
    if jax_modules:
        raise AssertionError(f"the port loaded JAX modules: {jax_modules[:5]}")


def max_pred_diff(a, b):
    import numpy as np
    return max(float(np.abs(a[g][k] - b[g][k]).max())
               for g in a for k in a[g])


def write_train_data(root, K, seed, batch=TRAIN_B):
    """Synthetic on-disk splits at the crop size, timestamps included: one
    training sequence with TRAIN_STEPS * batch windows of TRAIN_L packages
    (step_size 1) and one validation sequence with two windows."""
    from rpg_ramnet_tpu_torch.data import generate_split
    for split, windows, s in (("train", TRAIN_STEPS * batch, seed),
                              ("val", 2, seed + 100)):
        generate_split(os.path.join(root, split), n_sequences=1, seed=s,
                       n_frames=TRAIN_L * K + K * (windows - 1),
                       height=TRAIN_CROP, width=TRAIN_CROP)


def train_config(tmp):
    """The flagship config with trainer.precompute_x on, the run directory
    and data folders in tmp, one epoch, a checkpoint after it."""
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = json.load(f)
    raw["name"] = "smoke_train"
    raw["trainer"].update(precompute_x=True, epochs=1, save_freq=1,
                          log_every=1, save_dir=os.path.join(tmp, "runs"),
                          sequence_length=TRAIN_L)
    raw["data_loader"]["batch_size"] = TRAIN_B
    for split, folder in (("train", "train"), ("validation", "val")):
        raw["data_loader"][split].update(base_folder=folder, step_size=1)
    raw["data_loader"]["crop_size"] = TRAIN_CROP
    return raw


def first_step_vs_off(cfg, root, dev, seed, counters):
    """Loss and every parameter gradient of one window batch
    (cfg.batch_size windows, with timestamps where cfg.use_phased_arch)
    with the kernels (cfg.model.fused_gru, 'auto' or 'on') and with the
    plain layers ('off'), from the same weights.  counters: {name:
    (wrapper, launches expected with the kernels)}; 'off' must launch
    none.  Returns the batch, both models and the comparison."""
    import torch
    from rpg_ramnet_tpu_torch.data import BatchLoader, concatenate_subfolders
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.train.sequence_loss import (make_sequence_loss,
                                                          pack_train_batch)
    split = cfg.train_data
    ds = concatenate_subfolders(
        os.path.join(root, "train"), split.type, split.event_folder,
        split.depth_folder, split.frame_folder, TRAIN_L, step_size=1,
        clip_distance=split.clip_distance,
        every_x_rgb_frame=split.every_x_rgb_frame,
        reg_factor=split.reg_factor, use_phased_arch=cfg.use_phased_arch)
    b = cfg.batch_size
    batch = pack_train_batch(next(iter(BatchLoader(ds, b, shuffle=False))),
                             dev)
    kern = cfg.model.fused_gru
    models, losses, grads, launched = {}, {}, {}, {}
    for mode in (kern, "off"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               fused_gru=mode))
        model = ERGB2DepthRecurrent(c.model, device=dev,
                                    generator=torch.Generator().manual_seed(seed))
        n0 = {k: w.launches for k, (w, _) in counters.items()}
        loss, _ = make_sequence_loss(c, remat=True)(
            model, model.init_state(b, TRAIN_CROP, TRAIN_CROP), batch)
        loss.backward()
        torch.cuda.synchronize()
        launched[mode] = {k: w.launches - n0[k] for k, (w, _) in counters.items()}
        models[mode], losses[mode] = model, loss.item()
        grads[mode] = {n: p.grad.float() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    want = {kern: {k: n for k, (_, n) in counters.items()},
            "off": {k: 0 for k in counters}}
    if launched != want:
        raise AssertionError(f"first step launches {launched}, expected {want}")
    cos = {n: torch.nn.functional.cosine_similarity(
        grads[kern][n].flatten(), grads["off"][n].flatten(), dim=0).item()
        for n in grads["off"]}
    worst = min(cos, key=cos.get)
    out = {"fused_gru": kern, "launches": launched[kern],
           "loss_kernels": losses[kern], "loss_off": losses["off"],
           "loss_rel_diff": abs(losses[kern] - losses["off"]) / abs(losses["off"]),
           "loss_tol": LOSS_TOL, "grad_cos_min": cos[worst],
           "grad_cos_min_tensor": worst,
           "grad_cos_median": sorted(cos.values())[len(cos) // 2],
           "cos_tol": COS_TOL, "tensors": len(cos)}
    if not (math.isfinite(losses[kern]) and out["loss_rel_diff"] <= LOSS_TOL
            and out["grad_cos_min"] >= COS_TOL):
        raise AssertionError(f"first step, kernels vs fused_gru='off': {out}")
    return batch, models, out


def time_training(cfg, models, batch, steps=2):
    """Training sequences/s of one window batch through make_train_step,
    kernels (the models' key other than 'off') and plain layers ('off'),
    in turns off, on, on, off after one warm-up step each."""
    import torch
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_train_step
    step_fns = {}
    for mode, model in models.items():
        c = dataclasses.replace(cfg, model=model.cfg)
        step_fns[mode] = make_train_step(c, model,
                                         make_optimizer(c, model.parameters()))
        step_fns[mode](batch)
    kern = next(m for m in models if m != "off")
    walls = []
    for mode in ("off", kern, kern, "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            aux = step_fns[mode](batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not math.isfinite(aux["loss"]):
            raise AssertionError(f"non-finite loss in timing ({mode}): {aux}")
    seqs = batch["image"].shape[0] * steps
    return {"train_seq_per_s": seqs / min(walls[1], walls[2]),
            "train_off_seq_per_s": seqs / min(walls[0], walls[3]),
            "train_wall_s_off_on_on_off": walls, "steps_per_run": steps}


def run_training(raw, tmp, counters):
    """The entry point in-process on the synthetic split, with every
    launch count in counters ({name: (wrapper, expected launches)}) set to
    0 just before; returns its log, the counts read just after and the
    peak memory."""
    import torch
    from rpg_ramnet_tpu_torch.train.__main__ import main as train_main
    cfg_path = os.path.join(tmp, "train_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    os.environ["PREPROCESSED_DATASETS_FOLDER"] = os.path.join(tmp, "data")
    for w, _ in counters.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_main(["-c", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: w.launches for k, (w, _) in counters.items()}
    want = {k: n for k, (_, n) in counters.items()}
    log = trainer.jsonl.entries[0]
    if got != want:
        raise AssertionError(f"launch counts {got}, expected {want}")
    losses = [log["train_loss"], log["val_loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses: {log}")
    ckpt = os.path.join(trainer.run_dir, "checkpoint-epoch0", "state.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    return {"launches": got, "launches_expected": want,
            "train_loss": log["train_loss"], "val_loss": log["val_loss"],
            "grad_norm": log["train_grad_norm"],
            "train_sec_per_epoch": log["train_sec_per_epoch"],
            "val_sec_per_epoch": log["val_sec_per_epoch"],
            "entry_point_wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def cell_bound(kind, shapes):
    """(least ms, 'operations' or 'bytes') of one cell per shape, summed:
    per shape the larger of its MACs at the bf16 dense peak and its bytes
    (each input read and each output written once, weights included) at
    the HBM rate; bound_by names the side that gives most of the sum."""
    macs, io, wts, *shared = CELL_WORK[kind]
    shared = shared[0] if shared else 0
    by = {"operations": 0.0, "bytes": 0.0}
    for B, H, W, C in shapes:
        t_ops = 2 * macs * C * C * B * H * W / PEAK_FLOPS
        t_bytes = ((io * B + shared) * C * H * W
                   + wts * C * C) / HBM_BYTES_PER_S
        by["operations" if t_ops >= t_bytes else "bytes"] += max(t_ops, t_bytes)
    return sum(by.values()) * 1e3, max(by, key=by.get)


def voxel_bound(n_events, windows=1):
    """(least ms, 'bytes') of the voxel grids of ``windows`` windows of
    n_events each: the events read once (16 bytes each) and each
    5x260x346 float32 grid written once; the few float32 operations per
    event are far below the bytes' time."""
    nb, h, w = VOX_GRID
    return (windows * (16 * n_events + 4 * nb * h * w)
            / HBM_BYTES_PER_S * 1e3, "bytes")


def make_full_cell_inputs(shape, dev, gen):
    """x ~ N(0, 1), h in (-1, 1) and a ConvGRU's whole-cell weights with
    biases in (-0.5, 0.5), bf16 (biases float32) on ``dev``."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import ConvGRU
    B, Hc, Wc, C = shape
    cell = ConvGRU(C, C)
    cell.reset_parameters_(gen)
    with torch.no_grad():
        for g in cell.gates():
            g.bias.uniform_(-0.5, 0.5, generator=gen)
        w = [t.to(dev) for t in cell.full_weights(torch.bfloat16)]
    x = torch.randn((B, Hc, Wc, C), generator=gen).to(dev, torch.bfloat16)
    h = (torch.rand((B, Hc, Wc, C), generator=gen) * 2 - 1).to(dev, torch.bfloat16)
    return cell, x, h, w


def make_events(n, n_valid, dev, seed):
    """[n, 4] float32 events on the 346x260 sensor, sorted timestamps over
    50 ms, rows past n_valid zero."""
    import numpy as np
    import torch
    nb, h, w = VOX_GRID
    rng = np.random.default_rng(seed)
    ev = np.stack([np.sort(rng.uniform(0.0, 0.05, n)), rng.integers(0, w, n),
                   rng.integers(0, h, n), rng.integers(0, 2, n)], 1)
    ev[n_valid:] = 0
    return torch.from_numpy(ev.astype(np.float32)).to(dev)


def voxel_case(name, dev, seed):
    """(events, n_valid) of a voxelizer check on VOX_GRID: 1M and `live`
    (one window each), batch800 (VOX_SIZES' windows with ragged counts,
    one window empty), a sparse padded window, VOX_SKEWED_EVENTS all in
    one band of rows (skewed) and 1M with all but the first and last
    shuffled."""
    import torch
    if name in ("1M", "live"):
        n = VOX_SIZES[name][1]
        return make_events(n, n, dev, seed), n
    if name == "batch800":
        B, n = VOX_SIZES[name]
        gen = torch.Generator().manual_seed(seed)
        counts = torch.randint(n // 2, n + 1, (B,), generator=gen)
        counts[1], counts[2], counts[3] = 0, 1, n
        return make_window_batch(counts, n, dev, seed)
    if name == "sparse_padded":
        return make_events(4096, 64, dev, seed), 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    if name == "skewed":
        ev = make_events(VOX_SKEWED_EVENTS, VOX_SKEWED_EVENTS, dev, seed)
        ev[:, 2] = torch.randint(16, 18, (VOX_SKEWED_EVENTS,), device=dev,
                                 generator=gen).float()
        return ev, VOX_SKEWED_EVENTS
    if name != "unsorted":
        raise KeyError(name)
    ev = make_events(VOX_EVENTS, VOX_EVENTS, dev, seed)
    ev[1:-1] = ev[1 + torch.randperm(VOX_EVENTS - 2, device=dev, generator=gen)]
    return ev, VOX_EVENTS


VOX_CHECKS = ("1M", "live", "batch800", "sparse_padded", "skewed", "unsorted")
# skewed: every event in rows 16-17, one band of the tiled path's plan.  The
# function's own bf16 rounding (K7 bf16 against the float32 grid) grows as
# the root of the contributions per cell: 0.076-0.091 with 2^20 events in
# two rows, 0.040-0.042 with 2^18 (the plain scatter on the CPU, seeds
# 0-2), so 2^17 keeps the function inside VOX_BF16_TOL
VOX_SKEWED_EVENTS = 1 << 17
VOX_MATMUL_WINDOWS = 8   # batch800's windows that K7 bf16's plain version takes


def stream_kernel_check(dev, gen, seed):
    """K5 against its plain version per shape (max abs error under every
    plan kind, and the IEEE-gate build's: ``k5_plan_errors``); per case of
    VOX_CHECKS and per path of the kernels (one-pass, tiled), K6 with and
    without stats and K7 with float32 factors against the plain scatter
    (max abs error, and relative to the grid's magnitude), K7 with bf16
    factors against its plain version (the bf16 one-hot product; at
    batch800 on its first VOX_MATMUL_WINDOWS windows) and against the
    float32 grid, and the stats per window against the plain grid's,
    relative."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    k5 = {"x".join(map(str, shape)): k5_plan_errors(shape, dev, gen)
          for shape in FLAGSHIP_CELLS + (RAGGED_CELL,) + K1_EDGE_CELLS}
    nb, hh, ww = VOX_GRID
    kw = dict(num_bins=nb, height=hh, width=ww)
    vox = {}
    for name in VOX_CHECKS:
        ev, n_valid = voxel_case(name, dev, seed)
        want = voxel.events_to_voxel_grid_scatter(ev, n_valid, **kw)
        sub = slice(None) if ev.dim() == 2 else slice(0, VOX_MATMUL_WINDOWS)
        want_b = voxel.events_to_voxel_grid_matmul(
            ev[sub], n_valid if ev.dim() == 2 else n_valid[sub],
            factor_dtype=torch.bfloat16, **kw)
        # each stat against its own magnitude (the sum against the sum of
        # |values|, as its cancellations are the atomics' rounding)
        want_stats = voxel.voxel_stats(want)
        scales = (want_stats[0], want.abs().sum((-3, -2, -1)), want_stats[2])
        scale = want.abs().max().item()
        tol = VOX_TOL * max(scale, 1.0)
        vox[name] = {"grid_max_abs": scale,
                     "windows": 1 if ev.dim() == 2 else ev.shape[0]}
        for path in voxel.PATHS:
            k6 = voxel.events_to_voxel_grid_sortseg(ev, n_valid, path=path, **kw)
            k6s, stats = voxel.events_to_voxel_grid_sortseg(
                ev, n_valid, with_stats=True, path=path, **kw)
            k7 = voxel.events_to_voxel_grid_pallas(ev, n_valid, path=path, **kw)
            k7b = voxel.events_to_voxel_grid_pallas(
                ev, n_valid, factor_dtype=torch.bfloat16, path=path, **kw)
            torch.cuda.synchronize()
            row = {f: (g - want).abs().max().item()
                   for f, g in (("k6", k6), ("k6_stats", k6s), ("k7_f32", k7),
                                ("k7_bf16", k7b))}
            row["k7_bf16_vs_plain"] = (k7b[sub] - want_b).abs().max().item()
            row["stats_rel_err"] = max(
                ((a - b).abs() / s.clamp(min=1.0)).max().item()
                for a, b, s in zip(stats, want_stats, scales))
            vox[name][path] = row
            if not (max(row["k6"], row["k6_stats"], row["k7_f32"],
                        row["k7_bf16_vs_plain"]) <= tol
                    and row["stats_rel_err"] <= VOX_TOL
                    and row["k7_bf16"] <= VOX_BF16_TOL):
                raise AssertionError(f"voxelizers vs plain ({name}, {path}): {row}")
            del k6, k6s, k7, k7b, stats
        del ev, want, want_b
    return k5, vox


def run_batch_entry(dev, seed):
    """The voxelizer entry point on batch800's windows (the raw pipeline's
    per-batch call), K6 ('auto') and K7 ('pallas'), with their counts set
    to 0 just before: per backend the counts by path read just after and
    the max abs error to the plain scatter over the grid's magnitude."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    nb, h, w = VOX_GRID
    kw = dict(num_bins=nb, height=h, width=w)
    ev, counts = voxel_case("batch800", dev, seed)
    want = voxel.events_to_voxel_grid_scatter(ev, counts, **kw)
    scale = max(want.abs().max().item(), 1.0)
    out = {}
    for backend, f in (("auto", voxel.events_to_voxel_grid_sortseg),
                       ("pallas", voxel.events_to_voxel_grid_pallas)):
        f.launches = 0
        f.path_launches = dict.fromkeys(voxel.PATHS, 0)
        got = voxel.events_to_voxel_grid(ev, counts, backend=backend, **kw)
        torch.cuda.synchronize()
        out[backend] = {"launches": f.launches, "by_path": dict(f.path_launches),
                        "shape": list(got.shape),
                        "finite": bool(got.isfinite().all()),
                        "max_rel_err": (got - want).abs().max().item() / scale}
        del got
    return out


def write_stream_data(root, K, seed):
    """The per-package split (two sequences of SEQ_LENGTHS packages at HxW)
    and the event log of STREAM_WINDOWS fixed-size windows on the 346x260
    sensor; returns the log's path."""
    import numpy as np
    from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
    for s, n in enumerate(SEQ_LENGTHS):
        generate_eventscape_sequence(os.path.join(root, "test", f"seq{s:02d}"),
                                     n_frames=K * n, height=H, width=W,
                                     seed=seed + s)
    _, h, w = VOX_GRID
    n = STREAM_WINDOWS * int(w * h * STREAM_EVENTS_PER_PIXEL)
    rng = np.random.default_rng(seed)
    rows = np.stack([np.sort(rng.uniform(0.0, STREAM_WINDOWS * 0.05, n)),
                     rng.integers(0, w, n), rng.integers(0, h, n),
                     rng.integers(0, 2, n)], 1)
    path = os.path.join(root, "events.txt")
    np.savetxt(path, rows, fmt=("%.9f", "%d", "%d", "%d"), header=f"{w} {h}",
               comments="")
    return path


def raw_config(overrides=None):
    """The flagship config file's dict with the model keys in overrides
    set (use_phased_arch also at the top level, where test.py reads it)."""
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = json.load(f)
    raw["model"].update(overrides or {})
    if "use_phased_arch" in raw["model"]:
        raw["use_phased_arch"] = raw["model"]["use_phased_arch"]
    return raw


def stream_files(tmp, model, fused_gru, overrides=None, name="stream"):
    """The flagship config (with overrides) with model.fused_gru set and a
    .pth.tar of the model's weights, in tmp; returns (config path,
    checkpoint path)."""
    from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar
    raw = raw_config({**(overrides or {}), "fused_gru": fused_gru})
    cfg_path = os.path.join(tmp, f"{name}_config_{fused_gru}.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    ckpt = os.path.join(tmp, f"{name}_model.pth.tar")
    export_pth_tar(ckpt, model, raw["arch"], raw)
    return cfg_path, ckpt


def run_eval_entry(cfg_path, ckpt, root, counters=None, crop=(H, W),
                   extra=()):
    """``python -m rpg_ramnet_tpu_torch.eval``'s main in-process on the
    split under root, with the launch counts of ``counters`` (default:
    K5's) set to 0 just before; returns the predictions, the list of
    counts read just after, the wall time and counts of non-finite and
    out-of-range values."""
    import numpy as np
    import torch
    from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
    from rpg_ramnet_tpu_torch.ops import gru_hside
    os.environ["PREPROCESSED_DATASETS_FOLDER"] = root
    preds, stats = {}, {"nonfinite": 0, "out_of_range": 0}

    def keep(idx, p):
        preds[idx] = p
        for v in p.values():
            stats["nonfinite"] += int((~np.isfinite(v)).sum())
            stats["out_of_range"] += int(((v < 0) | (v > 1)).sum())

    counters = counters or [gru_hside.conv_gru_full]
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    eval_main(["--path_to_model", ckpt, "--config", cfg_path, "--data_folder",
               "test", "--crop", f"{crop[0]},{crop[1]}", *extra],
              on_prediction=keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return preds, [c.launches for c in counters], wall, stats


def run_stream_entry(cfg_path, ckpt, log, backend):
    """``python -m rpg_ramnet_tpu_torch.stream``'s main in-process on the
    event log with the given voxel backend, the K6 and K7 counts set to 0
    just before; returns the depth maps, the counts (and by path) read
    just after and the wall seconds of the run."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    from rpg_ramnet_tpu_torch.stream import main as stream_main
    _, h, w = VOX_GRID
    depths = {}
    counters = (voxel.events_to_voxel_grid_sortseg, voxel.events_to_voxel_grid_pallas)
    for c in counters:
        c.launches = 0
        c.path_launches = dict.fromkeys(voxel.PATHS, 0)
    t0 = time.perf_counter()
    stream_main(["-i", log, "--path_to_model", ckpt, "--config", cfg_path,
                 "--height", str(h), "--width", str(w),
                 "--num_events_per_pixel", str(STREAM_EVENTS_PER_PIXEL),
                 "--voxel_backend", backend], on_window=depths.__setitem__)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return depths, {"k6": counters[0].launches, "k7": counters[1].launches,
                    "by_path": {k: dict(c.path_launches)
                                for k, c in zip(("k6", "k7"), counters)}}, wall


def window_grid_check(log, dev):
    """Every window of the log through K6 and its plain version: the
    largest max abs error over the windows, each relative to its grid's
    magnitude (at least 1), and the window count."""
    import numpy as np
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    from rpg_ramnet_tpu_torch.utils.event_readers import FixedSizeEventReader
    nb, h, w = VOX_GRID
    worst, n = 0.0, 0
    for events in FixedSizeEventReader(log, int(w * h * STREAM_EVENTS_PER_PIXEL)):
        ev = torch.from_numpy(events.astype(np.float32)).to(dev)
        kw = dict(num_bins=nb, height=h, width=w)
        got = voxel.events_to_voxel_grid_sortseg(ev, len(ev), **kw)
        want = voxel.events_to_voxel_grid_scatter(ev, len(ev), **kw)
        worst = max(worst, (got - want).abs().max().item()
                    / max(want.abs().max().item(), 1.0))
        n += 1
    return worst, n


def time_per_package(models, K, seed, steps=20, h=H, w=W, times=False,
                     turns=("off", "on", "on", "off")):
    """Per-package latency of StreamingInference.step (batched decode; host
    clock around each step, which ends in the predictions' copy to the
    host) with the kernels ('on') and the plain cells ('off'), in
    ``turns`` (off, on, on, off) after three warm-up packages each: median
    and p90 ms per package, and depth maps/s over each turn.  times: the
    packages carry timestamps (the phased regime)."""
    import numpy as np
    from rpg_ramnet_tpu_torch.eval import StreamingInference
    rng = np.random.default_rng(seed)
    pkgs = [{"events": rng.standard_normal((K, h, w, 5), dtype=np.float32),
             "image": rng.random((h, w, 1), dtype=np.float32)} for _ in range(4)]
    if times:
        for i, p in enumerate(pkgs):
            p["times_events"] = np.float32(0.05 * i + 0.01 * np.arange(K))
            p["times_image"] = p["times_events"][-1]
    runs = []
    for mode in turns:
        engine = StreamingInference(models[mode], batched_decode=True)
        for i in range(3):
            engine.step(pkgs[i % 4])
        lat = []
        t_run = time.perf_counter()
        for i in range(steps):
            t0 = time.perf_counter()
            engine.step(pkgs[i % 4])
            lat.append((time.perf_counter() - t0) * 1e3)
        wall = time.perf_counter() - t_run
        runs.append({"mode": mode, "median_ms": float(np.median(lat)),
                     "p90_ms": float(np.percentile(lat, 90)),
                     "maps_per_s": (K + 1) * steps / wall})
    out = {"runs": runs, "packages_per_run": steps}
    for mode in ("on", "off"):
        mine = [r for r in runs if r["mode"] == mode]
        best = min(mine, key=lambda r: r["median_ms"])
        out[f"per_package_latency_ms_{mode}"] = best["median_ms"]
        out[f"per_package_p90_ms_{mode}"] = best["p90_ms"]
        out[f"stream_maps_per_s_{mode}"] = max(r["maps_per_s"] for r in mine)
    return out


def full_cell_calls(cell, x, h, w, plan=None):
    """(K5, its plain version, the layer fused_gru='off' runs: the ConvGRU
    module on bf16 NCHW views, two library convolutions and the gates) on
    one cell's inputs; the kernel under ``plan`` where one is given."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw
    kw = {"_plan": plan} if plan is not None else {}
    return (lambda: gru_hside.conv_gru_full(x, h, *w, **kw),
            lambda: gru_hside.conv_gru_full_plain(x, h, *w),
            lambda: cell(to_nchw(x), to_nchw(h)))


def time_full_cells(dev, gen, iters=50):
    """Microseconds per cell of K5, its plain version and the 'off' layer
    (``full_cell_calls``) at the flagship per-package shapes, queued
    (device time), in mirrored turns plain, layer, kernel, kernel, layer,
    plain; K5 and the layer also unqueued (their wrappers' time); K5's
    plan, device us per launch (torch.profiler), the planner's weight MB
    per launch, registers and spills (``k5_report``)."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    rows = []
    for shape in FLAGSHIP_CELLS:
        cell, x, h, w = make_full_cell_inputs(shape, dev, gen)
        cell.to(dev)
        kern, plain, layer = full_cell_calls(cell, x, h, w)
        with torch.no_grad():
            p1, l1, k1, k2, l2, p2 = (cuda_time_us(f, iters, queued=True)
                                      for f in (plain, layer, kern, kern, layer, plain))
            row = {"shape": list(shape), "kernel_us": min(k1, k2),
                   "plain_us": min(p1, p2), "plain_layer_bf16_us": min(l1, l2),
                   "us_runs_p_l_k_k_l_p": [p1, l1, k1, k2, l2, p2],
                   "kernel_wrapper_us": min(cuda_time_us(kern, iters) for _ in range(2)),
                   "layer_wrapper_us": min(cuda_time_us(layer, iters) for _ in range(2))}
            row.update(k5_report(shape, gru_hside.plan_k5(*shape)))
            row["device_us"], row["device_records"] = launch_device_us(kern, 10)
        rows.append(row)
    return rows


def make_window_batch(counts, n, dev, seed):
    """[len(counts), n, 4] float32 events as make_events's, one window per
    count, made on the card: rows past each window's count zero."""
    import torch
    nb, h, w = VOX_GRID
    counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    B = counts.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    ev = torch.stack(
        [torch.rand(B, n, device=dev, generator=gen).sort(dim=1).values * 0.05,
         torch.randint(0, w, (B, n), device=dev, generator=gen).float(),
         torch.randint(0, h, (B, n), device=dev, generator=gen).float(),
         torch.randint(0, 2, (B, n), device=dev, generator=gen).float()], -1)
    ev[torch.arange(n, device=dev) >= counts[:, None]] = 0
    return ev, counts


def index_add_inputs(ev, n_valid, cells):
    """The flat indices (window offsets added) and values of every
    window's contributions, those outside the grid as (0, 0.0): what the
    one index_add_ call that computes the grids takes."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    nb, h, w = VOX_GRID
    idx, vals, ok = voxel._contributions(ev, n_valid, nb, h, w)
    if ev.dim() == 3:
        idx = idx + torch.arange(ev.shape[0], device=ev.device)[:, None] * cells
    return (torch.where(ok, idx, 0).reshape(-1),
            torch.where(ok, vals, 0.0).reshape(-1))


def spread(values):
    import numpy as np
    return {"min": min(values), "median": float(np.median(values)),
            "runs": values}


def time_voxelizers(dev, seed, sizes=tuple(VOX_SIZES)):
    """Per size of VOX_SIZES: device us per call (torch.profiler's
    durations, per kernel too) and wrapper us per call (CUDA events around
    back-to-back calls, host work included) of K6 (without and with
    stats), K7 (float32 and bf16 factors) on the path the size picks, K6
    on the other path, and the one index_add_ call that computes the grids
    from precomputed contributions (with the grid's zero_(), so the grid
    is written whole as the kernels write it), in mirrored turns; min,
    median and every run of each, Mev/s and the share of the bound at the
    least device time.  At 1M also the plain versions (the scatter in the
    turns, the one-hot product in two turns of one call); at batch800 the
    wrapper time of the single-window K6 calls over the same windows."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    nb, h, w = VOX_GRID
    kw = dict(num_bins=nb, height=h, width=w)
    out = {}
    for name in sizes:
        B, n = VOX_SIZES[name]
        if B == 1:
            ev, n_valid = make_events(n, n, dev, seed), n
        else:
            ev, n_valid = make_window_batch([n] * B, n, dev, seed)
        idx, vals = index_add_inputs(ev, n_valid, nb * h * w)
        grid = torch.empty(B * nb * h * w, device=dev)
        path = voxel._launch_plan(B, n, nb, h, w)[0]
        other = next(p for p in voxel.PATHS if p != path)
        calls = {
            "index_add": lambda: grid.zero_().index_add_(0, idx, vals),
            "k6": lambda: voxel.events_to_voxel_grid_sortseg(ev, n_valid, **kw),
            "k6_stats": lambda: voxel.events_to_voxel_grid_sortseg(
                ev, n_valid, with_stats=True, **kw),
            "k7_f32": lambda: voxel.events_to_voxel_grid_pallas(ev, n_valid, **kw),
            "k7_bf16": lambda: voxel.events_to_voxel_grid_pallas(
                ev, n_valid, factor_dtype=torch.bfloat16, **kw),
            f"k6_{other}": lambda: voxel.events_to_voxel_grid_sortseg(
                ev, n_valid, path=other, **kw),
        }
        if name == "1M":
            calls["plain_scatter"] = lambda: voxel.events_to_voxel_grid_scatter(
                ev, n_valid, **kw)
        reps = 20 if B == 1 else 3
        dev_us = {k: [] for k in calls}
        wrap_us = {k: [] for k in calls}
        per_kernel = {}
        for _ in range(VOX_TURNS):
            for k in list(calls) + list(reversed(calls)):
                t, per_kernel[k] = device_time_us(calls[k], reps)
                dev_us[k].append(t)
                wrap_us[k].append(cuda_time_us(calls[k], reps))
        bound_ms, _ = voxel_bound(n, B)
        row = {"windows": B, "events_per_window": n, "bound_us": bound_ms * 1e3,
               "path": path, "other_path": other,
               "device_us": {k: spread(v) for k, v in dev_us.items()},
               "wrapper_us": {k: spread(v) for k, v in wrap_us.items()},
               "device_us_per_kernel": per_kernel,
               "mev_per_s": {k: B * n / min(v) for k, v in dev_us.items()},
               "bound_share": {k: bound_ms * 1e3 / min(v)
                               for k, v in dev_us.items()}}
        if name == "1M":
            def matmul():
                return voxel.events_to_voxel_grid_matmul(ev, n_valid, **kw)
            turns = [(device_time_us(matmul, 1)[0], cuda_time_us(matmul, 1))
                     for _ in range(2)]
            row["device_us"]["plain_matmul"] = spread([t[0] for t in turns])
            row["wrapper_us"]["plain_matmul"] = spread([t[1] for t in turns])
        if B > 1:
            row["k6_single_window_calls_wrapper_us"] = cuda_time_us(
                lambda: [voxel.events_to_voxel_grid_sortseg(e, n, **kw)
                         for e in ev], 1)
        out[name] = row
        del ev, idx, vals, grid, calls
    return out


def make_lstm_inputs(shape, dev, gen, strided_gx=False, with_cell=False):
    """bf16 NHWC h in (-1, 1) and c in (-2, 2), gx ~ N(0, 1), a ConvLSTM's
    folded h-side weight (torch's conv init), a phased gate's [H, W, C]
    tau and phase (upstream init) and t in (0, 3) s per batch item;
    with_cell: also the ConvLSTM module on ``dev``, last."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import (ConvLSTM, PhasedLSTMGate,
                                                    init_conv_)
    B, Hc, Wc, C = shape
    cell = ConvLSTM(C, C)
    init_conv_(cell.Gates, gen)
    gate = PhasedLSTMGate(C * Hc * Wc)
    gate.reset_parameters_(gen)
    with torch.no_grad():
        w4 = cell.hside_weights(torch.bfloat16).to(dev)
        tau, phase = (v.to(dev) for v in gate.nhwc(C, Hc, Wc))
    h = (torch.rand(shape, generator=gen) * 2 - 1).to(dev, torch.bfloat16)
    c = (torch.rand(shape, generator=gen) * 4 - 2).to(dev, torch.bfloat16)
    if strided_gx:   # step 1 of a [B, 2, H, W, 4C] buffer
        gx = torch.randn((B, 2, Hc, Wc, 4 * C), generator=gen)
        gx = gx.to(dev, torch.bfloat16)[:, 1]
    else:
        gx = torch.randn((B, Hc, Wc, 4 * C), generator=gen).to(dev, torch.bfloat16)
    t = (torch.rand(B, generator=gen) * 3).to(dev)
    if with_cell:
        return h, c, gx, w4, tau, phase, t, cell.to(dev)
    return h, c, gx, w4, tau, phase, t


def lstm_kernel_check(dev, gen):
    """{shape: {plan: [max abs error, mean abs error]}} of K3 (h', c') and
    of K4 (h_t, h_new, c_new) against their plain versions at the phased,
    ragged (strided gx) and flagship shapes, under every plan kind their
    planner can pick there (``lstm_plan_errors``) and, as "exact_gates",
    the IEEE-gate build under the planner's plan; raises where one is over
    CELL_TOL."""
    k3, k4 = {}, {}
    for shape in PHASED_CELLS + (RAGGED_LSTM_CELL,) + FLAGSHIP_CELLS:
        inputs = make_lstm_inputs(shape, dev, gen,
                                  strided_gx=shape == RAGGED_LSTM_CELL)
        key = "x".join(map(str, shape))
        for kind, out in (("k3", k3), ("k4", k4)):
            out[key] = lstm_plan_errors(inputs, kind)
            with lstm_gates("exact"):
                out[key]["exact_gates"] = next(iter(
                    lstm_plan_errors(inputs, kind, kinds=False).values()))
        del inputs
    return k3, k4


def time_lstm_cells(dev, gen, iters=50):
    """Microseconds per cell of K3 and K4 and of their plain versions at
    the phased shapes, queued (device time) in turns plain, kernel,
    kernel, plain; the kernels also unqueued (their wrappers' time), each
    the least of two turns, with their plan, device us per launch, weight
    MB, registers and spills (``lstm_report``)."""
    import torch
    rows = []
    for shape in PHASED_CELLS:
        inputs = make_lstm_inputs(shape, dev, gen)
        row = {"shape": list(shape)}
        for name in ("k3", "k4"):
            kern, plain = lstm_calls(inputs, name)
            with torch.no_grad():
                p1, k1, k2, p2 = (cuda_time_us(f, iters, queued=True)
                                  for f in (plain, kern, kern, plain))
                row.update({f"{name}_kernel_us": min(k1, k2),
                            f"{name}_plain_us": min(p1, p2),
                            f"{name}_us_runs_p_k_k_p": [p1, k1, k2, p2],
                            f"{name}_wrapper_us": min(cuda_time_us(kern, iters)
                                                      for _ in range(2)),
                            name: lstm_report(name, shape, kern)})
        rows.append(row)
    return rows


def time_k3_flagship(dev, gen, iters=50):
    """Microseconds per cell of K3 at the flagship shapes, where the
    ConvLSTM state combination runs it on the chunked engine: queued
    (device time) and unqueued (its wrapper's time), each the least of two
    turns, beside the layer fused_gru='off' runs there (ConvLSTM.hside on
    bf16 NCHW views: one library convolution and the gates; queued, in
    turns layer, kernel, kernel, layer), with K3's plan, device us per
    launch, weight MB, registers and spills (``lstm_report``)."""
    import torch
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw
    rows = []
    for shape in FLAGSHIP_CELLS:
        h, c, gx, w4, tau, phase, t, cell = make_lstm_inputs(shape, dev, gen,
                                                             with_cell=True)
        kern = lstm_calls((h, c, gx, w4, tau, phase, t), "k3")[0]
        layer = lambda: cell.hside(to_nchw(gx), (to_nchw(h), to_nchw(c)))  # noqa: E731
        with torch.no_grad():
            l1, k1, k2, l2 = (cuda_time_us(f, iters, queued=True)
                              for f in (layer, kern, kern, layer))
            rows.append({"shape": list(shape), "k3_kernel_us": min(k1, k2),
                         "off_layer_us": min(l1, l2),
                         "us_runs_l_k_k_l": [l1, k1, k2, l2],
                         "k3_wrapper_us": min(cuda_time_us(kern, iters)
                                              for _ in range(2)),
                         "k3": lstm_report("k3", shape, kern)})
    return rows


def write_phased_data(root, K, seed):
    """The phased split: two sequences of PHASED_SEQ_LENGTHS packages at
    PHASED_H x PHASED_W, timestamps included."""
    from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
    for s, n in enumerate(PHASED_SEQ_LENGTHS):
        generate_eventscape_sequence(os.path.join(root, "test", f"seq{s:02d}"),
                                     n_frames=K * n, height=PHASED_H,
                                     width=PHASED_W, seed=seed + s)


def time_chunked(models, dataset, chunk, packages, K):
    """maps/s of run_chunked_streaming over the dataset with the kernels
    ('on') and the plain cells ('off'), in turns off, on, on, off."""
    import torch
    walls = []
    for mode in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_slice(models[mode], dataset, keep=set(), chunk=chunk)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    maps = packages * (K + 1)
    return {"maps": maps, "maps_per_s_on": maps / min(walls[1], walls[2]),
            "maps_per_s_off": maps / min(walls[0], walls[3]),
            "wall_s_off_on_on_off": walls}


def phased_phases(cfg, K, dev, gen, seed, dataset, packages, first_chunk,
                  smi):
    """Phases 11-13: K3 and K4 against their plain versions; the phased
    regime through the eval entry point, per package and chunked, and the
    flagship's ConvLSTM state combination on the chunked engine over the
    slice's dataset (packages: its padded package count; first_chunk: its
    first chunk's indices); their times.  Returns what the kernels line
    reads."""
    import torch
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell

    # 11. the ConvLSTM kernels against their plain versions on the card,
    #     under every plan kind
    k3_errs, k4_errs = lstm_kernel_check(dev, gen)
    emit({"phase": "kernel_phased", "cell_tol": CELL_TOL,
          "k3_abs_err": k3_errs, "k4_abs_err": k4_errs})

    # 12. the phased regime at 256x352 through the eval entry point, per
    #     package and chunked; the ConvLSTM state combination on the
    #     chunked engine at 256x512
    pcfg = dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in PHASED.items()})
    phased_model = ERGB2DepthRecurrent(
        pcfg, device=dev, generator=torch.Generator().manual_seed(seed + 2))
    lstm_counters = [gru_hside.conv_lstm_hside, phased_cell.conv_lstm_phased]
    n_ph = sum(PHASED_SEQ_LENGTHS)
    n_ph_padded = sum(-(-n // PHASED_CHUNK) * PHASED_CHUNK
                      for n in PHASED_SEQ_LENGTHS)
    crop = (PHASED_H, PHASED_W)
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_phased_") as tmp:
        t0 = time.perf_counter()
        write_phased_data(tmp, K, seed + 7)
        phased_data_s = time.perf_counter() - t0
        files = {m: stream_files(tmp, phased_model, m, PHASED, "phased")
                 for m in ("on", "off")}
        preds_ph, ph_counts, ph_wall, ph_stats = run_eval_entry(
            *files["on"], tmp, lstm_counters, crop)
        want_ph = [3 * (K + 1) * n_ph] * 2
        if ph_counts != want_ph:
            raise AssertionError(f"phased per package: K3, K4 launched "
                                 f"{ph_counts}, expected {want_ph}")
        if len(preds_ph) != n_ph or ph_stats["nonfinite"] \
                or ph_stats["out_of_range"]:
            raise AssertionError(f"phased predictions: {len(preds_ph)} items, "
                                 f"{ph_stats}")
        preds_ph_off, ph_off_counts, ph_off_wall, _ = run_eval_entry(
            *files["off"], tmp, lstm_counters, crop)
        if ph_off_counts != [0, 0]:
            raise AssertionError("fused_gru='off' launched K3/K4")
        ph_err = max_pred_diff(preds_ph, preds_ph_off)
        preds_chunk, chunk_counts, chunk_wall, chunk_stats = run_eval_entry(
            *files["on"], tmp, lstm_counters, crop,
            ("--scan_chunk", str(PHASED_CHUNK)))
        want_chunk = [3 * (K + 1) * n_ph_padded] * 2
        if chunk_counts != want_chunk or len(preds_chunk) != n_ph \
                or chunk_stats["nonfinite"] or chunk_stats["out_of_range"]:
            raise AssertionError(f"phased chunked: launches {chunk_counts}, "
                                 f"expected {want_chunk}; {len(preds_chunk)} "
                                 f"items, {chunk_stats}")
        chunk_err = max_pred_diff(preds_chunk, preds_ph_off)
    if not (ph_err <= SLICE_TOL and chunk_err <= SLICE_TOL):
        raise AssertionError(f"phased vs fused_gru='off': per package "
                             f"{ph_err}, chunked {chunk_err} > {SLICE_TOL}")
    lcfg = dataclasses.replace(cfg, state_combination="convlstm")
    lstm_model = ERGB2DepthRecurrent(
        lcfg, device=dev, generator=torch.Generator().manual_seed(seed + 3))
    gru_hside.conv_lstm_hside.launches = 0
    t0 = time.perf_counter()
    preds_lc, lc_stats = run_slice(lstm_model, dataset)
    lc_wall = time.perf_counter() - t0
    lc_launches = gru_hside.conv_lstm_hside.launches
    want_lc = 3 * (K + 1) * packages
    if lc_launches != want_lc or lc_stats["nonfinite"] \
            or lc_stats["out_of_range"] or lc_stats["items"] != sum(SEQ_LENGTHS):
        raise AssertionError(f"ConvLSTM state combination: K3 launched "
                             f"{lc_launches}, expected {want_lc}; {lc_stats}")
    lstm_off = ERGB2DepthRecurrent(dataclasses.replace(lcfg, fused_gru="off"),
                                   device=dev)
    lstm_off.load_state_dict(lstm_model.state_dict())
    preds_lc_off, _ = run_slice(lstm_off, dataset, keep=first_chunk)
    lc_err = max_pred_diff({g: preds_lc[g] for g in first_chunk}, preds_lc_off)
    if not (lc_err <= SLICE_TOL):
        raise AssertionError(f"ConvLSTM state combination, first chunk vs "
                             f"'off': {lc_err} > {SLICE_TOL}")
    check_no_jax()
    emit({"phase": "phased", "config": CONFIG, "overrides": PHASED,
          "H": PHASED_H, "W": PHASED_W, "K": K,
          "sequences": list(PHASED_SEQ_LENGTHS), "data_write_s": phased_data_s,
          "per_package": {"k3_k4_launches": ph_counts,
                          "expected": want_ph, "max_abs_err_vs_off": ph_err,
                          "wall_s_on": ph_wall, "wall_s_off": ph_off_wall},
          "chunked": {"chunk": PHASED_CHUNK, "k3_k4_launches": chunk_counts,
                      "expected": want_chunk,
                      "max_abs_err_vs_off_per_package": chunk_err,
                      "wall_s": chunk_wall},
          "tol": SLICE_TOL,
          "lstm_state_combination": {
              "H": H, "W": W, "chunk": CHUNK, "sequences": list(SEQ_LENGTHS),
              "k3_launches": lc_launches, "expected": want_lc,
              "first_chunk_max_abs_err_vs_off": lc_err, "wall_s": lc_wall}})

    # 13. phased latency and throughput, K3 and K4 per cell
    ph_models = {}
    for mode in ("on", "off"):
        ph_models[mode] = ERGB2DepthRecurrent(
            dataclasses.replace(pcfg, fused_gru=mode), device=dev)
        ph_models[mode].load_state_dict(phased_model.state_dict())
    ph_latency = time_per_package(ph_models, K, seed, h=PHASED_H,
                                  w=PHASED_W, times=True)
    ph_dataset = SyntheticDataset(PHASED_SEQ_LENGTHS, K, seed, h=PHASED_H,
                                  w=PHASED_W, times=True)
    ph_chunked = time_chunked(ph_models, ph_dataset, PHASED_CHUNK, n_ph_padded,
                              K)
    lstm_cells = time_lstm_cells(dev, gen)
    k3_flagship = time_k3_flagship(dev, gen)
    emit({"phase": "timing_phased", **ph_latency, "chunked": ph_chunked,
          "k3_flagship_cells": k3_flagship,
          "lstm_cells": lstm_cells, "nvidia_smi": smi})

    return {"k3_errs": k3_errs, "k4_errs": k4_errs, "counts": ph_counts,
            "cells": lstm_cells, "k3_flagship": k3_flagship}


def lstm_layer_grads(mod, x, c0, h0, gx, t, cots, kind, fused):
    """Gradients of sum(out * cot) through the ConvLSTMHside Function (kind
    'lstm_hside', on gx) or the phased layer (on x): fused, on bf16 inputs,
    the Functions (K3-res, K4-res, float32 master weights, the live tau
    and phase); plain, on float32 inputs, autograd through
    ConvLSTM.hside or PhasedConvLSTM.forward(fused=False).  Inputs NHWC;
    returns the inputs' gradients, then the parameters'."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc
    dt = torch.bfloat16 if fused else torch.float32
    mod.zero_grad()
    if kind == "lstm_hside":
        ins = [v.to(dt).requires_grad_() for v in (c0, h0, gx)]
        c0, h0, gx = ins
        if fused:
            outs = gru_hside.conv_lstm_hside(c0, h0, gx, mod.lstm.hside_weights())
        else:
            outs = [to_nhwc(v) for v in mod.lstm.hside(
                to_nchw(gx), (to_nchw(c0), to_nchw(h0)))]
        params = [mod.lstm.Gates.weight]
    else:
        ins = [v.to(dt).requires_grad_() for v in (x, c0, h0)]
        x, c0, h0 = ins
        y, (hn, cn) = mod(to_nchw(x), t, (to_nchw(c0), to_nchw(h0)),
                          fused=fused)
        outs = [to_nhwc(v) for v in (y, hn, cn)]
        params = list(mod.parameters())
    sum((o.float() * g).sum() for o, g in zip(outs, cots)).backward()
    return [v.grad for v in ins] + [p.grad.clone() for p in params]


def abs_errs(got, want):
    """[max abs error, mean abs error] of got against want."""
    d = (got.float() - want.float()).abs()
    return [d.max().item(), d.mean().item()]


def lstm_ptxas(ptxas, kind, mr):
    """The ptxas entry of K3, K4, K3-res or K4-res (``lstm_calls``' kind):
    of lstm_kernel<kPhased, kActs, MR> for a plan's MR."""
    phased, res = lstm_kind(kind)
    tag = f"11lstm_kernelILb{int(phased)}ELb{int(res)}ELi{mr}EE"
    return next((info for name, info in ptxas.items() if tag in name), None)


@contextlib.contextmanager
def lstm_gates(build):
    """Within: the ConvLSTM kernels launch from one build of
    csrc/lstm_hside.cu, 'fast' (the default: the gates on ex2/rcp) or
    'exact' (gru_hside.LSTM_EXACT_GATES: the IEEE gates)."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    built = gru_hside.library_lstm
    lib = built(gru_hside.LSTM_EXACT_GATES if build == "exact" else ())
    gru_hside.library_lstm = lambda defines=(): lib
    try:
        yield
    finally:
        gru_hside.library_lstm = built


@contextlib.contextmanager
def k5_gates(build):
    """Within: K5 launches from one build of csrc/gru_full.cu, 'fast' (the
    default: the gates on ex2/rcp) or 'exact' (gru_hside.K5_EXACT_GATES:
    the IEEE gates)."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    built = gru_hside.library_full
    lib = built(gru_hside.K5_EXACT_GATES if build == "exact" else ())
    gru_hside.library_full = lambda defines=(): lib
    try:
        yield
    finally:
        gru_hside.library_full = built


def k5_ptxas(ptxas, combo):
    """The ptxas entry of K5's k5_kernel<MR, NR, MC, NC> for a combo."""
    tag = "I" + "".join(f"Li{v}E" for v in combo) + "E"
    for name, info in ptxas.items():
        if "k5_kernel" in name and tag in name:
            return info
    return None


def k5_report(shape, plan):
    """K5's plan at shape, the weight MB one launch streams into shared
    memory as the planner counts them (``k5_weight_bytes``: an estimate,
    not a measurement), and the kernel's registers and spills (ptxas)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    ptxas = ptxas_by_kernel(kernels.build_log.get("gru_full", ""))
    return {"plan": plan._asdict(),
            "weight_mb": gru_hside.k5_weight_bytes(plan, *shape) / 1e6,
            "ptxas": k5_ptxas(ptxas, gru_hside.K5_COMBOS[plan.combo])}


def k5_plan_errors(shape, dev, gen):
    """{plan: max abs error} of K5 against its plain version at one shape
    under every plan kind its planner can pick there (its own pick through
    the wrapper's default path), and the IEEE-gate build's error under the
    planner's plan ("exact_gates"); raises where one is over CELL_TOL."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    _, x, h, w = make_full_cell_inputs(shape, dev, gen)
    errs = {}
    with torch.no_grad():
        want = gru_hside.conv_gru_full_plain(x, h, *w)
        runs = [(plan_name(p), {"_plan": p} if i else {})
                for i, p in enumerate(gru_hside.k5_plan_kinds(*shape))]
        for name, kw in runs + [("exact_gates", {})]:
            with k5_gates("exact" if name == "exact_gates" else "fast"):
                got = gru_hside.conv_gru_full(x, h, *w, **kw)
            torch.cuda.synchronize()
            errs[name] = err = (got.float() - want.float()).abs().max().item()
            if not (err <= CELL_TOL):
                raise AssertionError(f"K5 vs plain at {shape}, {name}: max abs "
                                     f"err {err} > {CELL_TOL}")
    return errs


def lstm_kind(kind):
    """(phased, residuals) of an LSTM kernel's kind: "k3", "k4", "k3_res"
    or "k4_res"."""
    return kind.startswith("k4"), kind.endswith("_res")


def lstm_calls(inputs, kind):
    """(kernel, plain) of K3, K4, K3-res or K4-res (kind "k3", "k4",
    "k3_res", "k4_res") on inputs (h, c, gx, w4, tau, phase, t); the
    kernel takes the wrapper's _plan."""
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
    h, c, gx, w4, tau, phase, t = inputs
    kern, plain = {"k3": (gru_hside.conv_lstm_hside, gru_hside.conv_lstm_hside_plain),
                   "k3_res": (gru_hside.conv_lstm_hside_res,
                              gru_hside.conv_lstm_hside_res_plain),
                   "k4": (phased_cell.conv_lstm_phased,
                          phased_cell.conv_lstm_phased_plain),
                   "k4_res": (phased_cell.conv_lstm_phased_res,
                              phased_cell.conv_lstm_phased_res_plain)}[kind]
    args = (h, c, gx, w4, tau, phase, t) if lstm_kind(kind)[0] else (h, c, gx, w4)
    return (lambda **kw: kern(*args, **kw)), (lambda: plain(*args))


def lstm_plan_errors(inputs, kind, kinds=True):
    """{plan: [max abs error, mean abs error]} of K3 (h', c'), K4 (h_t,
    h_new, c_new), K3-res or K4-res (and acts) (``lstm_calls``' kind)
    against its plain version on inputs, under every plan kind the planner
    can pick at their shape (kinds False: its own pick alone), its own pick
    through the wrapper's default path; raises where one is over
    CELL_TOL."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    shape = tuple(inputs[0].shape)
    kern, plain = lstm_calls(inputs, kind)
    phased, res = lstm_kind(kind)
    with torch.no_grad():
        want = plain()
        plans = gru_hside.lstm_plan_kinds(*shape, phased=phased, residuals=res)
        errs = {}
        for i, plan in enumerate(plans if kinds else plans[:1]):
            got = kern(**({"_plan": plan} if i else {}))
            torch.cuda.synchronize()
            e = [abs_errs(a, b) for a, b in zip(got, want)]
            errs[plan_name(plan)] = [max(v[0] for v in e), max(v[1] for v in e)]
            if not (errs[plan_name(plan)][0] <= CELL_TOL):
                raise AssertionError(f"{kind} vs plain at {shape}, plan {plan}: "
                                     f"{errs}")
    return errs


def train_lstm_kernel_check(dev, gen):
    """Per shape (the phased training shapes, B=8, and a ragged one with a
    strided gx): K3-res (h', c', acts) and K4-res (h_t, h_new, c_new,
    acts) against their plain versions under every plan kind (max and
    mean abs error), and the ConvLSTMHside and PhasedCell Functions'
    gradients against autograd through the plain layers in float32 on the
    same values (max abs error over the plain one's max magnitude, and the
    mean's: inputs, then weights, bias, tau, phase), each with the fast
    gates and again with the IEEE gates (the planner's plan)."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import PhasedConvLSTM, init_conv_
    rows = []
    for shape in PHASED_TRAIN_CELLS + (RAGGED_TRAIN_CELL,):
        inputs = make_lstm_inputs(shape, dev, gen,
                                  strided_gx=shape == RAGGED_TRAIN_CELL)
        h, c, gx, w4, tau, phase, t = inputs
        B, Hc, Wc, C = shape
        mod = PhasedConvLSTM(C, C, Hc, Wc)
        init_conv_(mod.lstm.Gates, gen)
        mod.phased_cell.reset_parameters_(gen)
        mod.to(dev)
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16).float()
        cots = [torch.randn(shape, generator=gen).to(dev) for _ in range(3)]
        row = {"shape": list(shape)}
        for build in ("fast", "exact"):
            with lstm_gates(build):
                cells = {k: lstm_plan_errors(inputs, k, build == "fast")
                         for k in ("k3_res", "k4_res")}
                fn_rel, fn_mean = {}, {}
                for kind in ("lstm_hside", "phased"):
                    # fresh leaves each time: the plain pass makes its
                    # float32 inputs require a gradient
                    args = (mod, x.detach(), h.float(), c.float(), gx.float(), t,
                            cots, kind)
                    pairs = list(zip(lstm_layer_grads(*args, True),
                                     lstm_layer_grads(*args, False)))
                    fn_rel[kind] = [rel_err(a, b) for a, b in pairs]
                    fn_mean[kind] = [abs_errs(a, b)[1] / b.float().abs().max().item()
                                     for a, b in pairs]
                torch.cuda.synchronize()
            row[build] = {"cells": cells, "fn_rel": fn_rel, "fn_mean_rel": fn_mean}
            if not max(max(v) for v in fn_rel.values()) <= GRAD_TOL:
                raise AssertionError(f"LSTM Functions ({build} gates) vs plain "
                                     f"layers at {shape}: {row}")
        row["k3_res_err"] = max(e[0] for e in row["fast"]["cells"]["k3_res"].values())
        row["k4_res_err"] = max(e[0] for e in row["fast"]["cells"]["k4_res"].values())
        rows.append(row)
        del mod, x, cots, inputs
    return rows


def lstm_report(kind, shape, fn):
    """The plan of K3, K4, K3-res or K4-res (``lstm_calls``' kind) at
    shape, its mean device us per launch of fn (torch.profiler), the
    weight MB one launch streams into shared memory as the planner counts
    them (``lstm_weight_bytes``), its shared memory, the blocks that fit on
    an SM and the kernel's registers and spills (ptxas)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    phased, res = lstm_kind(kind)
    plan = gru_hside.plan_lstm(*shape, phased=phased, residuals=res)
    dev_us, records = launch_device_us(fn, 10)
    return {"plan": plan._asdict(), "device_us": dev_us,
            "device_records": records,
            "weight_mb": gru_hside.lstm_weight_bytes(plan, *shape) / 1e6,
            "smem_bytes": gru_hside.lstm_smem_bytes(
                plan.tile_h, plan.tile_w, shape[-1], plan.split, plan.ks, phased, res),
            "blocks_per_sm": gru_hside.library_lstm().ramnet_lstm_blocks_per_sm(
                int(phased), int(res), shape[-1], *plan),
            "ptxas": lstm_ptxas(
                ptxas_by_kernel(kernels.build_log.get("lstm_hside", "")), kind,
                gru_hside.LSTM_COMBOS[plan.combo])}


def time_train_lstm_cells(dev, gen, iters=20):
    """Microseconds per cell of K3-res and K4-res and of their plain
    versions at the phased training shapes, queued (device time), in turns
    plain, kernel, kernel, plain; the kernels also unqueued (the wrapper's
    time), with their plan, device us per launch, weight MB, registers and
    spills."""
    import torch
    rows = []
    for shape in PHASED_TRAIN_CELLS:
        inputs = make_lstm_inputs(shape, dev, gen)
        row = {"shape": list(shape)}
        for name in ("k3_res", "k4_res"):
            kern, plain = lstm_calls(inputs, name)
            with torch.no_grad():
                p1, k1, k2, p2 = (cuda_time_us(f, iters, queued=True)
                                  for f in (plain, kern, kern, plain))
                row.update({f"{name}_kernel_us": min(k1, k2),
                            f"{name}_plain_us": min(p1, p2),
                            f"{name}_us_runs_p_k_k_p": [p1, k1, k2, p2],
                            f"{name}_wrapper_us": min(cuda_time_us(kern, iters)
                                                      for _ in range(2)),
                            name: lstm_report(name, shape, kern)})
        rows.append(row)
    return rows


def phased_train_config(tmp):
    """The flagship training config with the phased overrides (use_phased_arch
    at both levels, spatial_resolution = the crop), fused_gru 'on', no
    x precompute, batch PHASED_TRAIN_B."""
    raw = train_config(tmp)
    raw["name"] = "smoke_train_phased"
    raw["use_phased_arch"] = True
    raw["model"].update(PHASED, spatial_resolution=[TRAIN_CROP, TRAIN_CROP],
                        fused_gru="on")
    raw["trainer"]["precompute_x"] = False
    raw["data_loader"]["batch_size"] = PHASED_TRAIN_B
    return raw


def phased_train_phases(K, dev, gen, seed, smi):
    """Phases 17-19: K3-res and K4-res and their Functions against their
    plain versions; phased training through the entry point and the
    ConvLSTM state combination's first step; their times.  Returns what
    the kernels line reads."""
    import torch
    from rpg_ramnet_tpu_torch.core.config import Config
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell

    # 17. the training cells against their plain versions on the card
    rows = train_lstm_kernel_check(dev, gen)
    emit({"phase": "kernel_train_lstm", "cell_tol": CELL_TOL,
          "grad_tol": GRAD_TOL, "cells": rows})

    # 18. phased training at full width through the entry point, and the
    #     ConvLSTM state combination's first step with precompute_x
    cells = 3 * (K + 1) * TRAIN_L          # cells of one kind per window
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_phased_train_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_train_data(data, K, seed + 11, batch=PHASED_TRAIN_B)
        data_s = time.perf_counter() - t0
        raw = phased_train_config(tmp)
        pcfg = Config.from_dict(raw)
        # each checkpointed package runs its forward twice (the recompute)
        batch, pmodels, first = first_step_vs_off(
            pcfg, data, dev, seed,
            {"k4_res": (phased_cell.conv_lstm_phased_res, 2 * cells),
             "k3_res": (gru_hside.conv_lstm_hside_res, 2 * cells)})
        trained = run_training(raw, tmp, {
            "k4_res": (phased_cell.conv_lstm_phased_res, 2 * cells * TRAIN_STEPS),
            "k3_res": (gru_hside.conv_lstm_hside_res, 2 * cells * TRAIN_STEPS),
            "k4_validation": (phased_cell.conv_lstm_phased, cells),
            "k3_validation": (gru_hside.conv_lstm_hside, cells)})
        lraw = train_config(tmp)
        lraw["model"]["state_combination"] = "convlstm"
        lraw["data_loader"]["batch_size"] = PHASED_TRAIN_B
        _, _, lstm_first = first_step_vs_off(
            Config.from_dict(lraw), data, dev, seed + 1,
            {"k3_res": (gru_hside.conv_lstm_hside_res, 2 * cells)})
    check_no_jax()
    emit({"phase": "train_phased", "config": CONFIG,
          "model": raw["model"], "use_phased_arch": raw["use_phased_arch"],
          "B": PHASED_TRAIN_B, "L": TRAIN_L, "crop": TRAIN_CROP, "K": K,
          "steps": TRAIN_STEPS, "data_write_s": data_s,
          "first_step_vs_off": first, **trained,
          "lstm_state_combination_first_step_vs_off": lstm_first})

    # 19. phased training throughput, K3-res and K4-res per cell
    timing = time_training(pcfg, pmodels, batch)
    del pmodels, batch
    torch.cuda.empty_cache()
    lstm_cells = time_train_lstm_cells(dev, gen)
    emit({"phase": "timing_train_phased", **timing, "cells": lstm_cells,
          "nvidia_smi": smi})
    return {"rows": rows, "launches": trained["launches"],
            "cells": lstm_cells}


def chunk_cell_inputs(shape, dev, gen, seed, steps=None):
    """bf16 on ``dev``: NHWC h in (-1, 1), gx ~ N(0, 1) (a strided view of
    [B, 2, H, W, 3C] with steps None, else a [steps, H, W, 3C] buffer) and
    two ConvGRUs' folded h-side weights (events, image) from seed."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import ConvGRU
    B, Hc, Wc, C = shape
    ws = []
    for s in (seed, seed + 1):
        cell = ConvGRU(C, C)
        cell.reset_parameters_(torch.Generator().manual_seed(s))
        with torch.no_grad():
            ws.append(tuple(w.to(dev) for w in cell.hside_weights(torch.bfloat16)))
    h = (torch.rand((B, Hc, Wc, C), device=dev, generator=gen) * 2 - 1).bfloat16()
    if steps is None:
        gx = torch.randn((B, 2, Hc, Wc, 3 * C), device=dev, generator=gen)
        gx = gx.bfloat16()[:, 1]
    else:
        gx = torch.randn((steps, Hc, Wc, 3 * C), device=dev, generator=gen).bfloat16()
    return h, gx, ws[0], ws[1]


def chunk_teacher_forced(snaps, h0, gseq, w_ev, w_im, K):
    """Every K11 step against one plain cell on the kernel's previous
    snapshot (h0 before step 0): max abs error.  A stale or raced read of
    h at any step shows here, and bf16 roundings do not compound."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    prev = torch.cat([h0, snaps[:-1]])
    image = torch.arange(len(snaps), device=snaps.device) % (K + 1) == K
    want = torch.empty_like(snaps)
    want[~image] = gru_hside.conv_gru_hside_plain(prev[~image], gseq[~image], *w_ev)
    want[image] = gru_hside.conv_gru_hside_plain(prev[image], gseq[image], *w_im)
    return (snaps.float() - want.float()).abs().max().item()


def variant_ptxas(ptxas, kind, combo):
    """The ptxas entry of K10a's (kind 'k10a') or K11's ('k11') kernel
    instance for a warp-job combo, or with combo None of the first
    design's kernel (gru_cells_kernel<true>, gru_chunk_kernel) when
    gru_hside_timing.py --root times an older tree."""
    for name, info in ptxas.items():
        if combo is not None and f"{kind}_kernel" in name and \
                "I" + "".join(f"Li{v}E" for v in combo) + "E" in name:
            return info
        if combo is None and (("gru_cells_kernelILb1E" in name) if kind == "k10a"
                              else "gru_chunk_kernel" in name):
            return info
    return None


def variant_report(kind, shape, plan, steps=1):
    """K10a's or K11's plan at shape, the weight MB one launch streams into
    shared memory (``k1_weight_bytes`` per cell, times the steps), and the
    kernel instance's registers and spills (ptxas)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    lib = "gru_hside" if kind == "k10a" else "gru_chunk"
    return {"plan": plan_name(plan),
            "weight_mb": steps * gru_hside.k1_weight_bytes(plan, *shape) / 1e6,
            "ptxas": variant_ptxas(ptxas_by_kernel(kernels.build_log.get(lib, "")),
                                   kind, gru_hside.K1_COMBOS[plan.combo])}


def k10a_plan_errors(h, gseq, w, sel, shape):
    """{plan: max abs error} of K10a against its plain version under every
    plan kind K1's planner can pick at the shape (its own pick through the
    wrapper's default path); raises beyond K1_TOL."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside, gru_stream
    want = gru_stream.conv_gru_hside_stream_plain(h, gseq, sel, *w)
    errs = {}
    for i, plan in enumerate(gru_hside.k1_plan_kinds(*shape)):
        got = gru_stream.conv_gru_hside_stream(h, gseq, sel, *w,
                                               **({"_plan": plan} if i else {}))
        torch.cuda.synchronize()
        errs[plan_name(plan)] = (got.float() - want.float()).abs().max().item()
        if not (errs[plan_name(plan)] <= K1_TOL):
            raise AssertionError(f"K10a vs plain at {shape}, plan {plan}: {errs}")
    return errs


def pair_plan_errors(call, plain, shapes, what):
    """{plans/order: max abs error} of K9 or K10b (call(_plan=, _first=))
    against its plain version under every kind of ``gru_pair.k9_plan_kinds``
    (the planner's pair through the wrapper's default path); raises beyond
    K1_TOL, as K1's: the pair runs K1's tile under K1 plans."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_pair
    want = plain()
    errs = {}
    for i, (plans, first) in enumerate(gru_pair.k9_plan_kinds(*shapes)):
        got = call(**({"_plan": plans, "_first": first} if i else {}))
        torch.cuda.synchronize()
        key = "+".join(plan_name(p) for p in plans) + f"/first{first}"
        errs[key] = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, want))
        if not (errs[key] <= K1_TOL):
            raise AssertionError(f"{what} vs plain at {shapes}, {key}: {errs}")
    return errs


def pair_ptxas(ptxas):
    """{"k9|k10b c<combo>": registers and spills} of every k9_kernel
    instance (ptxas; K10b is the kSel instance), the combo by K1_COMBOS."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    out = {}
    for name, info in ptxas.items():
        m = re.search(r"k9_kernelILb(\d)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EE", name)
        if m:
            combo = gru_hside.K1_COMBOS.index(tuple(int(v) for v in m.groups()[1:]))
            out[f"{'k10b' if m.group(1) == '1' else 'k9'} c{combo}"] = info
    return out


def pair_report(shapes):
    """K9's/K10b's plans at a pair of shapes (the planner's), the block
    order and grid, the weight MB one launch streams into shared memory
    (``k1_weight_bytes`` of both scales) and the instances' registers and
    spills."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_pair
    plans = gru_pair.plan_k9(*shapes)
    grid = gru_pair.pair_grid(plans, shapes[0][0], shapes[0][1:3], shapes[1][1:3])
    ptx = pair_ptxas(ptxas_by_kernel(kernels.build_log.get("gru_cells", "")))
    return {"plans": [plan_name(p) for p in plans], "first": gru_pair.PAIR_FIRST,
            "grid": grid._asdict(),
            "weight_mb": gru_pair.pair_weight_bytes(plans, *shapes) / 1e6,
            "ptxas": {k: ptx.get(f"{k} c{plans[0].combo}") for k in ("k9", "k10b")}}


def k11_plan_errors(h0, gseq, w_ev, w_im, K, shape):
    """{plan: {per-step error, grid}} of K11 under every plan kind its
    planner can pick at the shape (its own pick through the wrapper's
    default path), each snapshot against one plain cell on the kernel's
    previous one; raises beyond CELL_TOL."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_chunk
    C = shape[-1]

    def resident(p):
        return gru_chunk.resident_clusters(h0.device.index, C, p)

    out = {}
    for i, plan in enumerate(gru_chunk.k11_plan_kinds(*shape[1:], resident)):
        snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gseq, h0, K,
                                               **({"_plan": plan} if i else {}))
        torch.cuda.synchronize()
        err = chunk_teacher_forced(snaps, h0, gseq, w_ev, w_im, K)
        out[plan_name(plan)] = {"per_step_err": err, "resident": resident(plan),
                                "grid": gru_chunk.conv_gru_hside_chunk.last_grid}
        if not (err <= CELL_TOL):
            raise AssertionError(f"K11 vs plain at {shape}, plan {plan}: {out}")
    return out


def chunked_kernel_check(dev, seed, K):
    """K9 (flagship scales 0+1 and the ragged pair), K10a (step STREAM_STEP
    of CHUNK*(K+1)-step buffers at the flagship shapes; step 7 of 12-step
    ones at VARIANT_EDGE_CELLS), K10b (the flagship shapes, also at steps
    past either end of the buffer against the plain version at the step
    the kernel clamps to), and K11 (S = CHUNK*(K+1) steps per flagship
    scale, EDGE_STEPS at the other shapes) against their plain versions:
    max abs errors; K9 and K10b under every kind of pair launch
    (``gru_pair.k9_plan_kinds``) and K10a under every plan kind K1's
    planner can pick (gated at K1_TOL), K11 under every plan kind its
    planner can pick (gated at CELL_TOL), K11
    per step on its own previous snapshot, also on a looping grid of
    LOOP_BLOCKS blocks at the flagship scales, and free-running against
    the plain loop under its own plan (reported).  Returns the errors and
    the flagship inputs for the timing."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_pair, gru_stream

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    gen = torch.Generator(device=dev).manual_seed(seed)
    S = CHUNK * (K + 1)
    out = {"k9": {}, "k10a": {}, "k10b": {}, "k11": {}}
    for pair in (FLAGSHIP_CELLS[:2], RAGGED_PAIR):
        args = []
        for shape in pair:
            h, gx, w, _ = chunk_cell_inputs(shape, dev, gen, seed + shape[-1])
            args += [h, gx, *w]
        with torch.no_grad():
            out["k9"]["+".join("x".join(map(str, sh)) for sh in pair)] = pair_plan_errors(
                lambda **kw: gru_pair.conv_gru_hside_pair(*args, **kw),
                lambda: gru_pair.conv_gru_hside_pair_plain(*args), pair, "K9")
    inputs = {shape: chunk_cell_inputs(shape, dev, gen, seed + shape[-1], S)
              for shape in FLAGSHIP_CELLS}
    sel = torch.tensor([STREAM_STEP], dtype=torch.int32, device=dev)
    with torch.no_grad():
        for shape, (h, gseq, w, _) in inputs.items():
            out["k10a"]["x".join(map(str, shape))] = k10a_plan_errors(
                h, gseq, w, sel, shape)
        (h0, g0, w0, _), (h1, g1, w1, _) = (inputs[c] for c in FLAGSHIP_CELLS[:2])
        out["k10b"]["plans"] = pair_plan_errors(
            lambda **kw: gru_stream.conv_gru_hside_stream_pair(h0, g0, *w0, h1, g1, *w1,
                                                               sel, **kw),
            lambda: gru_stream.conv_gru_hside_stream_pair_plain(h0, g0, *w0, h1, g1, *w1,
                                                                sel),
            FLAGSHIP_CELLS[:2], "K10b")
        for step in (S + 5, -1):   # the kernel clamps sel to the buffer
            at = torch.tensor([min(max(step, 0), S - 1)], dtype=torch.int32, device=dev)
            out["k10b"][f"sel_{step}"] = max(err(a, b) for a, b in zip(
                gru_stream.conv_gru_hside_stream_pair(
                    h0, g0, *w0, h1, g1, *w1, torch.full_like(sel, step)),
                gru_stream.conv_gru_hside_stream_pair_plain(h0, g0, *w0, h1, g1, *w1,
                                                            at)))
        for shape, (h, gseq, w_ev, w_im) in inputs.items():
            key = "x".join(map(str, shape))
            row = {"steps": S, "plans": k11_plan_errors(h, gseq, w_ev, w_im, K, shape)}
            snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gseq, h, K)
            row["free_running_err"] = err(snaps, gru_chunk.conv_gru_hside_chunk_plain(
                w_ev, w_im, gseq, h, K))
            snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gseq, h, K,
                                                   blocks=LOOP_BLOCKS)
            row["looping_grid"] = {
                "grid": gru_chunk.conv_gru_hside_chunk.last_grid,
                "per_step_err": chunk_teacher_forced(snaps, h, gseq, w_ev, w_im, K)}
            out["k11"][key] = row
        edge_sel = torch.tensor([7], dtype=torch.int32, device=dev)
        for shape in VARIANT_EDGE_CELLS:
            key = "x".join(map(str, shape))
            h, gseq, w_ev, w_im = chunk_cell_inputs(shape, dev, gen, seed + 7,
                                                    EDGE_STEPS)
            out["k10a"][key] = k10a_plan_errors(h, gseq, w_ev, edge_sel, shape)
            out["k11"][key] = {"steps": EDGE_STEPS, "plans": k11_plan_errors(
                h, gseq, w_ev, w_im, K, shape)}
    torch.cuda.synchronize()
    k11_errs = [r["per_step_err"] for row in out["k11"].values()
                for r in list(row["plans"].values()) + [row.get("looping_grid",
                                                                 {"per_step_err": 0.0})]]
    worst = max(k11_errs)
    pair_worst = max([e for row in out["k9"].values() for e in row.values()]
                     + list(out["k10b"]["plans"].values())
                     + [v for k, v in out["k10b"].items() if k != "plans"])
    if not (worst <= CELL_TOL and pair_worst <= K1_TOL):
        raise AssertionError(f"chunked-path kernels vs plain: {out}")
    return out, inputs


def time_chunked_kernels(dev, inputs, K, iters=50):
    """Microseconds per launch of K9 and K10b (flagship scales 0+1), K10a
    (each flagship shape) and K11 (each flagship scale, S steps) and of
    their plain versions, in turns plain, kernel, kernel, plain, queued
    (device time, as phase 4), and of the two K1 launches K9 replaces
    (``k1_pair``); K9's, K10b's, K10a's and K11's also unqueued (the
    wrapper's time), with their plans, weight MB per launch, registers and
    spills (``pair_report``, ``variant_report``), K9's grid and K11's grid
    and clusters that fit at once."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_hside, gru_pair, gru_stream
    sel = torch.tensor([STREAM_STEP], dtype=torch.int32, device=dev)
    (h0, g0, w0, _), (h1, g1, w1, _) = (inputs[c] for c in FLAGSHIP_CELLS[:2])
    # K9 reads step STREAM_STEP of the buffers as a [1, H, W, 3C] view
    v0, v1 = g0[STREAM_STEP:STREAM_STEP + 1], g1[STREAM_STEP:STREAM_STEP + 1]
    calls = {
        "k9": (lambda: gru_pair.conv_gru_hside_pair(h0, v0, *w0, h1, v1, *w1),
               lambda: gru_pair.conv_gru_hside_pair_plain(h0, v0, *w0, h1, v1, *w1),
               iters),
        "k10b": (lambda: gru_stream.conv_gru_hside_stream_pair(
                     h0, g0, *w0, h1, g1, *w1, sel),
                 lambda: gru_stream.conv_gru_hside_stream_pair_plain(
                     h0, g0, *w0, h1, g1, *w1, sel), iters),
        # the two K1 launches the pair replaces, at the same inputs
        "k1_pair": (lambda: (gru_hside.conv_gru_hside(h0, v0, *w0),
                             gru_hside.conv_gru_hside(h1, v1, *w1)),
                    lambda: gru_pair.conv_gru_hside_pair_plain(h0, v0, *w0, h1, v1, *w1),
                    iters)}
    report = pair_report(FLAGSHIP_CELLS[:2])
    reports = {"k9": report, "k10b": report}
    for shape, (h, gseq, w, w_im) in inputs.items():
        key = "x".join(map(str, shape))
        calls[f"k10a_{key}"] = (
            lambda h=h, gseq=gseq, w=w: gru_stream.conv_gru_hside_stream(
                h, gseq, sel, *w),
            lambda h=h, gseq=gseq, w=w: gru_stream.conv_gru_hside_stream_plain(
                h, gseq, sel, *w), iters)
        calls[f"k11_{key}"] = (
            lambda h=h, gseq=gseq, w=w, w_im=w_im: gru_chunk.conv_gru_hside_chunk(
                w, w_im, gseq, h, K),
            lambda h=h, gseq=gseq, w=w, w_im=w_im: gru_chunk.conv_gru_hside_chunk_plain(
                w, w_im, gseq, h, K), 3)
        plan = gru_chunk.device_plan(dev.index or 0, *shape[1:])
        reports[f"k10a_{key}"] = variant_report("k10a", shape,
                                                gru_hside.plan_k1(*shape))
        reports[f"k11_{key}"] = dict(
            variant_report("k11", shape, plan, len(gseq)),
            resident=gru_chunk.resident_clusters(dev.index or 0, shape[-1], plan),
            grid=gru_chunk.k11_grid(plan, *shape[1:3], 0, gru_chunk.resident_clusters(
                dev.index or 0, shape[-1], plan)))
    rows = {}
    with torch.no_grad():
        for name, (kern, plain, n) in calls.items():
            p1, k1, k2, p2 = (cuda_time_us(f, n, queued=True)
                              for f in (plain, kern, kern, plain))
            rows[name] = {"kernel_us": min(k1, k2), "plain_us": min(p1, p2),
                          "us_runs_p_k_k_p": [p1, k1, k2, p2], **reports.get(name, {})}
            if name in reports:   # also unqueued, the wrapper's time
                rows[name]["wrapper_us"] = min(cuda_time_us(kern, n) for _ in range(2))
    return rows


def chunk_cells_model(model):
    """A model of the same config and weights whose
    forward_sequence_precomputed runs the chunk_cells branch, so that
    run_chunked_streaming (its prefetch, padding and per-sequence state)
    drives K11 over the same chunks as the other variants; the port has
    no engine flag for it, as the JAX package has none."""
    import functools
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    twin = ERGB2DepthRecurrent(model.cfg, device=model.device)
    twin.load_state_dict(model.state_dict())
    twin.forward_sequence_precomputed = functools.partial(
        ERGB2DepthRecurrent.forward_sequence_precomputed, twin,
        chunk_cells=True)
    return twin


def chunked_variants(cfg, model, dataset, packages, first_chunk, preds_off,
                     off_model, K):
    """Phase 15: the slice's dataset through run_chunked_streaming under each
    of VARIANTS and with forward_sequence_precomputed(chunk_cells=True),
    each with every launch count set to 0 just before and read just after:
    the counts against the derived ones, finite predictions in [0, 1], the
    first chunk against fused_gru='off' (preds_off); then maps/s of every
    variant, the default path and 'off' in mirrored turns."""
    import torch
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_hside, gru_pair, gru_stream
    counters = {"k1": gru_hside.conv_gru_hside, "k9": gru_pair.conv_gru_hside_pair,
                "k10a": gru_stream.conv_gru_hside_stream,
                "k10b": gru_stream.conv_gru_hside_stream_pair,
                "k11": gru_chunk.conv_gru_hside_chunk}
    n = cfg.num_encoders
    steps = (K + 1) * packages           # modality steps of the run
    expected = {"pair": {"k9": steps, "k1": (n - 2) * steps},
                "stream": {"k10a": n * steps},
                "stream_pair": {"k10b": steps, "k10a": (n - 2) * steps},
                "chunk_cells": {"k11": n * packages // CHUNK}}
    models = {"off": off_model, "default": model}
    for name, over in VARIANTS:
        models[name] = ERGB2DepthRecurrent(dataclasses.replace(cfg, **over),
                                           device=model.device)
        models[name].load_state_dict(model.state_dict())
    models["chunk_cells"] = chunk_cells_model(model)

    def run(name, keep=None):
        return run_slice(models[name], dataset, keep)

    out = {}
    for name in list(expected):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        preds, stats = run(name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        want = {k: expected[name].get(k, 0) for k in counters}
        err = max_pred_diff({g: preds[g] for g in first_chunk},
                            {g: preds_off[g] for g in first_chunk})
        out[name] = {"launches": got, "expected": want,
                     "first_chunk_max_abs_err_vs_off": err,
                     "first_run_s": wall, **stats}
        if got != want or stats["items"] != sum(SEQ_LENGTHS) \
                or stats["nonfinite"] or stats["out_of_range"] \
                or not (err <= SLICE_TOL):
            raise AssertionError(f"chunked variant {name}: {out[name]}")
    # one untimed run of each first: without it every variant ran slower
    # in the first half of the turns than in the second
    order = ["off", "default", "pair", "stream", "stream_pair", "chunk_cells"]
    for name in order:
        run(name, keep=set())
    walls = {k: [] for k in order}
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, keep=set())
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    maps = packages * (K + 1)
    timing = {"maps": maps, "turns": order + order[::-1],
              "maps_per_s": {k: maps / min(v) for k, v in walls.items()},
              "wall_s": walls}
    return out, timing


def decoder_inputs(shape, dev, seed):
    """A bf16 UpsampleConvLayer (torch's conv init) on ``dev`` and NHWC x,
    skip ~ N(0, 1) of shape (B, C, Cout, H, W)."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import UpsampleConvLayer, init_conv_
    B, C, Cout, h, w = shape
    layer = UpsampleConvLayer(C, Cout, 5, padding=2)
    init_conv_(layer.conv2d, torch.Generator().manual_seed(seed))
    layer.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, skip = (torch.randn((B, h, w, C), device=dev, generator=gen).bfloat16()
               for _ in range(2))
    return layer, x, skip


def decoder_kernel_check(dev, seed):
    """K8 against its plain version (the two-stage layer) in bf16 and in
    float32, and the composed layer against the two-stage layer, all
    gated, at the flagship layers at both decode batches with and without
    the skip, and the ragged layer; K8 alone at its border shapes: max
    abs error over the plain version's max magnitude."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import upsample_conv_layer_composed
    from rpg_ramnet_tpu_torch.ops import upsample_conv
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw
    shapes = [(B,) + layer for B in DECODER_BATCHES for layer in DECODER_LAYERS]
    rows = {}
    for shape in shapes + [RAGGED_DECODER] + list(BORDER_DECODER):
        layer, x, skip = decoder_inputs(shape, dev, seed + shape[1])
        w, b = layer.conv2d.weight, layer.conv2d.bias
        for sk in (None, skip):
            with torch.no_grad():
                got = upsample_conv.upsample_conv_fused(layer, x, sk)
                want = upsample_conv.upsample_conv_fused_plain(w, b, x, sk)
                want32 = upsample_conv.upsample_conv_fused_plain(
                    w, b, x.float(), None if sk is None else sk.float())
                s = to_nchw(x if sk is None else x + sk)
                comp = (None if shape in BORDER_DECODER else
                        rel_err(upsample_conv_layer_composed(layer, s), layer(s)))
            torch.cuda.synchronize()
            key = "x".join(map(str, shape)) + ("_skip" if sk is not None else "")
            rows[key] = {"k8_rel_err": rel_err(got, want),
                         "k8_rel_err_vs_f32": rel_err(got, want32),
                         "composed_rel_err": comp}
            del got, want, want32, s
    worst = max(max(r["k8_rel_err"], r["k8_rel_err_vs_f32"],
                    r["composed_rel_err"] or 0.0) for r in rows.values())
    if not (worst <= DECODER_TOL):
        raise AssertionError(f"K8 / composed vs the two-stage layer: {rows}")
    return rows


def time_decoder_layers(dev, seed):
    """Microseconds per flagship decoder layer at both decode batches, the
    skip sum included where the decoder sums one: K8, K8 without its
    border terms (the border's share), the two-stage layer (K8's plain
    version) and the composed layer, by CUDA events in turns two-stage,
    K8, composed, K8 without borders, and back; K8's device time per
    launch with and without its border terms by torch.profiler; and
    whether the composed layers beat the two-stage ones summed over the
    three layers at batch 96 (the rule behind statenet.composed_auto)."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import upsample_conv_layer_composed
    from rpg_ramnet_tpu_torch.ops import upsample_conv
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw
    rows = []
    for B in DECODER_BATCHES:
        for i, (C, Cout, h, w) in enumerate(DECODER_LAYERS):
            layer, x, skip = decoder_inputs((B, C, Cout, h, w), dev, seed + i)
            sk = skip if i else None
            wt, bias = layer.conv2d.weight, layer.conv2d.bias
            calls = {
                "k8": lambda: upsample_conv.upsample_conv_fused(layer, x, sk),
                "k8_no_border": lambda: upsample_conv.upsample_conv_fused(
                    layer, x, sk, border_terms=False),
                "two_stage": lambda: upsample_conv.upsample_conv_fused_plain(
                    wt, bias, x, sk),
                "composed": lambda: upsample_conv_layer_composed(
                    layer, to_nchw(x if sk is None else x + sk))}
            iters = 10 if B > 16 else 50
            us = {k: [] for k in calls}
            with torch.no_grad():
                order = ("two_stage", "k8", "composed", "k8_no_border")
                for name in order + order[::-1]:
                    us[name].append(cuda_time_us(calls[name], iters))
                dev_us = {k: launch_device_us(calls[k], iters)
                          for k in ("k8", "k8_no_border")}
            rows.append({"batch": B, "layer": i, "C": C, "Cout": Cout,
                         "H": h, "W": w, "skip": bool(i),
                         **{f"{k}_us": min(v) for k, v in us.items()},
                         **{f"{k}_device_us": v[0] for k, v in dev_us.items()},
                         "device_launches_recorded": {
                             k: v[1] for k, v in dev_us.items()},
                         "border_share_device":
                             1 - dev_us["k8_no_border"][0] / dev_us["k8"][0],
                         "us_runs": us})
    at = {B: [r for r in rows if r["batch"] == B] for B in DECODER_BATCHES}
    summed = {k: sum(r[f"{k}_us"] for r in at[96])
              for k in ("k8", "two_stage", "composed")}
    return rows, {"sum_us_batch96": summed,
                  "sum_us_batch6": {k: sum(r[f"{k}_us"] for r in at[6])
                                    for k in ("k8", "two_stage", "composed")},
                  "composed_beats_two_stage_at_96":
                      summed["composed"] < summed["two_stage"]}


def time_chunk_forward(models, order, K, seed, chunks=3):
    """ms per 16-package chunk of forward_sequence_precomputed alone
    (inputs on the card, the 96 maps copied to the host), without the
    engine's host work, per model in mirrored turns of ``chunks`` chunks
    after a warm-up chunk each."""
    import torch
    dev = models[order[0]].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    seq = {"events": torch.randn((1, CHUNK, K, H, W, 5), device=dev,
                                 generator=gen),
           "image": torch.rand((1, CHUNK, H, W, 1), device=dev,
                               generator=gen)}

    def run(m):
        _, preds = m.forward_sequence_precomputed(m.init_state(1, H, W), seq)
        return [v.cpu() for v in preds.values()]

    for name in order:
        run(models[name])
    ms = {k: [] for k in order}
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            run(models[name])
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / chunks)
    return ms


def write_decoder_data(root, K, seed):
    """The eval entry point's split for phase 16: DECODER_SEQ_LENGTHS
    packages at HxW."""
    from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
    for s, n in enumerate(DECODER_SEQ_LENGTHS):
        generate_eventscape_sequence(os.path.join(root, "test", f"seq{s:02d}"),
                                     n_frames=K * n, height=H, width=W,
                                     seed=seed + s)


def decoder_engines(cfg, model, dataset, packages, first_chunk, preds_off,
                    K, seed):
    """Phase 16's engines: the slice's dataset through run_chunked_streaming
    under each of DECODER_VARIANTS, each with every launch count set to 0
    just before and read just after (K8 three per chunk with
    fused_decoder='on', none with the composed layers; K1 as the default
    path), finite predictions in [0, 1], the first chunk against
    fused_gru='off' (preds_off); maps/s of both and of the two-stage
    layers (TWO_STAGE) in mirrored turns after a warm-up run each; then
    the eval entry point's per-package engine with fused_decoder='on' (K8
    three per package) against the two-stage layers, and its latency."""
    import torch
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside, upsample_conv
    counters = {"k8": upsample_conv.upsample_conv_fused,
                "k1": gru_hside.conv_gru_hside}
    models = {}
    for name, over in DECODER_VARIANTS + (("two_stage", TWO_STAGE),):
        models[name] = ERGB2DepthRecurrent(dataclasses.replace(cfg, **over),
                                           device=model.device)
        models[name].load_state_dict(model.state_dict())
    n = cfg.num_encoders
    out = {}
    for name, _ in DECODER_VARIANTS:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        preds, stats = run_slice(models[name], dataset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        want = {"k8": n * packages // CHUNK if name == "k8" else 0,
                "k1": 3 * (K + 1) * packages}
        err = max_pred_diff({g: preds[g] for g in first_chunk},
                            {g: preds_off[g] for g in first_chunk})
        out[name] = {"launches": got, "expected": want,
                     "first_chunk_max_abs_err_vs_off": err,
                     "first_run_s": wall, **stats}
        if got != want or stats["items"] != sum(SEQ_LENGTHS) \
                or stats["nonfinite"] or stats["out_of_range"] \
                or not (err <= SLICE_TOL):
            raise AssertionError(f"decoder variant {name}: {out[name]}")
    order = ["two_stage", "k8", "composed"]
    for name in order:
        run_slice(models[name], dataset, keep=set())
    walls = {k: [] for k in order}
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_slice(models[name], dataset, keep=set())
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    maps = packages * (K + 1)
    timing = {"maps": maps, "turns": order + order[::-1],
              "maps_per_s": {k: maps / min(v) for k, v in walls.items()},
              "wall_s": walls,
              "chunk_forward_ms": time_chunk_forward(models, order, K, seed)}

    n_pkg = sum(DECODER_SEQ_LENGTHS)
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_decoder_") as tmp:
        write_decoder_data(tmp, K, seed + 11)
        files = {m: stream_files(tmp, model, "auto", over, f"decoder_{m}")
                 for m, over in (("k8", {"fused_decoder": "on"}),
                                 ("two_stage", TWO_STAGE))}
        preds_k8, [k8_launches], k8_wall, k8_stats = run_eval_entry(
            *files["k8"], tmp, [upsample_conv.upsample_conv_fused])
        preds_two, [two_launches], two_wall, _ = run_eval_entry(
            *files["two_stage"], tmp, [upsample_conv.upsample_conv_fused])
    per_package = {"packages": n_pkg, "items": len(preds_k8),
                   "k8_launches": k8_launches,
                   "expected": n * n_pkg, "two_stage_launches": two_launches,
                   "max_abs_err_vs_two_stage": max_pred_diff(preds_k8, preds_two),
                   "wall_s_k8": k8_wall, "wall_s_two_stage": two_wall,
                   **k8_stats}
    if (k8_launches != n * n_pkg or two_launches or len(preds_k8) != n_pkg
            or k8_stats["nonfinite"] or k8_stats["out_of_range"]
            or not per_package["max_abs_err_vs_two_stage"] <= SLICE_TOL):
        raise AssertionError(f"per-package engine with K8: {per_package}")
    latency = time_per_package({"on": models["k8"], "off": models["two_stage"]},
                               K, seed)
    return out, timing, per_package, latency


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, event_loop_range
    from rpg_ramnet_tpu_torch.ops import (gru_chunk, gru_hside, gru_pair,
                                          upsample_conv, voxel)
    from rpg_ramnet_tpu_torch.utils import require_cuda

    # 1. device and build (one nvcc per source, all at once)
    dev = require_cuda()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    kernels.build(gru_hside.SOURCES + voxel.SOURCES + upsample_conv.SOURCES
                  + (("lstm_hside", gru_hside.LSTM_EXACT_GATES),
                     ("gru_full", gru_hside.K5_EXACT_GATES)))
    gru_hside.library()
    gru_hside.library_bwd()
    gru_hside.library_full()
    gru_hside.library_full(gru_hside.K5_EXACT_GATES)
    gru_hside.library_lstm()
    gru_hside.library_lstm(gru_hside.LSTM_EXACT_GATES)
    gru_pair.library()
    gru_chunk.library()
    voxel.library()
    upsample_conv.library()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in kernels.build_log.items()}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    # 2. the kernel against its plain version on the card
    gen = torch.Generator().manual_seed(args.seed)
    errs = kernel_check(dev, gen)
    emit({"phase": "kernel", "name": "gru_hside", "tol": K1_TOL,
          "max_abs_err": errs})

    # 3. the slice at full width through the main path
    cfg = ModelConfig.load(os.path.join(ROOT, CONFIG))
    K = event_loop_range(cfg)
    model = ERGB2DepthRecurrent(cfg, device=dev,
                                generator=torch.Generator().manual_seed(args.seed))
    dataset = SyntheticDataset(SEQ_LENGTHS, K, args.seed)
    packages = sum(-(-n // CHUNK) * CHUNK for n in SEQ_LENGTHS)
    first_chunk = set(range(CHUNK))

    gru_hside.conv_gru_hside.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds_on, stats = run_slice(model, dataset)
    first_run_s = time.perf_counter() - t0
    launches = gru_hside.conv_gru_hside.launches
    want = 3 * (K + 1) * packages
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"3*(K+1)*packages = {want}")
    if stats["items"] != sum(SEQ_LENGTHS):
        raise AssertionError(f"{stats['items']} predictions for "
                             f"{sum(SEQ_LENGTHS)} items")
    if stats["nonfinite"] or stats["out_of_range"]:
        raise AssertionError(f"bad predictions: {stats}")
    shape = preds_on[0]["image"].shape
    if shape != (H, W, 1) or set(preds_on[0]) != {*(f"events{k}" for k in range(K)), "image"}:
        raise AssertionError(f"unexpected prediction keys/shape {shape}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    off_model = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="off"),
                                    device=dev)
    off_model.load_state_dict(model.state_dict())
    preds_off, _ = run_slice(off_model, dataset)
    if gru_hside.conv_gru_hside.launches != launches:
        raise AssertionError("fused_gru='off' launched the kernel")
    first_err = max_pred_diff({g: preds_on[g] for g in first_chunk},
                              {g: preds_off[g] for g in first_chunk})
    run_err = max_pred_diff(preds_on, preds_off)
    if not (first_err <= SLICE_TOL):
        raise AssertionError(f"first chunk vs fused_gru='off': {first_err} "
                             f"> {SLICE_TOL}")
    check_no_jax()
    emit({"phase": "slice", "config": CONFIG, "H": H, "W": W, "chunk": CHUNK,
          "K": K, "sequences": list(SEQ_LENGTHS), "packages_processed": packages,
          "k1_launches": launches, "k1_launches_expected": want,
          "first_chunk_max_abs_err_vs_off": first_err, "tol": SLICE_TOL,
          "whole_run_max_abs_err_vs_off": run_err,
          "first_run_s": first_run_s, "peak_mem_gib": peak_gib})

    # 4. timing
    cells = time_cells(dev, gen)
    walls = []
    for m in (off_model, model, model, off_model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_slice(m, dataset, keep=set())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    maps = packages * (K + 1)
    emit({"phase": "timing", "cells": cells,
          "slice_maps": maps,
          "slice_maps_per_s": maps / min(walls[1], walls[2]),
          "slice_off_maps_per_s": maps / min(walls[0], walls[3]),
          "slice_wall_s_off_on_on_off": walls, "nvidia_smi": smi})

    # 5. the training kernels against their plain versions on the card
    train_rows, res_edges = train_kernel_check(dev, gen)
    emit({"phase": "kernel_train", "k1_tol": K1_TOL, "grad_tol": GRAD_TOL,
          "cells": train_rows, "edge_plans": res_edges})

    # 6. training at full width through the entry point
    from rpg_ramnet_tpu_torch.core.config import Config
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_") as tmp:
        t0 = time.perf_counter()
        write_train_data(os.path.join(tmp, "data"), K, args.seed)
        data_s = time.perf_counter() - t0
        raw = train_config(tmp)
        tcfg = Config.from_dict(raw)
        # per step K1-res twice per h-side cell (each checkpointed package
        # runs its forward twice, the recompute) and K2 once; K1 once per
        # cell of the validation window
        n_cells = 3 * (K + 1) * TRAIN_L
        batch, tmodels, first = first_step_vs_off(
            tcfg, os.path.join(tmp, "data"), dev, args.seed,
            {"k1_res": (gru_hside.conv_gru_hside_res, 2 * n_cells)})
        trained = run_training(raw, tmp, {
            "k1_res": (gru_hside.conv_gru_hside_res, 2 * n_cells * TRAIN_STEPS),
            "k2": (gru_hside.conv_gru_hside_bwd, n_cells * TRAIN_STEPS),
            "k1_validation": (gru_hside.conv_gru_hside, n_cells)})
    check_no_jax()
    emit({"phase": "train", "config": CONFIG, "precompute_x": True,
          "B": TRAIN_B, "L": TRAIN_L, "crop": TRAIN_CROP, "K": K,
          "steps": TRAIN_STEPS, "data_write_s": data_s,
          "first_step_vs_off": first, **trained})

    # 7. training throughput and the training kernels' times
    train_timing = time_training(tcfg, tmodels, batch)
    train_cells = time_train_cells(dev, gen)
    emit({"phase": "timing_train", **train_timing, "cells": train_cells,
          "nvidia_smi": smi})

    # 8. the streaming kernels against their plain versions on the card
    k5_errs, vox_errs = stream_kernel_check(dev, gen, args.seed)
    emit({"phase": "kernel_stream", "cell_tol": CELL_TOL, "vox_tol": VOX_TOL,
          "vox_bf16_tol": VOX_BF16_TOL, "k5_max_abs_err": k5_errs,
          "voxel_max_abs_err": vox_errs})

    # 9. the per-package engine and the live path through their entry points
    stream_model = ERGB2DepthRecurrent(
        cfg, device=dev, generator=torch.Generator().manual_seed(args.seed + 1))
    n_pkg = sum(SEQ_LENGTHS)
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_stream_") as tmp:
        t0 = time.perf_counter()
        log = write_stream_data(tmp, K, args.seed)
        stream_data_s = time.perf_counter() - t0
        files = {m: stream_files(tmp, stream_model, m) for m in ("on", "off")}
        preds_k5, [k5_launches], eval_wall, eval_stats = run_eval_entry(
            *files["on"], tmp)
        want_k5 = 3 * (K + 1) * n_pkg
        if k5_launches != want_k5:
            raise AssertionError(f"K5 launched {k5_launches} times, expected "
                                 f"3*(K+1)*packages = {want_k5}")
        if len(preds_k5) != n_pkg or eval_stats["nonfinite"] \
                or eval_stats["out_of_range"]:
            raise AssertionError(f"per-package predictions: {len(preds_k5)} "
                                 f"items, {eval_stats}")
        preds_plain, [off_launches], _, _ = run_eval_entry(*files["off"], tmp)
        if off_launches:
            raise AssertionError("fused_gru='off' launched K5")
        eval_err = max_pred_diff(preds_k5, preds_plain)
        if not (eval_err <= SLICE_TOL):
            raise AssertionError(f"per-package engine, K5 vs fused_gru='off': "
                                 f"{eval_err} > {SLICE_TOL}")
        # the stream entry per voxel backend, in turns forward and back:
        # K6 ('auto'), K7 ('pallas'), the plain index_add_ ('scatter')
        runs = [(b, run_stream_entry(*files["off"], log, b)) for b in
                STREAM_BACKENDS + STREAM_BACKENDS[::-1]]
        depths_k6, stream_counts, _ = runs[0][1]
        depths_k7, k7_counts, _ = runs[1][1]
        window_err, windows = window_grid_check(log, dev)
    run_counts = {b: [r[1] for bb, r in runs if bb == b] for b in STREAM_BACKENDS}
    want_counts = {"auto": {"k6": windows, "k7": 0}, "pallas": {"k6": 0, "k7": windows},
                   "scatter": {"k6": 0, "k7": 0}}
    if (windows != STREAM_WINDOWS or len(depths_k6) != windows
            or any({k: c[k] for k in ("k6", "k7")} != want_counts[b]
                   or any(sum(c["by_path"][k].values()) != c[k] for k in ("k6", "k7"))
                   for b in STREAM_BACKENDS for c in run_counts[b])):
        raise AssertionError(f"stream: {windows} windows, {len(depths_k6)} "
                             f"depth maps, launches per backend {run_counts}")
    # the batch path: one training batch's windows through the entry point,
    # one launch sequence per backend, on the tiled path (grids beyond L2)
    batch_run = run_batch_entry(dev, args.seed)
    if any(r["launches"] != 1 or r["by_path"]["tiled"] != 1 or not r["finite"]
           or r["shape"] != [VOX_SIZES["batch800"][0], *VOX_GRID]
           or not r["max_rel_err"] <= VOX_TOL for r in batch_run.values()):
        raise AssertionError(f"batch path: {batch_run}")
    window_wall_ms = {b: {"min": min(r[2] for bb, r in runs if bb == b) / windows * 1e3,
                          "runs": [r[2] / windows * 1e3 for bb, r in runs if bb == b]}
                      for b in STREAM_BACKENDS}
    import numpy as np
    if not all(np.isfinite(d).all() for d in depths_k6.values()):
        raise AssertionError("non-finite depth maps in the stream")
    stream_k7_err = max(float(np.abs(depths_k6[i] - depths_k7[i]).max())
                        for i in depths_k6)
    _, vh, vw = VOX_GRID
    if not (window_err <= VOX_TOL and stream_k7_err <= SLICE_TOL):
        raise AssertionError(f"stream windows: K6 vs plain {window_err}, "
                             f"depths K7 vs K6 {stream_k7_err}")
    check_no_jax()
    emit({"phase": "stream", "config": CONFIG, "fused_gru": "on", "H": H,
          "W": W, "K": K, "sequences": list(SEQ_LENGTHS),
          "k5_launches": k5_launches, "k5_launches_expected": want_k5,
          "max_abs_err_vs_off": eval_err, "tol": SLICE_TOL,
          "eval_entry_wall_s": eval_wall, "data_write_s": stream_data_s,
          "stream_windows": windows, "stream_launches": stream_counts,
          "stream_k7_launches": k7_counts, "window_grid_max_rel_err": window_err,
          "depth_k7_vs_k6_max_abs_err": stream_k7_err, "batch_path": batch_run,
          "events_per_window": int(vh * vw * STREAM_EVENTS_PER_PIXEL),
          "window_wall_ms_per_backend": window_wall_ms})

    # 10. per-package latency, K5 per cell, the voxelizers' rates
    off_stream = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="off"),
                                     device=dev)
    off_stream.load_state_dict(stream_model.state_dict())
    on_stream = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="on"),
                                    device=dev)
    on_stream.load_state_dict(stream_model.state_dict())
    latency = time_per_package({"on": on_stream, "off": off_stream}, K,
                               args.seed)
    full_cells = time_full_cells(dev, gen)
    vox_times = time_voxelizers(dev, args.seed)
    emit({"phase": "timing_stream", **latency, "k5_cells": full_cells,
          "voxelizers": vox_times, "nvidia_smi": smi})

    # 11-13. the phased regime and the ConvLSTM kernels
    ph = phased_phases(cfg, K, dev, gen, args.seed, dataset, packages,
                       first_chunk, smi)

    # 14. the chunked path's launch variants against their plain versions
    chunk_errs, chunk_inputs = chunked_kernel_check(dev, args.seed, K)
    emit({"phase": "kernel_chunked", "cell_tol": CELL_TOL, "k1_tol": K1_TOL, "K": K,
          "stream_step": STREAM_STEP, "ragged_pair": RAGGED_PAIR,
          "edge_cells": VARIANT_EDGE_CELLS, "edge_steps": EDGE_STEPS,
          "loop_blocks": LOOP_BLOCKS, "max_abs_err": chunk_errs,
          "pair_ptxas": pair_ptxas(ptxas_by_kernel(kernels.build_log.get("gru_cells", "")))})

    # 15. the variants through the chunked engine and chunk_cells
    variants, variant_timing = chunked_variants(
        cfg, model, dataset, packages, first_chunk, preds_off, off_model, K)
    chunk_cells = time_chunked_kernels(dev, chunk_inputs, K)
    del chunk_inputs
    check_no_jax()
    emit({"phase": "chunked_variants", "config": CONFIG, "H": H, "W": W,
          "chunk": CHUNK, "K": K, "sequences": list(SEQ_LENGTHS),
          "packages_processed": packages, "tol": SLICE_TOL,
          "variants": variants, "timing": variant_timing,
          "cells": chunk_cells, "nvidia_smi": smi})

    # 16. the decoder: K8 and the composed layers against the two-stage
    #     layers, through the chunked and the per-package engines
    dec_errs = decoder_kernel_check(dev, args.seed)
    emit({"phase": "kernel_decoder", "tol": DECODER_TOL,
          "layers": DECODER_LAYERS, "batches": DECODER_BATCHES,
          "ragged": RAGGED_DECODER, "border": BORDER_DECODER,
          "rel_err": dec_errs})
    dec_variants, dec_timing, dec_per_package, dec_latency = decoder_engines(
        cfg, model, dataset, packages, first_chunk, preds_off, K, args.seed)
    dec_layers, composed_rule = time_decoder_layers(dev, args.seed)
    check_no_jax()
    emit({"phase": "decoder", "config": CONFIG, "H": H, "W": W,
          "chunk": CHUNK, "K": K, "sequences": list(SEQ_LENGTHS),
          "packages_processed": packages, "tol": SLICE_TOL,
          "variants": dec_variants, "timing": dec_timing,
          "per_package_entry": dec_per_package,
          "per_package_latency_k8_vs_two_stage": dec_latency,
          "layers_us": dec_layers, "composed_auto_rule": composed_rule,
          "macs_per_map_per_layer": {"16_tap": 4 * 32 * 64 * 16 * 256 * 128,
                                     "25_tap": 4 * 32 * 64 * 25 * 256 * 128},
          "bound_ms_batch96": decoder_bound(96),
          "bound_ms_batch6": decoder_bound(6), "nvidia_smi": smi})

    # 17-19. phased and ConvLSTM training: K3-res, K4-res
    ph_train = phased_train_phases(K, dev, gen, args.seed, smi)

    src = "rpg_ramnet_tpu_torch/csrc/"
    v1m = vox_times["1M"]
    vdev = {k: r["min"] / 1e3 for k, r in v1m["device_us"].items()}
    flagship_keys = ["x".join(map(str, c)) for c in FLAGSHIP_CELLS]
    S = CHUNK * (K + 1)
    k11_bound = cell_bound("k11_step", FLAGSHIP_CELLS)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    print(smi)
    emit({"kernels": [
        entry("gru_hside", "gru_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:289",
              launches, max(e for row in errs.values() for e in row.values()),
              sum(r["kernel_us"] for r in cells) / 1e3,
              sum(r["plain_us"] for r in cells) / 1e3,
              cell_bound("k1", FLAGSHIP_CELLS)),
        entry("gru_hside_res", "gru_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:124",
              trained["launches"]["k1_res"],
              max([max(r["res_h_err"], r["res_acts_err"], *r["res_plans"].values())
                   for r in train_rows]
                  + [e for row in res_edges.values() for e in row["k1_res"].values()]),
              sum(r["res_kernel_us"] for r in train_cells) / 1e3,
              sum(r["res_plain_us"] for r in train_cells) / 1e3,
              cell_bound("k1_res", TRAIN_CELLS)),
        dict(entry("gru_hside_bwd", "gru_hside_bwd.cu",
                   "rpg_ramnet_tpu/ops/gru_hside.py:535", trained["launches"]["k2"],
                   max(max(r["bwd_dh_abs_err"], r["bwd_dgx_abs_err"])
                       for r in train_rows),
                   sum(r["bwd_kernel_us"] for r in train_cells) / 1e3,
                   sum(r["bwd_plain_us"] for r in train_cells) / 1e3,
                   cell_bound("k2", TRAIN_CELLS)),
             wrapper_ms=sum(r["bwd_k2"]["wrapper_us"] for r in train_cells) / 1e3),
        dict(entry("gru_full", "gru_full.cu", "rpg_ramnet_tpu/ops/gru_hside.py:777",
                   k5_launches,
                   max(e for row in k5_errs.values() for k, e in row.items()
                       if k != "exact_gates"),
                   sum(r["kernel_us"] for r in full_cells) / 1e3,
                   sum(r["plain_us"] for r in full_cells) / 1e3,
                   cell_bound("k5", FLAGSHIP_CELLS)),
             wrapper_ms=sum(r["kernel_wrapper_us"] for r in full_cells) / 1e3,
             plan={"x".join(map(str, r["shape"])): r["plan"] for r in full_cells},
             off_layer_ms=sum(r["plain_layer_bf16_us"] for r in full_cells) / 1e3),
        dict(entry("voxel_scatter", "voxel.cu", "rpg_ramnet_tpu/ops/voxel.py:445",
                   stream_counts["k6"] + batch_run["auto"]["launches"],
                   max(max(r[p]["k6"], r[p]["k6_stats"]) for r in vox_errs.values()
                       for p in voxel.PATHS),
                   vdev["k6"], vdev["plain_scatter"], voxel_bound(VOX_EVENTS),
                   vdev["index_add"]),
             launches_by_path={"stream": stream_counts["by_path"]["k6"],
                               "batch": batch_run["auto"]["by_path"]},
             path_at_1m=v1m["path"],
             plain_wrapper_ms=v1m["wrapper_us"]["plain_scatter"]["min"] / 1e3),
        dict(entry("voxel_onehot", "voxel.cu", "rpg_ramnet_tpu/ops/voxel.py:242",
                   k7_counts["k7"] + batch_run["pallas"]["launches"],
                   max(r[p]["k7_f32"] for r in vox_errs.values() for p in voxel.PATHS),
                   vdev["k7_f32"], vdev["plain_matmul"], voxel_bound(VOX_EVENTS),
                   vdev["index_add"]),
             launches_by_path={"stream": k7_counts["by_path"]["k7"],
                               "batch": batch_run["pallas"]["by_path"]},
             path_at_1m=v1m["path"],
             plain_wrapper_ms=v1m["wrapper_us"]["plain_matmul"]["min"] / 1e3),
        dict(entry("lstm_hside", "lstm_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:368",
                   ph["counts"][0],
                   max(e[0] for row in ph["k3_errs"].values() for k, e in row.items()
                       if k != "exact_gates"),
                   sum(r["k3_kernel_us"] for r in ph["cells"]) / 1e3,
                   sum(r["k3_plain_us"] for r in ph["cells"]) / 1e3,
                   cell_bound("k3", PHASED_CELLS)),
             wrapper_ms=sum(r["k3_wrapper_us"] for r in ph["cells"]) / 1e3,
             plan={"x".join(map(str, r["shape"])): r["k3"]["plan"]
                   for r in ph["cells"] + ph["k3_flagship"]}),
        dict(entry("phased_cell", "lstm_hside.cu",
                   "rpg_ramnet_tpu/ops/phased_cell.py:113", ph["counts"][1],
                   max(e[0] for row in ph["k4_errs"].values() for k, e in row.items()
                       if k != "exact_gates"),
                   sum(r["k4_kernel_us"] for r in ph["cells"]) / 1e3,
                   sum(r["k4_plain_us"] for r in ph["cells"]) / 1e3,
                   cell_bound("k4", PHASED_CELLS)),
             wrapper_ms=sum(r["k4_wrapper_us"] for r in ph["cells"]) / 1e3,
             plan={"x".join(map(str, r["shape"])): r["k4"]["plan"]
                   for r in ph["cells"]}),
        dict(entry("gru_pair", "gru_cells.cu", "rpg_ramnet_tpu/ops/gru_pair.py:69",
                   variants["pair"]["launches"]["k9"],
                   max(e for row in chunk_errs["k9"].values() for e in row.values()),
                   chunk_cells["k9"]["kernel_us"] / 1e3,
                   chunk_cells["k9"]["plain_us"] / 1e3,
                   cell_bound("k1", FLAGSHIP_CELLS[:2])),
             wrapper_ms=chunk_cells["k9"]["wrapper_us"] / 1e3,
             plan=chunk_cells["k9"]["plans"],
             k1_pair_ms=chunk_cells["k1_pair"]["kernel_us"] / 1e3),
        dict(entry("gru_stream", "gru_hside.cu", "rpg_ramnet_tpu/ops/gru_stream.py:102",
                   variants["stream"]["launches"]["k10a"],
                   max(e for row in chunk_errs["k10a"].values() for e in row.values()),
                   sum(chunk_cells[f"k10a_{k}"]["kernel_us"] for k in flagship_keys) / 1e3,
                   sum(chunk_cells[f"k10a_{k}"]["plain_us"] for k in flagship_keys) / 1e3,
                   cell_bound("k1", FLAGSHIP_CELLS)),
             wrapper_ms=sum(chunk_cells[f"k10a_{k}"]["wrapper_us"] for k in flagship_keys) / 1e3,
             plan={k: chunk_cells[f"k10a_{k}"]["plan"] for k in flagship_keys}),
        dict(entry("gru_stream_pair", "gru_cells.cu",
                   "rpg_ramnet_tpu/ops/gru_stream.py:138",
                   variants["stream_pair"]["launches"]["k10b"],
                   max(max(chunk_errs["k10b"]["plans"].values()),
                       *(v for k, v in chunk_errs["k10b"].items() if k != "plans")),
                   chunk_cells["k10b"]["kernel_us"] / 1e3,
                   chunk_cells["k10b"]["plain_us"] / 1e3,
                   cell_bound("k1", FLAGSHIP_CELLS[:2])),
             wrapper_ms=chunk_cells["k10b"]["wrapper_us"] / 1e3,
             plan=chunk_cells["k10b"]["plans"],
             k1_pair_ms=chunk_cells["k1_pair"]["kernel_us"] / 1e3),
        dict(entry("gru_chunk", "gru_chunk.cu", "rpg_ramnet_tpu/ops/gru_chunk.py:155",
                   variants["chunk_cells"]["launches"]["k11"],
                   max(r["per_step_err"] for row in chunk_errs["k11"].values()
                       for r in list(row["plans"].values())
                       + ([row["looping_grid"]] if "looping_grid" in row else [])),
                   sum(chunk_cells[f"k11_{k}"]["kernel_us"] for k in flagship_keys) / 1e3,
                   sum(chunk_cells[f"k11_{k}"]["plain_us"] for k in flagship_keys) / 1e3,
                   (S * k11_bound[0], k11_bound[1])),
             wrapper_ms=sum(chunk_cells[f"k11_{k}"]["wrapper_us"] for k in flagship_keys) / 1e3,
             plan={k: chunk_cells[f"k11_{k}"]["plan"] for k in flagship_keys}),
        entry("upsample_conv", "upsample_conv.cu",
              "rpg_ramnet_tpu/ops/upsample_conv.py:203",
              dec_variants["k8"]["launches"]["k8"],
              max(r["k8_rel_err"] for r in dec_errs.values()),
              composed_rule["sum_us_batch96"]["k8"] / 1e3,
              composed_rule["sum_us_batch96"]["two_stage"] / 1e3,
              decoder_bound(96),
              composed_rule["sum_us_batch96"]["composed"] / 1e3),
        entry("lstm_hside_res", "lstm_hside.cu",
              "rpg_ramnet_tpu/ops/gru_hside.py:356",
              ph_train["launches"]["k3_res"],
              max(r["k3_res_err"] for r in ph_train["rows"]),
              sum(r["k3_res_kernel_us"] for r in ph_train["cells"]) / 1e3,
              sum(r["k3_res_plain_us"] for r in ph_train["cells"]) / 1e3,
              cell_bound("k3_res", PHASED_TRAIN_CELLS)),
        entry("phased_cell_res", "lstm_hside.cu",
              "rpg_ramnet_tpu/ops/phased_cell.py:97",
              ph_train["launches"]["k4_res"],
              max(r["k4_res_err"] for r in ph_train["rows"]),
              sum(r["k4_res_kernel_us"] for r in ph_train["cells"]) / 1e3,
              sum(r["k4_res_plain_us"] for r in ph_train["cells"]) / 1e3,
              cell_bound("k4_res", PHASED_TRAIN_CELLS))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
