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
TBPTT training of the phased regime (fused_gru='on', B=8, L=10, crop
224, through the training entry point) with a first step of the
ConvLSTM state combination; and lane-batched streaming through the eval
entry point (--lanes 8 --scan_chunk 4, --lanes 8 with fused_gru='on',
the phased regime with --lanes 2) with the offline evaluation entry
(``python -m rpg_ramnet_tpu_torch.eval.evaluation``) on what it wrote;
the paper's baselines (the recurrent e, rgb and ergb0 recipes and the
non-recurrent UNet ERGB2Depth) through the eval and training entry
points; the trainer's previews, gradient accumulation, checkpoint
policies and resume through the training entry point; and the model zoo
(BN/IN norms in eval and training mode, concat and no skips,
transposed-conv and fast-upsample decoders, ConvLSTM encoders, the
'conv' and 'sum' state combinations) through the eval and training entry
points; and flagship training from raw events, voxelized on the card a
batch at a time by the device data path
(``rpg_ramnet_tpu_torch.data.raw_pipeline``) at 256x512; and data
parallelism (``rpg_ramnet_tpu_torch.parallel``): the flagship's training
step as two gloo ranks sharing the card, the training entry point as an
NCCL world of one, lanes over a two-replica mesh of the card and the raw
pipeline's per-rank shares; and spatial partitioning: one stream's H in
row bands over a two-band mesh of the card through the per-package
engine, and the dry run's data x spatial legs.  It imports nothing of JAX
or of the JAX package.

Phases, each printed as one JSON line:
  1. device        the card, its power limit, its peaks (dense bf16 FLOP/s
                   and HBM bytes/s, ``utils.costs.device_peaks``: a card
                   the table does not hold fails the run), the nvcc
                   builds (in parallel; lstm_hside.cu and gru_full.cu also
                   with their IEEE gates);
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
                   the slice's maps/s and its share of the bf16 peak
                   (``utils.costs.package_costs`` at 256x512, bf16, per
                   package, times packages/s: JAX bench.py's formula), and
                   one 'off' package's FLOPs as torch's FlopCounterMode
                   counts them (``utils.costs.counted_costs``) beside the
                   analytic count;
  5. kernel_train  K1-res, K2 and the ConvGRUHside Function against their
                   plain versions at the three training shapes (B=16) and
                   one ragged shape; K1-res (h', acts) and K2 (dh, dgx:
                   max and mean error) also under every plan kind there
                   and at the edge shapes;
  6. train         the first step's loss and gradients against
                   fused_gru='off'; a first epoch of BatchLoader batches
                   with thread workers, then with process workers twice
                   (the pool's start, then the running pool), bit for
                   bit, each epoch's wall; then the entry point with
                   --worker_mode process
                   for TRAIN_STEPS optimizer steps and one validation
                   batch on a synthetic on-disk split: finite losses, the
                   K1-res, K2 and K1 launch counts, peak memory, both
                   loaders' pools shut down when it returns;
  7. timing_train  training sequences/s with the kernels and with 'off'
                   and the step's share of the bf16 peak
                   (``utils.costs.train_window_costs``, JAX bench.py's
                   formula),
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
                   spills);
 20. kernel_lanes  K1 and K5 at the flagship h-side shapes with B = 8 (K1's
                   gx a step of a [B, K, ...] buffer, as the precomputed
                   path passes it), K9 at the B = 8 pair, K3 and K4 at the
                   phased shapes with B = 2, against their plain versions
                   under the planner's plan: plan, max abs error, device us
                   per launch beside the first lane's alone (queued);
 21. lanes         the eval entry point on ten on-disk sequences of 2-6
                   packages at 256x512 with --lanes 8 --scan_chunk 4
                   (K1's launch count at B = 8; again with fused_pair='on':
                   K9's) and --lanes 8 with fused_gru='on' (K5's), each
                   item against the single-lane engine's run; the phased
                   regime with --lanes 2, per package and with
                   --scan_chunk 4 (K3's and K4's counts at B = 2), against
                   single lane; the evaluation entry in-process on the
                   lane and single-lane chunked runs' output trees (both
                   tables printed: the same keys, frame count and NaN
                   keys, the all-pixel leg finite); lane maps/s beside the
                   single lane's on 8 in-memory sequences of 24 packages,
                   and each forward alone at B = 8 and B = 1;
 22. baselines     the paper's baselines, their config files as shipped
                   (float32) with the paths, crop and batch set in code:
                   baseline_e, baseline_rgb, baseline_ergb (ergb0) and
                   baseline_ergb_no_recurrent (ERGB2Depth, raw events in
                   the folder its config names) through the eval entry
                   point per package on two on-disk sequences of 8 and 5
                   packages at 256x512: finite maps in [0, 1] under the
                   keys prediction_keys names, ERGB2Depth with
                   --scan_chunk 4 against its per-package run; the ergb0
                   recipe in bf16 with fused_decoder='on' (K8, three
                   launches per package) against 'off'; training through
                   the training entry point (baseline_ergb and
                   no_recurrent, B=4, L=10, crop 224, two steps and one
                   validation batch): finite losses, peak memory;
 23. trainer       the rest of the trainer (previews off in phases 6,
                   18 and 22): K1-res and K2 at micro-batch 8 (the B=16
                   recipe under grad_accum 2) against their plain versions,
                   their plans and device us beside B=16's; the first step
                   under grad_accum 2 and remat_policy 'gru_gx' against
                   'off'; the training entry point for 2 epochs of 2 steps
                   with validation, the flagship's preview settings and
                   state previews, async checkpoints and a writer that
                   records the calls (the tags expected given which of
                   tensorboard, PIL and matplotlib import; K1-res, K2 and
                   K1 launch counts), then resumed from its epoch-0
                   checkpoint (epoch 1's parameters against the straight
                   run's, deterministic library algorithms on); peak memory
                   and seq/s per (remat_policy, grad_accum) in alternating
                   rounds, with the spread of identical programs (the
                   policies are one program in the port); remat_chunk 2
                   on the ergb0 baseline through the entry point against
                   remat_chunk 1;
 24. zoo           the model zoo: the flagship recipe (bf16) with options
                   set in code, on two on-disk sequences of 4 and 3
                   packages at 256x512 through the eval entry point:
                   (a) BN, concat skips, transposed-conv decoders, chunked
                   with x precompute (K1) and per package with
                   fused_gru='on' (K5), each against 'off'; (b) IN,
                   ConvLSTM encoders (not phased), no skips, per package
                   with fused_gru and fused_decoder 'on' (K5; K8 gated
                   off by the norm) against 'off', and the same norm-free
                   (K8 with skip=None on every layer); (c) norm-free concat
                   skips and fast-upsample decoders, the first step with
                   precompute_x (K1-res, K2) against 'off' at B=4, L=10,
                   crop 224; (d) BN training, two steps with remat on and
                   off, each from the same parameters (the running stats
                   agree after each), then the training entry
                   point for an epoch and resumed from its checkpoint (the
                   buffers restored bit for bit); (e) the 'conv' and 'sum'
                   state combinations per package: finite maps of the
                   right shape;
 25. raw_pipeline  flagship training from raw events at 256x512 (B=16,
                   L=10, K=5, precompute_x): RawEventSequenceDataset on a
                   synthetic on-disk split (every item padded to 32768
                   events a window), BatchLoader, device_voxelize_prefetch
                   (K6: one launch sequence per batch of 800 windows, the
                   tiled path) and make_train_step for RAW_STEPS steps:
                   the K6, K1-res and K2 launch counts, finite losses,
                   peak memory; each batch's grids against the plain
                   scatter, K7 on the first batch, the first step with
                   K6's grids against the scatter's (loss, gradient
                   cosines), the per-batch voxelize ms (CUDA events) beside
                   the step's s;
 26. parallel      data parallelism at full width on the one card: two gloo
                   ranks (``chip_smoke.py --ddp_worker`` subprocesses with
                   torchrun's environment, each on cuda:0 with B=8) take
                   one train step of a B=16, L=10, 224² global batch:
                   each rank's K1-res and K2 counts and peak memory, the
                   loss and every gradient against one process on the
                   whole batch; the training entry point as an NCCL world
                   of one (a subprocess, 2 steps at B=4): its JSONL entry
                   and checkpoint; run_batched_chunked_streaming (8
                   lanes, chunk 4: K1 at B=4 per replica) and
                   run_batched_streaming with fused_gru='on' (K5 at B=4)
                   over a [cuda:0, cuda:0] mesh against the single-device
                   engine, every item; the eval entry point with --mesh 1
                   --lanes 8 --scan_chunk 4 against no mesh; one 800-window
                   raw batch through device_voxelize_prefetch as 2 shares
                   against the whole batch's grids; K1 and K5 at B=4
                   against their plain versions (plan, device us);
 27. spatial       spatial partitioning (``parallel.spatial``): the
                   flagship at 256x512, B=1, through
                   StreamingInference(spatial_mesh=) with H in two row
                   bands over a [cuda:0, cuda:0] mesh, fused_gru and
                   fused_decoder 'on', 4 packages: K5's and K8's launches
                   per band, the maps against the same kernels unsharded
                   and against 'off'; the phased regime at 256x352 on 3
                   packages likewise (K4, K3 per band); the dry run's DP x
                   SP legs (``entry.dryrun_multichip(4)``, its ranks on
                   cuda:0 over gloo) meanwhile; the per-package wall,
                   spatial against unsharded; K5, K8, K3 and K4 at the
                   band shapes (a band with its halo) against their plain
                   versions, device us beside the unsharded shapes'.
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
import functools
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
# lane-batched streaming (phases 20-21): LANES lanes with LANE_CHUNK
# packages per forward call (LANES x LANE_CHUNK x 6 steps of gx at
# 256x512 bf16 hold about 4 GB) over sequences of unequal lengths, so that
# boundaries fall mid-chunk and lanes run dry at different steps (cut: the
# data); the flagship h-side shapes at B = LANES (K1, K5; K9 on the first
# two); the phased regime with PHASED_LANES lanes (K3, K4 at B =
# PHASED_LANES); a balanced set for the lanes' maps/s: every lane busy
# for 6 chunks (over 2 chunks the first chunk's load, which nothing hides,
# took a third of the lanes' wall)
LANES, LANE_CHUNK = 8, 4
LANE_SEQ_LENGTHS = (6, 2, 5, 3, 4, 2, 5, 3, 4, 2)
LANE_CELLS = tuple((LANES,) + c[1:] for c in FLAGSHIP_CELLS)
PHASED_LANES = 2
PHASED_LANE_SEQ_LENGTHS = (4, 2, 3)
PHASED_LANE_CELLS = tuple((PHASED_LANES,) + c[1:] for c in PHASED_CELLS)
LANE_TIMING_SEQ_LENGTHS = (24,) * LANES
# the paper's baselines (phase 22): the four shipped recipes, read as
# shipped (float32, base 32, 3 encoders, K=5) with the paths, crop and
# batch set in code; two on-disk test sequences of 8 and 5 packages at
# HxW, the no_recurrent one's chunked run against its per-package run;
# the ergb0 recipe again in bf16 with fused_decoder 'on' (K8) against
# 'off'; BASELINE_TRAIN_STEPS training steps of two recipes at B=4, L=10,
# crop 224 (cut: the data)
BASELINE_CONFIGS = {
    "e": "configs/train_e2depth_si_grad_loss_statenet_baseline_e.json",
    "rgb": "configs/train_e2depth_si_grad_loss_statenet_baseline_rgb.json",
    "ergb0": "configs/train_e2depth_si_grad_loss_statenet_baseline_ergb.json",
    "no_recurrent":
        "configs/train_e2depth_si_grad_loss_statenet_baseline_ergb_no_recurrent.json"}
BASELINE_SEQ_LENGTHS = (8, 5)
BASELINE_CHUNK = 4
BASELINE_CHUNK_TOL = 1e-4
BASELINE_TRAIN_B = 4
BASELINE_TRAINED = ("ergb0", "no_recurrent")
# phase 23: the trainer through the entry point with its previews, the
# B=16 recipe under grad_accum 2 (K1-res, K2 at micro-batch 8) and
# remat_policy 'gru_gx' (accepted; the port's checkpoint recomputes each
# package whole); the policies' and accumulations' peak memory and seq/s;
# remat_chunk 2 on the ergb0 baseline's in-scan path
TRAINER_ACCUM, TRAINER_POLICY, TRAINER_EPOCHS = 2, "gru_gx", 2
MICRO_TRAIN_CELLS = tuple((TRAIN_B // TRAINER_ACCUM,) + c[1:]
                          for c in TRAIN_CELLS)
PLAN_OFF_RATIO = 0.6   # a B=8 pick above this share of B=16's time is off
TRAINER_RUNS = (("none", 1), ("none", 2), ("enc_out", 2), ("gru_gx", 2),
                ("gru_gx", 1))          # (remat_policy, grad_accum) timed
REMAT_CHUNK_TOL = 1e-3  # ergb0, remat_chunk 2 vs 1: relative loss difference
# the model zoo (phase 24): the flagship recipe with each case's model
# options set in code; two on-disk sequences of 4 and 3 packages at HxW
# through the eval entry point, chunk 4 (cut: the data); training at B=4,
# L=10, crop 224, two steps (cut: the data)
ZOO = {
    "a": {"norm": "BN", "skip_type": "concat", "use_upsample_conv": False},
    "b": {"norm": "IN", "recurrent_block_type": "convlstm",
          "skip_type": "no_skip", "fused_decoder": "on"},
    "b_norm_free": {"recurrent_block_type": "convlstm",
                    "skip_type": "no_skip", "fused_decoder": "on"},
    "c": {"skip_type": "concat", "fast_upsample": True},
    "d": {"norm": "BN"},
    "conv": {"state_combination": "conv"},
    "sum": {"state_combination": "sum"},
}
ZOO_SEQ_LENGTHS = (4, 3)
ZOO_CHUNK = 4
ZOO_TRAIN_B = 4
ZOO_STATS_TOL = 1e-3   # (d) running stats, remat on vs off from the same
                       # parameters: max abs error over the largest
                       # magnitude, after each step
# phase 25: flagship training from raw events through the device data path
# (rpg_ramnet_tpu_torch/data/raw_pipeline.py): TRAIN_B windows of TRAIN_L
# packages of K raw event windows at HxW (EventScape's size: raw events
# cannot be cropped), every item padded to the RAW_N_MAX bucket, so that
# a batch is batch800's 800 windows; RAW_EVENTS events a window (0.23 a
# pixel); RAW_STEPS steps over as many shuffled epochs of the split's
# TRAIN_B windows (cut: the data)
RAW_N_MAX, RAW_EVENTS, RAW_STEPS = 32768, 30000, 2
# phase 26: two gloo ranks sharing the card (NCCL refuses two ranks on one
# GPU), each at TRAIN_B / PAR_RANKS; lanes over a [cuda:0, cuda:0] mesh
# (K1 and K5 at LANES / 2 per replica); the NCCL world of one at NCCL_B
PAR_RANKS = 2
MESH_CELLS = tuple((LANES // PAR_RANKS,) + c[1:] for c in FLAGSHIP_CELLS)
MESH_ENTRY_SEQ_LENGTHS = (4, 2, 3, 2, 2, 3, 2, 2)
NCCL_B = 4
VOX_SHARD_TOL = 1e-6   # a share's normalized grids vs the whole batch's
# phase 27: spatial partitioning on the one card: the flagship at HxW,
# B=1, H in SPATIAL_BANDS row bands over a [cuda:0, cuda:0] mesh (cut: two
# bands on one card; the copies between cards need a 4-chip call) with
# fused_gru and fused_decoder 'on', SPATIAL_PACKAGES packages, against the
# same kernels unsharded and against 'off'; the phased regime at
# PHASED_HxPHASED_W on PHASED_SPATIAL_PACKAGES; the dry run's DP x SP legs
# on [cuda:0] * SPATIAL_DRYRUN; per-package wall over SPATIAL_TIMED
# packages a turn
SPATIAL_BANDS, SPATIAL_PACKAGES, PHASED_SPATIAL_PACKAGES = 2, 4, 3
SPATIAL_DRYRUN, SPATIAL_TIMED = 4, 8


@functools.lru_cache(maxsize=1)
def peaks():
    """(dense bf16 FLOP/s, HBM bytes/s) of the card, from
    ``rpg_ramnet_tpu_torch.utils.costs.device_peaks`` (ValueError for a
    card it does not know)."""
    import torch
    from rpg_ramnet_tpu_torch.utils import costs
    return costs.device_peaks(torch.cuda.get_device_name())[:2]


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


def decoder_bound(batch, layers=DECODER_LAYERS):
    """(least ms, 'operations' or 'bytes') of the three flagship decoder
    layers (``layers``: (C, Cout, H, W) of each input) at one decode
    batch, summed: per layer the larger of its least MACs (the bilinear 2x
    composed into four 4x4 phase kernels: 16*C*Cout per 2x pixel) at the
    bf16 dense peak and its bytes (x, the skip of layers 1 and 2, out,
    each once; the weights) at the HBM rate."""
    by = {"operations": 0.0, "bytes": 0.0}
    for i, (C, Cout, h, w) in enumerate(layers):
        t_ops = 2 * 4 * h * w * 16 * C * Cout * batch / peaks()[0]
        io = batch * h * w * C * 2 * (2 if i else 1) + batch * 4 * h * w * Cout * 2
        t_bytes = (io + 25 * C * Cout * 2) / peaks()[1]
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
    return graph_time_us(fn, calls), {}


def graph_time_us(fn, calls):
    """Device us per call of fn: the CUDA events time of a CUDA graph's
    replay of ``calls`` calls (what the profiler timers fall back to where
    it keeps no record)."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_us(graph.replay, 3) / calls


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


def call_device_us(fn, calls):
    """(device us per call, {kernel name: mean us}, records) of fn, which
    launches each of its kernels (memsets included) once per call: per
    name the mean of the records torch.profiler kept over ``calls`` calls
    after one warm-up call, summed over the names, so that records the
    profiler drops do not cut the time as a sum over the calls would
    (launch_device_us for several kernels).  Where it keeps none, the
    CUDA events time of a CUDA graph's replay of the calls (graph_time_us;
    not a second profile, which could keep a part of them)."""
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
            names.setdefault(e.name, []).append(e.device_time)
    if not names:
        return graph_time_us(fn, calls), {}, 0
    means = {k: sum(v) / len(v) for k, v in names.items()}
    return sum(means.values()), means, sum(len(v) for v in names.values())


def time_train_cells(dev, gen, iters=20, shapes=TRAIN_CELLS):
    """Microseconds per cell of K1-res and K2 and of their plain versions
    at the training shapes, in turns plain, kernel, kernel, plain; each
    kernel also unqueued (its wrapper's time), with its plan, device us
    per launch, weight MB per launch, registers and spills."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    import torch
    rows = []
    for shape in shapes:
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
    and data folders in tmp, one epoch, a checkpoint after it, no
    previews."""
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = json.load(f)
    raw["name"] = "smoke_train"
    # previews off: phase 23 drives them
    raw["trainer"].update(precompute_x=True, epochs=1, save_freq=1,
                          log_every=1, save_dir=os.path.join(tmp, "runs"),
                          sequence_length=TRAIN_L, still_previews=False,
                          movie=False)
    raw["data_loader"]["batch_size"] = TRAIN_B
    for split, folder in (("train", "train"), ("validation", "val")):
        raw["data_loader"][split].update(base_folder=folder, step_size=1)
    raw["data_loader"]["crop_size"] = TRAIN_CROP
    return raw


def first_step_vs_off(cfg, root, dev, seed, counters, step_grads=False):
    """Loss and every parameter gradient of one window batch
    (cfg.batch_size windows, with timestamps where cfg.use_phased_arch)
    with the kernels (cfg.model.fused_gru, 'auto' or 'on') and with the
    plain layers ('off'), from the same weights.  counters: {name:
    (wrapper, launches expected with the kernels)}; 'off' must launch
    none.  step_grads: the gradients of the train step (make_grad_fn:
    cfg.trainer.grad_accum micro-batches) in place of one backward of the
    remat'd loss.  Returns the batch, both
    models and the comparison."""
    import torch
    from rpg_ramnet_tpu_torch.data import BatchLoader, concatenate_subfolders
    from rpg_ramnet_tpu_torch.data.loader import device_prefetch
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
    from rpg_ramnet_tpu_torch.train.train_step import make_grad_fn
    split = cfg.train_data
    ds = concatenate_subfolders(
        os.path.join(root, "train"), split.type, split.event_folder,
        split.depth_folder, split.frame_folder, TRAIN_L, step_size=1,
        clip_distance=split.clip_distance,
        every_x_rgb_frame=split.every_x_rgb_frame,
        reg_factor=split.reg_factor, use_phased_arch=cfg.use_phased_arch)
    b = cfg.batch_size
    batch = next(device_prefetch(BatchLoader(ds, b, shuffle=False), dev))
    kern = cfg.model.fused_gru
    models, losses, grads, launched = {}, {}, {}, {}
    for mode in (kern, "off"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               fused_gru=mode))
        model = ERGB2DepthRecurrent(c.model, device=dev,
                                    generator=torch.Generator().manual_seed(seed))
        n0 = {k: w.launches for k, (w, _) in counters.items()}
        if step_grads:
            loss = make_grad_fn(c, model)(batch)["loss"]
        else:
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


def share_of_peak(flops_per_s):
    """flops_per_s over the card's dense bf16 peak; fails unless it is
    finite and in (0, 1)."""
    share = flops_per_s / peaks()[0]
    if not (math.isfinite(share) and 0.0 < share < 1.0):
        raise AssertionError(f"share of the bf16 peak {share}")
    return share


def slice_costs(cfg, off_model, packages_per_s, dev, seed):
    """The chunked slice's share of the bf16 peak by JAX bench.py's
    formula (analytic FLOPs of one bf16 package at HxW, batch 1, times
    packages/s), and one package of the plain path (off_model:
    fused_gru='off'; forward_package with no kernel allowed) counted by
    torch's FlopCounterMode beside the analytic count."""
    import torch
    from rpg_ramnet_tpu_torch.models import event_loop_range
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils import costs
    analytic = costs.package_costs(cfg, H, W, batch=1, act_bytes=2).flops
    g = torch.Generator().manual_seed(seed + 7)
    pkg = {"events": torch.randn(1, event_loop_range(cfg), H, W,
                                 cfg.num_bins_events, generator=g).to(dev),
           "image": torch.rand(1, H, W, cfg.num_bins_rgb, generator=g).to(dev)}
    launches = gru_hside.conv_gru_hside.launches
    with torch.no_grad():
        counted = costs.counted_costs(off_model.forward_package,
                                      off_model.init_state(1, H, W), pkg)
    if gru_hside.conv_gru_hside.launches != launches:
        raise AssertionError("the counted 'off' package launched K1")
    if not counted["flops"] > 0:
        raise AssertionError(f"counted FLOPs {counted}")
    return {"slice_mfu_vs_bf16_peak": share_of_peak(analytic * packages_per_s),
            "analytic_flops_per_package": analytic,
            "counted_flops_per_package": counted["flops"],
            "counted_over_analytic": counted["flops"] / analytic,
            "slice_packages_per_s": packages_per_s}


def train_costs(cfg, seq_per_s):
    """The training step's share of the bf16 peak by JAX bench.py's
    formula: the analytic FLOPs of one TBPTT window batch (TRAIN_B
    windows of TRAIN_L packages at TRAIN_CROP, two supervised decodes,
    remat) over the step's seconds."""
    from rpg_ramnet_tpu_torch.utils import costs
    flops = costs.train_window_costs(cfg.model, TRAIN_CROP, TRAIN_CROP,
                                     batch=TRAIN_B, L=TRAIN_L,
                                     supervised_decodes=2, remat=True).flops
    return {"train_mfu_vs_bf16_peak": share_of_peak(flops * seq_per_s / TRAIN_B),
            "analytic_flops_per_step": flops}


def pools_down(trainer):
    """Both of the trainer's loaders ran process workers and shut their
    pools down, and no worker process is left."""
    import multiprocessing
    loaders = (trainer.train_loader, trainer.valid_loader)
    left = multiprocessing.active_children()
    if any(ld.worker_mode != "process" or ld._proc_pool is not None
           for ld in loaders) or left:
        raise AssertionError(f"process pools not shut down: {left}")
    return True


def process_worker_check(cfg, root):
    """The training split's first epoch (the entry point's training
    transforms, shuffled) through BatchLoader with thread workers, then
    twice with process workers (the pool's first epoch, which starts it,
    and the same epoch again on the running pool): each process batch
    equal to the thread batch bit for bit; each epoch's wall; the pool
    shut down after."""
    import multiprocessing

    import numpy as np
    from rpg_ramnet_tpu_torch.data import (BatchLoader, Compose, RandomCrop,
                                           RandomRotationFlip,
                                           concatenate_subfolders)
    split = cfg.train_data
    ds = concatenate_subfolders(
        os.path.join(root, "train"), split.type, split.event_folder,
        split.depth_folder, split.frame_folder, TRAIN_L, step_size=1,
        transform=Compose([RandomRotationFlip(0.0, 0.5, 0.0),
                           RandomCrop(TRAIN_CROP)]),
        clip_distance=split.clip_distance,
        every_x_rgb_frame=split.every_x_rgb_frame,
        reg_factor=split.reg_factor)

    def loader(mode):
        return BatchLoader(ds, cfg.batch_size, num_workers=cfg.num_workers,
                           seed=5, worker_mode=mode)

    t0 = time.perf_counter()
    want = list(loader("thread"))
    walls = {"thread_epoch_s": time.perf_counter() - t0}
    same = len(want) > 0
    proc = loader("process")
    try:
        for name in ("process_epoch_cold_s", "process_epoch_warm_s"):
            proc.set_epoch(0)
            t0 = time.perf_counter()
            got = 0
            for a, b in zip(proc, want):
                got += 1
                same &= a.keys() == b.keys() and all(
                    a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                    for k in a)
            walls[name] = time.perf_counter() - t0
            same &= got == len(want)
    finally:
        proc.close()
    left = multiprocessing.active_children()
    if not same or left:
        raise AssertionError(f"process workers' batches differ from the "
                             f"thread workers', or workers are left: {left}")
    item_mb = sum(v[0].nbytes for v in want[0].values()) / 2 ** 20
    return {"batches": len(want), "bitwise": same, "workers": cfg.num_workers,
            "item_mb": item_mb, **walls}


def run_training(raw, tmp, counters, writer=None, resume=None, keep=None,
                 argv=()):
    """The entry point in-process on the synthetic split, with every
    launch count in counters ({name: (wrapper, expected launches)}) set to
    0 just before; returns its first epoch's log, the counts read just
    after and the peak memory.  writer: the trainer's TensorBoard writer;
    resume: the -r argument; keep: a list the trainer is appended to;
    argv: more flags."""
    import torch
    from rpg_ramnet_tpu_torch.train.__main__ import main as train_main
    cfg_path = os.path.join(tmp, f"{raw['name']}_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    os.environ["PREPROCESSED_DATASETS_FOLDER"] = os.path.join(tmp, "data")
    for w, _ in counters.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_main(["-c", cfg_path, *argv]
                         + (["-r", resume] if resume else []), writer=writer)
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
    ckpt = os.path.join(trainer.run_dir, f"checkpoint-epoch{log['epoch']}",
                        "state.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    if keep is not None:
        keep.append(trainer)
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
        t_ops = 2 * macs * C * C * B * H * W / peaks()[0]
        t_bytes = ((io * B + shared) * C * H * W
                   + wts * C * C) / peaks()[1]
        by["operations" if t_ops >= t_bytes else "bytes"] += max(t_ops, t_bytes)
    return sum(by.values()) * 1e3, max(by, key=by.get)


def voxel_bound(n_events, windows=1):
    """(least ms, 'bytes') of the voxel grids of ``windows`` windows of
    n_events each: the events read once (16 bytes each) and each
    5x260x346 float32 grid written once; the few float32 operations per
    event are far below the bytes' time."""
    nb, h, w = VOX_GRID
    return (windows * (16 * n_events + 4 * nb * h * w)
            / peaks()[1] * 1e3, "bytes")


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
    write_split(root, SEQ_LENGTHS, K, seed, H, W)
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


def index_add_inputs(ev, n_valid, cells, grid=VOX_GRID):
    """The flat indices (window offsets added) and values of every
    window's contributions to (num_bins, H, W) grids, those outside the
    grid as (0, 0.0): what the one index_add_ call that computes the grids
    takes."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    nb, h, w = grid
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
    durations, per kernel too: summed over the calls and divided by them
    for one window, per kernel name the mean of the records kept for a
    batch of windows, ``call_device_us``) and wrapper us per call (CUDA events around
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
        per_kernel, records = {}, {k: [] for k in calls}
        for _ in range(VOX_TURNS):
            for k in list(calls) + list(reversed(calls)):
                if B == 1:
                    t, per_kernel[k] = device_time_us(calls[k], reps)
                else:
                    t, per_kernel[k], kept = call_device_us(calls[k], reps)
                    records[k].append(kept)
                dev_us[k].append(t)
                wrap_us[k].append(cuda_time_us(calls[k], reps))
        bound_ms, _ = voxel_bound(n, B)
        row = {"windows": B, "events_per_window": n, "bound_us": bound_ms * 1e3,
               "path": path, "other_path": other,
               "device_us": {k: spread(v) for k, v in dev_us.items()},
               "wrapper_us": {k: spread(v) for k, v in wrap_us.items()},
               "device_us_per_kernel": per_kernel,
               **({"device_records": records} if B > 1 else {}),
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


def write_split(root, lengths, K, seed, h, w):
    """An on-disk split under root/test: sequences of these package counts
    at h x w, timestamps included (a sequence of one package reads as
    empty: keep them at two or more)."""
    from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
    for s, n in enumerate(lengths):
        generate_eventscape_sequence(os.path.join(root, "test", f"seq{s:02d}"),
                                     n_frames=K * n, height=h, width=w,
                                     seed=seed + s)


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
        write_split(tmp, PHASED_SEQ_LENGTHS, K, seed + 7, PHASED_H, PHASED_W)
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
        write_split(tmp, DECODER_SEQ_LENGTHS, K, seed + 11, H, W)
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


def lane_steps(lengths, lanes, chunk=1):
    """Steps the lane engines run over sequences of these lengths: the
    longest lane's item count (round-robin, as
    inference._round_robin_lanes), rounded up to whole chunks."""
    longest = max(sum(lengths[i::lanes]) for i in range(lanes))
    return -(-longest // chunk) * chunk


def lane_kernel_rows(cases, iters=20):
    """{shape: {max_abs_err, plan, device_us (B), device_us_b1 (the first
    lane alone)}} of kernels against their plain versions: cases are (key,
    kernel, plain, kernel on the first lane, tol, plan); raises where an
    error is over its tol.  Device us per launch: CUDA events around
    ``iters`` launches queued behind a sleep kernel (``cuda_time_us``;
    torch.profiler drops records this late in a run)."""
    import torch
    rows = {}
    for key, kern, plain, kern1, tol, plan in cases:
        with torch.no_grad():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            del got, want
            if not (err <= tol):
                raise AssertionError(f"{key} vs plain: max abs err {err} > {tol}")
            us = cuda_time_us(kern, iters, queued=True)
            us1 = cuda_time_us(kern1, iters, queued=True)
        rows[key] = {"max_abs_err": err, "tol": tol, "plan": plan,
                     "device_us": us, "device_us_b1": us1}
    return rows


def lane_kernel_check(dev, seed, K):
    """Phase 20: K1 and K5 at LANE_CELLS (K1's gx step K // 2 of a [B, K,
    H, W, 3C] buffer: the batch stride the precomputed path gives it), K9
    at the first two (gx likewise), K3 and K4 at PHASED_LANE_CELLS (gx a
    strided view), against their plain versions under the planner's plan:
    ``lane_kernel_rows`` per kernel."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside, gru_pair
    gen = torch.Generator().manual_seed(seed)
    dgen = torch.Generator(device=dev).manual_seed(seed)
    out = {"k1": {}, "k5": {}, "k9": {}, "k3": {}, "k4": {}}
    gru = {}
    for shape in LANE_CELLS:
        B, Hc, Wc, C = shape
        key = "x".join(map(str, shape))
        w_ur, w_o = make_cell_inputs((1, 1, 1, C), dev, gen)[3:]
        h = (torch.rand(shape, device=dev, generator=dgen) * 2 - 1).bfloat16()
        gx = torch.randn((B, K, Hc, Wc, 3 * C), device=dev,
                         generator=dgen).bfloat16()[:, K // 2]
        gru[shape] = (h, gx, w_ur, w_o)
        out["k1"].update(lane_kernel_rows([(
            key, lambda a=gru[shape]: gru_hside.conv_gru_hside(*a),
            lambda a=gru[shape]: gru_hside.conv_gru_hside_plain(*a),
            lambda a=gru[shape]: gru_hside.conv_gru_hside(a[0][:1], a[1][:1],
                                                          *a[2:]),
            K1_TOL, plan_name(gru_hside.plan_k1(*shape)))]))
        _, x, h5, w5 = make_full_cell_inputs(shape, dev, gen)
        out["k5"].update(lane_kernel_rows([(
            key, lambda: gru_hside.conv_gru_full(x, h5, *w5),
            lambda: gru_hside.conv_gru_full_plain(x, h5, *w5),
            lambda: gru_hside.conv_gru_full(x[:1], h5[:1], *w5),
            CELL_TOL, plan_name(gru_hside.plan_k5(*shape)))]))
        del x, h5, w5
    pair = [a for shape in LANE_CELLS[:2] for a in gru[shape]]
    pair1 = [a[:1] if i % 4 < 2 else a for i, a in enumerate(pair)]
    out["k9"] = lane_kernel_rows([(
        "+".join("x".join(map(str, c)) for c in LANE_CELLS[:2]),
        lambda: gru_pair.conv_gru_hside_pair(*pair),
        lambda: gru_pair.conv_gru_hside_pair_plain(*pair),
        lambda: gru_pair.conv_gru_hside_pair(*pair1), K1_TOL,
        [plan_name(p) for p in gru_pair.plan_k9(*LANE_CELLS[:2])])])
    del gru, pair, pair1
    for shape in PHASED_LANE_CELLS:
        key = "x".join(map(str, shape))
        inputs = make_lstm_inputs(shape, dev, gen, strided_gx=True)
        h, c, gx, w4, tau, phase, t = inputs
        first = (h[:1], c[:1], gx[:1], w4, tau, phase, t[:1])
        for kind in ("k3", "k4"):
            kern, plain = lstm_calls(inputs, kind)
            kern1, _ = lstm_calls(first, kind)
            out[kind].update(lane_kernel_rows([(
                key, kern, plain, kern1, CELL_TOL,
                plan_name(gru_hside.plan_lstm(*shape, phased=kind == "k4")))]))
        del inputs, first, h, c, gx
    return out


def lane_run(files, tmp, counters, want, lengths, crop=(H, W), extra=(),
             what=""):
    """run_eval_entry, then the checks every lane run shares: the launch
    counts as expected, every item predicted, finite values in [0, 1].
    Returns (predictions, counts, wall s)."""
    preds, counts, wall, stats = run_eval_entry(*files, tmp, counters, crop,
                                                extra)
    if counts != want or len(preds) != sum(lengths) or stats["nonfinite"] \
            or stats["out_of_range"]:
        raise AssertionError(f"{what}: launches {counts}, expected {want}; "
                             f"{len(preds)} items of {sum(lengths)}, {stats}")
    return preds, counts, wall


def lane_maps_per_s(models, K, seed):
    """Lane maps/s over LANE_TIMING_SEQ_LENGTHS in memory at 256x512:
    chunked (run_chunked_streaming against run_batched_chunked_streaming,
    chunk LANE_CHUNK, models['auto']) and per package (StreamingInference
    with batched decode, as the eval entry runs it, against
    run_batched_streaming, models['on']), each in turns single, lanes,
    lanes, single after the lane phase's warm-up; every map copied to the
    host.  The best of each pair."""
    import torch
    from rpg_ramnet_tpu_torch.eval import (StreamingInference,
                                           run_batched_chunked_streaming,
                                           run_batched_streaming,
                                           run_chunked_streaming)
    dataset = SyntheticDataset(LANE_TIMING_SEQ_LENGTHS, K, seed)
    maps = sum(LANE_TIMING_SEQ_LENGTHS) * (K + 1)

    def per_package_single():
        engine = StreamingInference(models["on"], batched_decode=True)
        for seq in dataset.datasets:
            engine.reset(1, H, W)
            for i in range(len(seq)):
                item = seq[i]
                engine.step({"events": item["events"][0],
                             "image": item["image"][0]})

    runs = {
        "chunked": (lambda: run_chunked_streaming(
                        dataset, models["auto"], chunk=LANE_CHUNK,
                        on_prediction=lambda *a: None),
                    lambda: run_batched_chunked_streaming(
                        dataset, models["auto"], n_lanes=LANES,
                        chunk=LANE_CHUNK, on_prediction=lambda *a: None)),
        "per_package": (per_package_single,
                        lambda: run_batched_streaming(
                            dataset, models["on"], n_lanes=LANES,
                            on_prediction=lambda *a: None))}
    out = {"maps": maps, "sequences": list(LANE_TIMING_SEQ_LENGTHS)}
    for name, (single, lanes) in runs.items():
        walls = []
        for fn in (single, lanes, lanes, single):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"maps_per_s_single": maps / min(walls[0], walls[3]),
                     "maps_per_s_lanes": maps / min(walls[1], walls[2]),
                     "wall_s_single_lanes_lanes_single": walls}
    return out


def lane_forward_ms(models, K, dev, seed, calls=3):
    """ms per forward call with the inputs already on the card (no host
    packing, no copies): the chunked route (``inference._chunk_forward``,
    models['auto']) on a chunk of LANE_CHUNK packages and forward_package
    with the lane engine's flags (models['on']), each at B = LANES and
    B = 1, the least of ``calls`` calls after a warm-up one."""
    import torch
    from rpg_ramnet_tpu_torch.eval import inference
    gen = torch.Generator(device=dev).manual_seed(seed)
    on = models["on"]
    flags = dict(allow_fused=True, allow_fused_decoder=True,
                 allow_composed=on.cfg.composed_decoder == "on")
    out = {}
    for b in (LANES, 1):
        seq = {"events": torch.randn((b, LANE_CHUNK, K, H, W, 5), device=dev,
                                     generator=gen),
               "image": torch.rand((b, LANE_CHUNK, H, W, 1), device=dev,
                                   generator=gen),
               "reset": torch.zeros((b, LANE_CHUNK), dtype=torch.bool,
                                    device=dev)}
        pkg = {k: v[:, 0] for k, v in seq.items()}
        fwd = inference._chunk_forward(models["auto"], None)
        runs = {"chunk": lambda: fwd(models["auto"].init_state(b, H, W), seq),
                "package": lambda: on.forward_package(on.init_state(b, H, W),
                                                      pkg, **flags)}
        for name, fn in runs.items():
            walls = []
            with torch.inference_mode():
                for _ in range(calls + 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_b{b}_ms"] = min(walls[1:])
        del seq, pkg
    return out


def evaluate_tree(out):
    """``python -m rpg_ramnet_tpu_torch.eval.evaluation``'s main in-process
    on the image predictions and targets of an output tree (it prints its
    table; the targets are log depth at the eval entry's dataset
    reg_factor, 5.7); returns (metrics, frames)."""
    from rpg_ramnet_tpu_torch.eval.evaluation import main as evaluation_main
    pred = os.path.join(out, "npy", "image")
    metrics = evaluation_main([
        "--target_dataset", os.path.join(out, "ground_truth", "npy",
                                         "depth_image"),
        "--predictions_dataset", pred, "--clip_distance", "80",
        "--reg_factor", "5.7"])
    return metrics, len([f for f in os.listdir(pred) if f.endswith(".npy")])


def lane_phases(cfg, K, dev, seed, smi):
    """Phases 20-21: the kernels at the lane shapes, then lane-batched
    streaming through the eval entry point: lanes x chunk at 256x512 (K1
    at B = LANES; again with fused_pair='on', K9), per package with
    fused_gru='on' (K5 at B = LANES), the phased regime with PHASED_LANES
    lanes per package and chunked (K4, K3 at B = PHASED_LANES), every item
    against the single-lane engine; the evaluation entry on the chunked
    runs' output trees; lane maps/s.  Returns what the kernels line
    reads."""
    import numpy as np
    import torch
    from rpg_ramnet_tpu_torch.eval import evaluation
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside, gru_pair, phased_cell

    # 20. the kernels at the lane shapes against their plain versions
    t0 = time.perf_counter()
    krows = lane_kernel_check(dev, seed, K)
    emit({"phase": "kernel_lanes", "lanes": LANES, "phased_lanes": PHASED_LANES,
          "k1_tol": K1_TOL, "cell_tol": CELL_TOL, "rows": krows,
          "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})

    # 21. lane-batched streaming through the entry points
    model = ERGB2DepthRecurrent(cfg, device=dev,
                                generator=torch.Generator().manual_seed(seed + 5))
    k1, k5, k9 = (gru_hside.conv_gru_hside, gru_hside.conv_gru_full,
                  gru_pair.conv_gru_hside_pair)
    lstm_counters = [gru_hside.conv_lstm_hside, phased_cell.conv_lstm_phased]
    chunk_args = ("--scan_chunk", str(LANE_CHUNK))
    lane_args = ("--lanes", str(LANES))
    n_chunked = lane_steps(LANE_SEQ_LENGTHS, LANES, LANE_CHUNK)
    n_single = sum(lane_steps((n,), 1, LANE_CHUNK) for n in LANE_SEQ_LENGTHS)
    n_lane_pkg = lane_steps(LANE_SEQ_LENGTHS, LANES)
    ph_lengths = PHASED_LANE_SEQ_LENGTHS
    ph_lane_args = ("--lanes", str(PHASED_LANES))
    crop_ph = (PHASED_H, PHASED_W)
    out = {}
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_lanes_") as tmp:
        t0 = time.perf_counter()
        write_split(tmp, LANE_SEQ_LENGTHS, K, seed + 11, H, W)
        data_s = time.perf_counter() - t0
        files = {m: stream_files(tmp, model, m, name="lanes")
                 for m in ("auto", "on")}
        pair_files = stream_files(tmp, model, "auto", {"fused_pair": "on"},
                                  name="lanes_pair")
        trees = {n: os.path.join(tmp, f"out_{n}") for n in ("single", "lanes")}
        # (b) lanes x chunk: K1 at B = LANES, then K9 with fused_pair='on'
        single, c_single, w_single = lane_run(
            files["auto"], tmp, [k1], [3 * (K + 1) * n_single],
            LANE_SEQ_LENGTHS,
            extra=chunk_args + ("--output_path", trees["single"]),
            what="single-lane chunked")
        lanes, c_lanes, w_lanes = lane_run(
            files["auto"], tmp, [k1], [3 * (K + 1) * n_chunked],
            LANE_SEQ_LENGTHS,
            extra=lane_args + chunk_args + ("--output_path", trees["lanes"]),
            what="lanes x chunk")
        pair, c_pair, w_pair = lane_run(
            pair_files, tmp, [k9, k1], [(K + 1) * n_chunked] * 2,
            LANE_SEQ_LENGTHS, extra=lane_args + chunk_args,
            what="lanes x chunk, fused_pair='on'")
        out["chunked"] = {
            "k1_launches": c_lanes[0], "k1_launches_single_lane": c_single[0],
            "k9_k1_launches_pair": c_pair,
            "max_abs_err_vs_single_lane": max_pred_diff(lanes, single),
            "pair_max_abs_err_vs_single_lane": max_pred_diff(pair, single),
            "wall_s_single_lanes_pair": [w_single, w_lanes, w_pair]}
        # (c) per package, fused_gru='on': K5 at B = LANES
        pp_single, c_pp1, w_pp1 = lane_run(
            files["on"], tmp, [k5], [3 * (K + 1) * sum(LANE_SEQ_LENGTHS)],
            LANE_SEQ_LENGTHS, what="single-lane per package")
        pp_lanes, c_ppl, w_ppl = lane_run(
            files["on"], tmp, [k5], [3 * (K + 1) * n_lane_pkg],
            LANE_SEQ_LENGTHS, extra=lane_args, what="lanes per package")
        out["per_package"] = {
            "k5_launches": c_ppl[0], "k5_launches_single_lane": c_pp1[0],
            "max_abs_err_vs_single_lane": max_pred_diff(pp_lanes, pp_single),
            "wall_s_single_lanes": [w_pp1, w_ppl]}
        # (e) the evaluation entry on the chunked runs' trees
        tables = {n: evaluate_tree(t) for n, t in trees.items()}
    (m_single, f_single), (m_lanes, f_lanes) = tables["single"], tables["lanes"]

    def nan_keys(m):
        return sorted(k for k, v in m.items() if not np.isfinite(v))

    # a depth-cutoff leg with no pixel below its cutoff in some frame is
    # NaN, as in the reference: the synthetic scenes' box is 5-11 m and the
    # rest 15-55 m; the all-pixel leg has every pixel
    all_pixels = evaluation.metrics_keywords()[:len(evaluation._BASE_KEYWORDS)]
    out["evaluation"] = {
        "keys": len(m_lanes), "frames": [f_single, f_lanes],
        "nan_keys": [len(nan_keys(m_single)), len(nan_keys(m_lanes))],
        "all_pixel_finite": bool(all(np.isfinite(m[k]) for m in (m_single, m_lanes)
                                     for k in all_pixels)),
        "max_abs_diff": max((abs(m_lanes[k] - m_single[k]) for k in m_single
                             if np.isfinite(m_single[k])), default=None)
        if list(m_single) == list(m_lanes) else None,
        "lanes_abs_rel_diff": m_lanes.get("_abs_rel_diff"),
        "single_abs_rel_diff": m_single.get("_abs_rel_diff")}
    want_frames = sum(max(n - 2, 0) for n in LANE_SEQ_LENGTHS)
    if list(m_single) != list(m_lanes) or not m_single \
            or f_single != f_lanes or f_single != want_frames \
            or nan_keys(m_single) != nan_keys(m_lanes) \
            or not out["evaluation"]["all_pixel_finite"]:
        raise AssertionError(f"evaluation of the lane and single-lane trees: "
                             f"{out['evaluation']}")

    # (d) the phased regime with PHASED_LANES lanes, per package and chunked
    phased_cfg = dataclasses.replace(
        cfg, fused_gru="on", **{k: tuple(v) if isinstance(v, list) else v
                                for k, v in PHASED.items()})
    phased_model = ERGB2DepthRecurrent(
        phased_cfg, device=dev, generator=torch.Generator().manual_seed(seed + 6))
    ph_chunk = lane_steps(ph_lengths, PHASED_LANES, LANE_CHUNK)
    ph_chunk1 = sum(lane_steps((n,), 1, LANE_CHUNK) for n in ph_lengths)
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_lanes_ph_") as tmp:
        write_split(tmp, ph_lengths, K, seed + 21, PHASED_H, PHASED_W)
        ph_files = stream_files(tmp, phased_model, "on", PHASED, "lanes_phased")
        runs = {}
        for name, extra, steps in (
                ("single", (), sum(ph_lengths)),
                ("lanes", ph_lane_args, lane_steps(ph_lengths, PHASED_LANES)),
                ("chunked_single", chunk_args, ph_chunk1),
                ("chunked_lanes", ph_lane_args + chunk_args, ph_chunk)):
            runs[name] = lane_run(ph_files, tmp, lstm_counters,
                                  [3 * (K + 1) * steps] * 2, ph_lengths,
                                  crop_ph, extra, f"phased {name}")
    out["phased"] = {
        "k3_k4_launches": {n: r[1] for n, r in runs.items()},
        "per_package_max_abs_err_vs_single_lane": max_pred_diff(
            runs["lanes"][0], runs["single"][0]),
        "chunked_max_abs_err_vs_single_lane": max_pred_diff(
            runs["chunked_lanes"][0], runs["chunked_single"][0]),
        "wall_s": {n: r[2] for n, r in runs.items()}}
    errs = {"chunked": out["chunked"]["max_abs_err_vs_single_lane"],
            "pair": out["chunked"]["pair_max_abs_err_vs_single_lane"],
            "per_package": out["per_package"]["max_abs_err_vs_single_lane"],
            "phased": out["phased"]["per_package_max_abs_err_vs_single_lane"],
            "phased_chunked": out["phased"]["chunked_max_abs_err_vs_single_lane"]}
    if not all(e <= SLICE_TOL for e in errs.values()):
        raise AssertionError(f"lanes vs single lane: {errs} > {SLICE_TOL}")

    # (f) lane maps/s beside the single lane's
    on_model = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="on"),
                                   device=dev)
    on_model.load_state_dict(model.state_dict())
    timing = lane_maps_per_s({"auto": model, "on": on_model}, K, seed)
    timing["forward_ms"] = lane_forward_ms({"auto": model, "on": on_model}, K,
                                           dev, seed)
    check_no_jax()
    emit({"phase": "lanes", "config": CONFIG, "H": H, "W": W, "K": K,
          "lanes": LANES, "chunk": LANE_CHUNK,
          "sequences": list(LANE_SEQ_LENGTHS),
          "steps": {"chunked": n_chunked, "per_package": n_lane_pkg},
          "phased": {"H": PHASED_H, "W": PHASED_W, "lanes": PHASED_LANES,
                     "sequences": list(ph_lengths), **out.pop("phased")},
          "tol": SLICE_TOL, "data_write_s": data_s, **out,
          "maps_per_s": timing, "nvidia_smi": smi})
    return {"kernels": krows, "k1": c_lanes[0], "k5": c_ppl[0],
            "k9": c_pair[0], "k3_k4": runs["chunked_lanes"][1]}


def baseline_raw(name, tmp, **trainer):
    """A baseline config file's dict as shipped, with the run directory in
    tmp, the splits 'train'/'val' (step_size 1), batch BASELINE_TRAIN_B
    and crop TRAIN_CROP, no previews, and the trainer keys given."""
    with open(os.path.join(ROOT, BASELINE_CONFIGS[name])) as f:
        raw = json.load(f)
    raw["name"] = f"smoke_baseline_{name}"
    raw["trainer"].update(save_dir=os.path.join(tmp, "runs"),
                          still_previews=False, movie=False, **trainer)
    raw["data_loader"].update(batch_size=BASELINE_TRAIN_B,
                              crop_size=TRAIN_CROP)
    for split, folder in (("train", "train"), ("validation", "val")):
        raw["data_loader"][split].update(base_folder=folder, step_size=1)
    return raw


def raw_event_files(root):
    """Copy every sequence's raw event files (events/data/*_events.npy)
    into events/voxels, the folder the baseline configs name: the
    no_recurrent recipe reads them there (RawEventsDataset)."""
    import glob
    import shutil
    for src in glob.glob(os.path.join(root, "**", "events", "data",
                                      "*_events.npy"), recursive=True):
        shutil.copy(src, src.replace(os.path.join("events", "data"),
                                     os.path.join("events", "voxels")))


def baseline_phases(dev, seed, smi):
    """Phase 22: the four baseline recipes through the eval entry point per
    package at HxW on an on-disk split of BASELINE_SEQ_LENGTHS packages
    (finite maps in [0, 1] under the keys prediction_keys names), the
    no_recurrent recipe also with --scan_chunk BASELINE_CHUNK against its
    per-package run; the ergb0 recipe in bf16 with fused_decoder 'on' (K8,
    three launches per decode pass) against 'off'; TBPTT training through
    the training entry point for the BASELINE_TRAINED recipes (as shipped:
    the in-scan decode path, and raw events for no_recurrent).  One JSON
    line per part; returns what the kernels line reads."""
    import torch
    from rpg_ramnet_tpu_torch.core.config import Config
    from rpg_ramnet_tpu_torch.models import build_model, prediction_keys
    from rpg_ramnet_tpu_torch.ops import upsample_conv
    from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar
    t_phase = time.perf_counter()
    n_pkg = sum(BASELINE_SEQ_LENGTHS)
    out = {}
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_baselines_") as tmp:
        t0 = time.perf_counter()
        K = Config.load(os.path.join(
            ROOT, BASELINE_CONFIGS["ergb0"])).model.every_x_rgb_frame
        write_split(tmp, BASELINE_SEQ_LENGTHS, K, seed + 22, H, W)
        raw_event_files(tmp)
        data_s = time.perf_counter() - t0

        def files(name, model_over=None, tag=""):
            raw = baseline_raw(name, tmp)
            raw["model"].update(model_over or {})
            cfg = Config.from_dict(raw)
            model = build_model(cfg, device=dev,
                                generator=torch.Generator().manual_seed(seed))
            cfg_path = os.path.join(tmp, f"{name}{tag}.json")
            with open(cfg_path, "w") as f:
                json.dump(raw, f)
            ckpt = os.path.join(tmp, f"{name}{tag}.pth.tar")
            export_pth_tar(ckpt, model, raw["arch"], raw)
            return cfg, cfg_path, ckpt

        runs = {}
        for name in BASELINE_CONFIGS:
            cfg, cfg_path, ckpt = files(name)
            preds, _, wall, stats = run_eval_entry(
                cfg_path, ckpt, tmp, [upsample_conv.upsample_conv_fused])
            keys = ({"image"} if cfg.arch == "ERGB2Depth"
                    else set(prediction_keys(cfg.model)))
            shapes = {v.shape for p in preds.values() for v in p.values()}
            runs[name] = {"arch": cfg.arch, "baseline": cfg.model.baseline,
                          "items": len(preds), "keys": sorted(keys),
                          "eval_entry_wall_s": wall, **stats}
            if (len(preds) != n_pkg or stats["nonfinite"]
                    or stats["out_of_range"] or shapes != {(H, W, 1)}
                    or any(set(p) != keys for p in preds.values())):
                raise AssertionError(f"baseline {name}: {runs[name]}, "
                                     f"shapes {shapes}")
            if name == "no_recurrent":
                chunked, _, cwall, cstats = run_eval_entry(
                    cfg_path, ckpt, tmp, [upsample_conv.upsample_conv_fused],
                    extra=("--scan_chunk", str(BASELINE_CHUNK)))
                err = max_pred_diff(chunked, preds)
                runs[name].update(chunked_items=len(chunked),
                                  chunked_wall_s=cwall,
                                  chunked_max_abs_err_vs_per_package=err,
                                  chunked_tol=BASELINE_CHUNK_TOL)
                if len(chunked) != n_pkg or not err <= BASELINE_CHUNK_TOL:
                    raise AssertionError(f"no_recurrent chunked: {runs[name]}")
        check_no_jax()
        emit({"phase": "baselines", "H": H, "W": W, "K": K,
              "sequences": list(BASELINE_SEQ_LENGTHS),
              "configs": BASELINE_CONFIGS, "dtype": "float32",
              "runs": runs, "data_write_s": data_s, "nvidia_smi": smi})

        # K8 on the ergb0 recipe's decoder in bf16, 'on' against 'off'
        n_dec = 3 * n_pkg          # one decode pass per package, 3 layers
        k8 = {}
        for mode in ("on", "off"):
            _, cfg_path, ckpt = files("ergb0", {"compute_dtype": "bfloat16",
                                                "fused_decoder": mode},
                                      f"_bf16_{mode}")
            k8[mode] = run_eval_entry(cfg_path, ckpt, tmp,
                                      [upsample_conv.upsample_conv_fused])
        launches = k8["on"][1][0]
        err = max_pred_diff(k8["on"][0], k8["off"][0])
        out["k8"] = {"launches": launches, "expected": n_dec,
                     "off_launches": k8["off"][1][0],
                     "max_abs_err_vs_off": err, "tol": SLICE_TOL,
                     "items": len(k8["on"][0]),
                     "eval_entry_wall_s_on_off": [k8["on"][2], k8["off"][2]],
                     **k8["on"][3]}
        if (launches != n_dec or k8["off"][1][0] or not err <= SLICE_TOL
                or k8["on"][3]["nonfinite"] or k8["on"][3]["out_of_range"]):
            raise AssertionError(f"ergb0 with K8: {out['k8']}")
        emit({"phase": "baselines_k8", "config": BASELINE_CONFIGS["ergb0"],
              "compute_dtype": "bfloat16", **out["k8"], "nvidia_smi": smi})

    # training through the entry point, the recipes as shipped
    trained = {}
    for name in BASELINE_TRAINED:
        with tempfile.TemporaryDirectory(prefix="ramnet_smoke_btrain_") as tmp:
            t0 = time.perf_counter()
            write_train_data(os.path.join(tmp, "data"), K, seed + 23,
                             batch=BASELINE_TRAIN_B)
            raw_event_files(os.path.join(tmp, "data"))
            data_s = time.perf_counter() - t0
            raw = baseline_raw(name, tmp, epochs=1, save_freq=1, log_every=1,
                               sequence_length=TRAIN_L)
            trained[name] = {"arch": raw["arch"], "data_write_s": data_s,
                             **run_training(raw, tmp, {
                                 "k8": (upsample_conv.upsample_conv_fused, 0)})}
    check_no_jax()
    emit({"phase": "baselines_train", "B": BASELINE_TRAIN_B, "L": TRAIN_L,
          "crop": TRAIN_CROP, "steps": TRAIN_STEPS, "dtype": "float32",
          "runs": trained, "nvidia_smi": smi})
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "baselines_done", "phase_s": out["phase_s"],
          "nvidia_smi": smi})
    return out


class TagRecorder:
    """A TensorBoard writer that records what the trainer writes: the tags
    by kind, each payload checked (finite scalars, images and histogram
    values; movies GIF-encoded)."""

    def __init__(self):
        self.tags = {"scalars": set(), "images": set(), "histograms": set()}
        self.bad = []

    def _record(self, kind, tag, value=None):
        import numpy as np
        self.tags[kind].add(tag)
        if value is not None and not np.isfinite(
                np.asarray(value, dtype=np.float64)).all():
            self.bad.append(tag)

    def add_scalar(self, tag, value, step):
        self._record("scalars", tag, value)

    def add_image(self, tag, img, step, **kw):
        self._record("images", tag, img)

    def add_histogram(self, tag, values, step, **kw):
        self._record("histograms", tag, values)

    def add_figure(self, tag, figure, global_step=None, **kw):
        import matplotlib.pyplot as plt
        plt.close(figure)
        self._record("images", tag)

    def _get_file_writer(self):
        return self

    def add_summary(self, summary, step):
        for v in summary.value:
            self._record("images", v.tag)
            if v.image.encoded_image_string[:6] != b"GIF89a":
                self.bad.append(v.tag)

    def flush(self):
        pass


def expected_trainer_tags(trainer, log, have):
    """The tags the JAX trainer writes for trainer's config in one epoch
    (trainer.py:166-339), given which of tensorboard, PIL and matplotlib
    import (have): movies need the first two, the gradient-flow figure
    the third."""
    from rpg_ramnet_tpu_torch.models import prediction_keys
    from rpg_ramnet_tpu_torch.utils.training_utils import strip_arch_prefix
    cfg = trainer.cfg
    keys = prediction_keys(cfg.model)
    K = cfg.model.every_x_rgb_frame
    scalars = {k for k, v in log.items() if isinstance(v, (int, float))}
    images = {f"state_change_{k}"
              for k in [f"events{k}" for k in range(K)] + ["image"]}
    for prefix, n in (("preview_", cfg.trainer.num_previews),
                      ("val_preview_", cfg.trainer.num_val_previews)):
        scalars |= {f"{prefix}metric_{m}" for m in cfg.metrics}
        images |= {f"{prefix}{i}_{k}__input_pred_gt"
                   for i in range(n) for k in keys}
        if have["PIL"] and have["tensorboard"]:
            images |= {f"movie_{i}__{k}__prediction__groundtruth"
                       for i in range(n) for k in keys}
    if have["matplotlib"]:
        images.add("grad_figure")
    histograms = {f"{strip_arch_prefix(n)}/{kind}"
                  for n, _ in trainer.model.named_parameters()
                  for kind in ("weights", "grad")}
    return {"scalars": scalars, "images": images, "histograms": histograms}


def micro_kernel_check(dev, gen):
    """K1-res (h', acts: max abs error) and K2 (dh, dgx: max abs error over
    the plain version's max magnitude) against their plain versions at
    the micro-batch shapes, under the planners' picks."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    rows = []
    for shape in MICRO_TRAIN_CELLS:
        _, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen)
        g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        got_h, got_acts = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o)
        want_h, want_acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
        dh, dgx = gru_hside.conv_gru_hside_bwd(g, h, want_acts, w_ur, w_o)
        want_dh, want_dgx = gru_hside.conv_gru_hside_bwd_plain(
            g, h, want_acts, w_ur, w_o)
        torch.cuda.synchronize()
        row = {"shape": list(shape),
               "res_h_err": (got_h.float() - want_h.float()).abs().max().item(),
               "res_acts_err": (got_acts.float() - want_acts.float()).abs().max().item(),
               "bwd_dh_rel": rel_err(dh, want_dh),
               "bwd_dgx_rel": rel_err(dgx, want_dgx)}
        rows.append(row)
        if not (max(row["res_h_err"], row["res_acts_err"]) <= K1_TOL
                and max(row["bwd_dh_rel"], row["bwd_dgx_rel"]) <= GRAD_TOL):
            raise AssertionError(f"K1-res / K2 vs plain at {shape}: {row}")
    return rows


def time_policy_runs(cfg, model, batch, steps=2, rounds=4):
    """Peak memory and training sequences/s of make_train_step on one
    window batch per (remat_policy, grad_accum) of TRAINER_RUNS: one
    warm-up step each, then ``rounds`` rounds of ``steps`` timed steps
    per run, the runs in turn, in reverse order every other round.  Per
    run the median seq/s over the rounds and their range, the peak over
    its steps and what a step adds to the memory allocated before it.
    The policies run the same program (the port recomputes each package
    whole whatever remat_policy says), so the runs that share grad_accum
    measure the spread of identical programs ('same_program_spread':
    the largest median over the smallest, less 1)."""
    import statistics

    import torch
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_train_step
    steps_of, walls, peaks, extras = {}, {}, {}, {}
    for policy, accum in TRAINER_RUNS:
        c = dataclasses.replace(cfg, trainer=dataclasses.replace(
            cfg.trainer, remat_policy=policy, grad_accum=accum))
        key = f"{policy}/accum{accum}"
        steps_of[key] = make_train_step(c, model,
                                        make_optimizer(c, model.parameters()))
        steps_of[key](batch)
        walls[key], peaks[key], extras[key] = [], 0, 0
    torch.cuda.synchronize()
    order = list(steps_of)
    for r in range(rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(steps):
                aux = steps_of[key](batch)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
            if not math.isfinite(aux["loss"]):
                raise AssertionError(f"non-finite loss ({key}): {aux}")
            peak = torch.cuda.max_memory_allocated()
            peaks[key] = max(peaks[key], peak)
            extras[key] = max(extras[key], peak - base)
    model.zero_grad(set_to_none=True)
    seqs = batch["image"].shape[0] * steps
    out = {}
    for key in order:
        rates = [seqs / w for w in walls[key]]
        out[key] = {"seq_per_s": statistics.median(rates),
                    "seq_per_s_min": min(rates), "seq_per_s_max": max(rates),
                    "rounds": rounds, "steps": steps,
                    "peak_gib": peaks[key] / 2 ** 30,
                    "step_extra_gib": extras[key] / 2 ** 30}
    spread = {}
    for accum in sorted({a for _, a in TRAINER_RUNS}):
        med = [out[f"{p}/accum{a}"]["seq_per_s"] for p, a in TRAINER_RUNS
               if a == accum]
        spread[f"accum{accum}"] = max(med) / min(med) - 1
    out["same_program_spread"] = spread
    return out


def trainer_phases(dev, gen, seed, smi, train_cells):
    """Phase 23: K1-res and K2 at the micro-batch shapes against their
    plain versions, their plans and device us beside B=16's (train_cells,
    phase 7); the flagship's first step under grad_accum 2 and 'gru_gx'
    against 'off'; the training entry point for TRAINER_EPOCHS epochs
    with the shipped preview settings and state previews, a recording
    writer, async checkpoints, and a run resumed from its first
    checkpoint; peak memory and seq/s per (remat_policy, grad_accum);
    remat_chunk 2 on the ergb0 baseline through the entry point.  One JSON
    line per part; returns what the kernels line reads."""
    import warnings

    import torch
    from rpg_ramnet_tpu_torch.core.config import Config
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.train.trainer import importable
    t_phase = time.perf_counter()

    # 23a. the h-side training kernels at micro-batch 8
    rows = micro_kernel_check(dev, gen)
    b16 = {tuple(r["shape"][1:]): r for r in train_cells}
    for row, t in zip(rows, time_train_cells(dev, gen,
                                             shapes=MICRO_TRAIN_CELLS)):
        ref = b16[tuple(row["shape"][1:])]
        for kind, rep in (("res", "res_k1"), ("bwd", "bwd_k2")):
            ratio = t[f"{kind}_kernel_us"] / ref[f"{kind}_kernel_us"]
            row[kind] = {"plan": t[rep]["plan"], "plan_b16": ref[rep]["plan"],
                         "kernel_us": t[f"{kind}_kernel_us"],
                         "plain_us": t[f"{kind}_plain_us"],
                         "kernel_us_b16": ref[f"{kind}_kernel_us"],
                         "b8_over_b16": ratio,
                         "pick_off": ratio > PLAN_OFF_RATIO,
                         "device_us_profiler": t[rep]["device_us"],
                         "wrapper_us": t[rep]["wrapper_us"]}
    emit({"phase": "kernel_train_micro", "k1_tol": K1_TOL,
          "grad_tol": GRAD_TOL, "off_ratio": PLAN_OFF_RATIO, "cells": rows,
          "nvidia_smi": smi})

    K = Config.load(os.path.join(ROOT, CONFIG)).model.every_x_rgb_frame
    n_cells = 3 * (K + 1) * TRAIN_L
    with open(os.path.join(ROOT, CONFIG)) as f:
        shipped = json.load(f)["trainer"]
    have = {m: importable(m) for m in ("tensorboard", "PIL", "matplotlib")}
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_trainer_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_train_data(data, K, seed + 30, batch=TRAIN_B)
        data_s = time.perf_counter() - t0
        raw = train_config(tmp)
        raw["name"] = "smoke_trainer"
        raw["trainer"].pop("movie")          # the shipped default, True
        raw["trainer"].update(
            still_previews=shipped["still_previews"], state_preview=True,
            epochs=TRAINER_EPOCHS, grad_accum=TRAINER_ACCUM,
            remat_policy=TRAINER_POLICY, async_checkpoint=True)
        cfg = Config.from_dict(raw)

        # 23b. the first step under grad_accum and the policy, vs 'off':
        #      per micro-batch K1-res twice per cell (the recompute), K2 once
        batch, models, first = first_step_vs_off(
            cfg, data, dev, seed,
            {"k1_res": (gru_hside.conv_gru_hside_res,
                        2 * TRAINER_ACCUM * n_cells),
             "k2": (gru_hside.conv_gru_hside_bwd, TRAINER_ACCUM * n_cells)},
            step_grads=True)
        del models["off"]
        torch.cuda.empty_cache()
        emit({"phase": "trainer_first_step", "config": CONFIG,
              "grad_accum": TRAINER_ACCUM, "remat_policy": TRAINER_POLICY,
              "first_step_vs_off": first, "nvidia_smi": smi})

        # 23c. the entry point, straight and resumed at epoch 1, with
        #      deterministic library algorithms where there are any; an
        #      epoch: TRAIN_STEPS steps and the histograms' backward (each
        #      in TRAINER_ACCUM micro-batches, remat'd), one validation
        #      batch (K1)
        per_epoch = {
            "k1_res": 2 * n_cells * TRAINER_ACCUM * (TRAIN_STEPS + 1),
            "k2": n_cells * TRAINER_ACCUM * (TRAIN_STEPS + 1),
            "k1_validation": n_cells}
        wrappers = {"k1_res": gru_hside.conv_gru_hside_res,
                    "k2": gru_hside.conv_gru_hside_bwd,
                    "k1_validation": gru_hside.conv_gru_hside}
        deterministic = (torch.backends.cudnn.deterministic,
                         torch.backends.cudnn.benchmark,
                         torch.are_deterministic_algorithms_enabled(),
                         torch.is_deterministic_algorithms_warn_only_enabled())
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        recorders, trainers, runs = {}, [], {}
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for name, epochs, resume in (
                        ("straight", TRAINER_EPOCHS, None),
                        ("resumed", TRAINER_EPOCHS - 1, os.path.join(
                            tmp, "runs", "smoke_trainer", "checkpoint-epoch0"))):
                    run_raw = {**raw, "name": f"smoke_trainer_{name}"
                               if resume else raw["name"]}
                    recorders[name] = TagRecorder()
                    runs[name] = run_training(
                        run_raw, tmp, {k: (w, n * epochs) for k, (w, n) in
                                       ((k, (wrappers[k], per_epoch[k]))
                                        for k in per_epoch)},
                        writer=recorders[name], resume=resume, keep=trainers)
        finally:
            torch.backends.cudnn.deterministic = deterministic[0]
            torch.backends.cudnn.benchmark = deterministic[1]
            torch.use_deterministic_algorithms(deterministic[2],
                                               warn_only=deterministic[3])
            torch.utils.deterministic.fill_uninitialized_memory = fill
        alerts = sorted({str(w.message).split(".")[0] for w in caught
                         if "deterministic" in str(w.message)})
        straight, resumed = trainers
        for t in trainers:
            if t.preview_errors:
                raise AssertionError(f"previews failed: {t.preview_errors}")
        tags = {}
        for name, t in zip(("straight", "resumed"), trainers):
            want = expected_trainer_tags(t, t.jsonl.entries[0], have)
            got = recorders[name].tags
            tags[name] = {k: len(v) for k, v in got.items()}
            if got != want or recorders[name].bad:
                raise AssertionError(
                    f"{name} run's TensorBoard tags: missing "
                    f"{ {k: sorted(want[k] - got[k])[:5] for k in want} }, "
                    f"extra { {k: sorted(got[k] - want[k])[:5] for k in want} }, "
                    f"bad payloads {recorders[name].bad[:5]}")
        metas = {}
        for t in trainers:
            for e in sorted(os.listdir(t.run_dir)):
                if e.startswith(("checkpoint-", "model_best")):
                    with open(os.path.join(t.run_dir, e, "meta.json")) as f:
                        m = json.load(f)
                    metas[f"{t.cfg.name}/{e}"] = [m["epoch"], m["monitor_best"]]
        diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(
            straight.model.state_dict().values(),
            resumed.model.state_dict().values())]
        lr = float(cfg.optimizer["lr"])
        resume_check = {
            "max_abs_diff": max(diffs), "bitwise": max(diffs) == 0.0,
            "nondeterministic_alerts": alerts,
            "adam_bound": 2 * lr * TRAIN_STEPS,
            "straight_epoch1_train_loss": straight.jsonl.entries[1]["train_loss"],
            "resumed_epoch1_train_loss": resumed.jsonl.entries[0]["train_loss"]}
        # bitwise where every algorithm ran deterministically; otherwise
        # (atomics in a library backward) Adam's bound for noise gradients
        if (resume_check["max_abs_diff"] > 0.0 if not alerts
                else resume_check["max_abs_diff"] > resume_check["adam_bound"]):
            raise AssertionError(f"resumed run vs straight: {resume_check}")
        if metas.get("smoke_trainer/checkpoint-epoch0", [0, 0])[1] != float("inf"):
            raise AssertionError(f"checkpoint-epoch0's monitor_best: {metas}")
        check_no_jax()
        emit({"phase": "trainer", "config": CONFIG, "B": TRAIN_B, "L": TRAIN_L,
              "crop": TRAIN_CROP, "K": K, "epochs": TRAINER_EPOCHS,
              "steps_per_epoch": TRAIN_STEPS, "grad_accum": TRAINER_ACCUM,
              "remat_policy": TRAINER_POLICY, "async_checkpoint": True,
              "state_preview": True, "imported": have, "tag_counts": tags,
              "data_write_s": data_s, "runs": runs, "resume": resume_check,
              "checkpoint_monitor_best": metas, "nvidia_smi": smi})
        del straight, resumed, trainers, recorders
        torch.cuda.empty_cache()

        # 23d. peak memory and seq/s per checkpoint policy and accumulation
        policies = time_policy_runs(cfg, models[cfg.model.fused_gru], batch)
        del models, batch
        torch.cuda.empty_cache()
        emit({"phase": "trainer_memory", "B": TRAIN_B, "L": TRAIN_L,
              "crop": TRAIN_CROP, "runs": policies, "nvidia_smi": smi})

    # 23e. remat_chunk 2 on the ergb0 baseline (the in-scan decode path)
    chunked = {}
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_rchunk_") as tmp:
        write_train_data(os.path.join(tmp, "data"), K, seed + 31,
                         batch=BASELINE_TRAIN_B)
        for rc in (1, 2):
            braw = baseline_raw("ergb0", tmp, epochs=1, save_freq=1,
                                log_every=1, sequence_length=TRAIN_L,
                                remat_chunk=rc)
            braw["name"] += f"_rc{rc}"
            chunked[rc] = run_training(braw, tmp, {}, writer=TagRecorder())
    rel = abs(chunked[2]["train_loss"] - chunked[1]["train_loss"]) / abs(
        chunked[1]["train_loss"])
    if not (math.isfinite(chunked[2]["train_loss"]) and rel <= REMAT_CHUNK_TOL):
        raise AssertionError(f"ergb0 remat_chunk 2 vs 1: {rel}, {chunked}")
    check_no_jax()
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "trainer_remat_chunk", "config": BASELINE_CONFIGS["ergb0"],
          "B": BASELINE_TRAIN_B, "L": TRAIN_L, "steps": TRAIN_STEPS,
          "runs": {f"remat_chunk{rc}": r for rc, r in chunked.items()},
          "loss_rel_diff": rel, "tol": REMAT_CHUNK_TOL, "phase_s": phase_s,
          "nvidia_smi": smi})
    return {"rows": rows, "launches": runs["straight"]["launches"],
            "phase_s": phase_s}


def perturb_norm_stats(model, seed):
    """The norms' running stats set to seeded values off torch's init
    (mean in [-0.25, 0.25), var in [0.5, 1.5)), so the eval-mode norms
    move the maps."""
    import torch
    from rpg_ramnet_tpu_torch.models.layers import extract_norm_stats
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for s in extract_norm_stats(model).values():
            for name, lo in (("running_mean", -0.25), ("running_var", 0.5)):
                t = s[name]
                t.copy_(lo + torch.rand(t.shape, generator=g).to(t.device)
                        * (0.5 if lo < 0 else 1.0))


def stats_rel_diff(a, b):
    """Max abs difference of two norm-stats dicts over the largest
    magnitude in the second."""
    diff = max(float((a[k][n] - b[k][n]).abs().max()) for k in b for n in b[k])
    scale = max(float(b[k][n].abs().max()) for k in b for n in b[k])
    return diff / scale


def zoo_phases(dev, seed, smi):
    """Phase 24: the model zoo's options at the flagship width (bf16, base
    32, 3 encoders, 2 residual blocks, K=5), each config the flagship
    JSON with the ZOO overrides.  Through the eval entry point on an
    on-disk split of ZOO_SEQ_LENGTHS packages at HxW: (a) BN + concat +
    transposed-conv decoders chunked (K1) and per package with
    fused_gru='on' (K5), each against 'off'; (b) IN + ConvLSTM encoders +
    no_skip per package with fused_gru and fused_decoder 'on' (K5; no K8:
    the norm gates it off) against 'off', and its norm-free twin with K8
    taking skip=None on every layer; (e) the 'conv' and 'sum' state
    combinations per package.  Training: (c) norm-free concat +
    fast-upsample, the first step with precompute_x (K1-res, K2) against
    'off'; (d) BN, two steps with remat on and off, then the training
    entry point for one epoch, resumed for a second from its checkpoint.
    Every map finite in [0, 1] of shape (H, W, 1).  One JSON line per
    part; returns the launches the kernels line adds."""
    import torch
    from rpg_ramnet_tpu_torch.core.config import Config
    from rpg_ramnet_tpu_torch.data import BatchLoader, concatenate_subfolders
    from rpg_ramnet_tpu_torch.data.loader import device_prefetch
    from rpg_ramnet_tpu_torch.models import build_model
    from rpg_ramnet_tpu_torch.models.layers import extract_norm_stats
    from rpg_ramnet_tpu_torch.ops import gru_hside, upsample_conv
    from rpg_ramnet_tpu_torch.train import checkpoint
    from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_train_step
    t_phase = time.perf_counter()
    k1, k5 = gru_hside.conv_gru_hside, gru_hside.conv_gru_full
    k8 = upsample_conv.upsample_conv_fused
    K = Config.load(os.path.join(ROOT, CONFIG)).model.every_x_rgb_frame
    n_pkg = sum(ZOO_SEQ_LENGTHS)
    padded = sum(-(-n // ZOO_CHUNK) * ZOO_CHUNK for n in ZOO_SEQ_LENGTHS)
    launches = {"k1": 0, "k5": 0, "k8": 0, "k1_res": 0, "k2": 0}
    rows = {}
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_zoo_") as tmp:
        write_split(tmp, ZOO_SEQ_LENGTHS, K, seed + 24, H, W)

        def run(case, counters, extra=(), **model_over):
            """The case's config (and model_over) with seeded weights and
            norm stats through the eval entry point; the maps checked."""
            raw = raw_config({**ZOO[case], **model_over})
            raw["name"] = f"smoke_zoo_{case}"
            model = build_model(Config.from_dict(raw), device=dev,
                                generator=torch.Generator().manual_seed(seed))
            perturb_norm_stats(model, seed)
            tag = "_".join([case, *map(str, model_over.values())])
            cfg_path = os.path.join(tmp, f"zoo_{tag}.json")
            ckpt = os.path.join(tmp, f"zoo_{tag}.pth.tar")
            with open(cfg_path, "w") as f:
                json.dump(raw, f)
            export_pth_tar(ckpt, model, raw["arch"], raw)
            preds, counts, wall, stats = run_eval_entry(
                cfg_path, ckpt, tmp, counters, extra=extra)
            shapes = {v.shape for p in preds.values() for v in p.values()}
            if (len(preds) != n_pkg or stats["nonfinite"]
                    or stats["out_of_range"] or shapes != {(H, W, 1)}):
                raise AssertionError(f"zoo {tag}: {len(preds)} items, "
                                     f"{stats}, shapes {shapes}")
            return preds, counts, wall

        def versus_off(case, kernel, counters, want, extra=(), **on):
            """The case with the kernels (``on``) and with fused_gru and
            fused_decoder 'off': launches per counter, max |dmap|."""
            p_on, n_on, w_on = run(case, counters, extra, **on)
            p_off, n_off, w_off = run(case, counters, extra, fused_gru="off",
                                      fused_decoder="off")
            err = max_pred_diff(p_on, p_off)
            row = {"kernel": kernel, "launches": n_on, "expected": want,
                   "off_launches": n_off, "max_abs_err_vs_off": err,
                   "tol": SLICE_TOL, "overrides": {**ZOO[case], **on},
                   "eval_entry_wall_s_on_off": [w_on, w_off]}
            if n_on != want or any(n_off) or not err <= SLICE_TOL:
                raise AssertionError(f"zoo {case} {kernel}: {row}")
            return row

        # (a) chunked with x precompute: K1 on every h-side cell
        rows["a_chunked_k1"] = versus_off(
            "a", "k1", [k1], [3 * (K + 1) * padded],
            ("--scan_chunk", str(ZOO_CHUNK)))
        # (a) per package, fused_gru='on': K5 on every cell
        rows["a_per_package_k5"] = versus_off(
            "a", "k5", [k5], [3 * (K + 1) * n_pkg], fused_gru="on")
        # (b) ConvLSTM encoders (plain cells) and the K5 combination; the
        # norm keeps K8 off whatever fused_decoder says
        rows["b_per_package_k5"] = versus_off(
            "b", "k5", [k5, k8], [3 * (K + 1) * n_pkg, 0], fused_gru="on")
        # (b) norm-free: K8 on each of the 3 layers of a package's decode
        # pass, no skip on any.  The spy stands in for the wrapper under
        # its module name, so the wrapper counts its launches on the spy
        skips = []

        def spy(layer, x, skip=None, *args, **kw):
            skips.append(skip is None)
            return k8(layer, x, skip, *args, **kw)

        spy.launches = 0
        upsample_conv.upsample_conv_fused = spy
        try:
            rows["b_norm_free_k8"] = versus_off(
                "b_norm_free", "k8", [k5, spy],
                [3 * (K + 1) * n_pkg, 3 * n_pkg], fused_gru="on")
        finally:
            upsample_conv.upsample_conv_fused = k8
        rows["b_norm_free_k8"]["k8_calls_without_skip"] = sum(skips)
        if len(skips) != 3 * n_pkg or not all(skips):
            raise AssertionError(f"K8 took a skip under no_skip: {skips}")
        # (e) the parameter-free and the conv state combinations
        for case in ("conv", "sum"):
            _, _, wall = run(case, [k1])
            rows[f"e_{case}"] = {"items": n_pkg, "eval_entry_wall_s": wall}
        launches["k1"] += rows["a_chunked_k1"]["launches"][0]
        launches["k5"] += sum(rows[r]["launches"][0] for r in
                              ("a_per_package_k5", "b_per_package_k5",
                               "b_norm_free_k8"))
        launches["k8"] += rows["b_norm_free_k8"]["launches"][1]
        check_no_jax()
        emit({"phase": "zoo", "config": CONFIG, "H": H, "W": W, "K": K,
              "sequences": list(ZOO_SEQ_LENGTHS), "chunk": ZOO_CHUNK,
              "dtype": "bfloat16", "runs": rows, "nvidia_smi": smi})

    # training: the data at the crop, B = ZOO_TRAIN_B windows per step
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_zoo_train_") as tmp:
        root = os.path.join(tmp, "data")
        write_train_data(root, K, seed + 25, batch=ZOO_TRAIN_B)

        def train_raw(case, **trainer):
            raw = train_config(tmp)
            raw["name"] = f"smoke_zoo_{case}"
            raw["model"].update(ZOO[case])
            raw["data_loader"]["batch_size"] = ZOO_TRAIN_B
            raw["trainer"].update(trainer)
            return raw

        # (c) the first step with precompute_x: K1-res twice per h-side
        # cell (the checkpoint's recompute), K2 once
        n_cells = 3 * (K + 1) * TRAIN_L
        _, _, first = first_step_vs_off(
            Config.from_dict(train_raw("c")), root, dev, seed,
            {"k1_res": (gru_hside.conv_gru_hside_res, 2 * n_cells),
             "k2": (gru_hside.conv_gru_hside_bwd, n_cells)})
        launches["k1_res"] += first["launches"]["k1_res"]
        launches["k2"] += first["launches"]["k2"]

        # (d) BN: the in-scan path, two steps with remat on and off
        raw = train_raw("d", precompute_x=False, deferred_decode=False)
        cfg = Config.from_dict(raw)
        split = cfg.train_data
        ds = concatenate_subfolders(
            os.path.join(root, "train"), split.type, split.event_folder,
            split.depth_folder, split.frame_folder, TRAIN_L, step_size=1,
            clip_distance=split.clip_distance,
            every_x_rgb_frame=split.every_x_rgb_frame,
            reg_factor=split.reg_factor)
        batches = list(device_prefetch(
            BatchLoader(ds, ZOO_TRAIN_B, shuffle=False), dev))[:TRAIN_STEPS]
        # each step of the remat'd model and the other one from the same
        # parameters and stats: the backward's atomics (the bilinear
        # resize's among them) let independently trained twins drift
        # apart in the parameters, which moved step 2's stats by 1.7e-3 on
        # an H100, whereas a doubled update moves them by the momentum's
        # order (1e-1)
        models = {r: build_model(cfg, device=dev,
                                 generator=torch.Generator().manual_seed(seed))
                  for r in (True, False)}
        steps = {r: make_train_step(cfg, m, make_optimizer(cfg, m.parameters()),
                                    remat=r) for r, m in models.items()}
        diffs, losses, walls = [], {True: [], False: []}, {True: 0.0, False: 0.0}
        for b in batches:
            models[False].load_state_dict(models[True].state_dict())
            for remat in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses[remat].append(steps[remat](b)["loss"])
                torch.cuda.synchronize()
                walls[remat] += time.perf_counter() - t0
            diffs.append(stats_rel_diff(
                *(extract_norm_stats(models[r]) for r in (True, False))))
        final = extract_norm_stats(models[True])
        moved = stats_rel_diff(final, {
            k: {"running_mean": torch.zeros_like(s["running_mean"]),
                "running_var": torch.ones_like(s["running_var"])}
            for k, s in final.items()})
        d_row = {"B": ZOO_TRAIN_B, "L": TRAIN_L, "crop": TRAIN_CROP,
                 "steps": len(batches), "norms": len(final),
                 "stats_rel_diff_remat_vs_not_per_step": diffs,
                 "tol": ZOO_STATS_TOL, "stats_moved_from_init": moved,
                 "loss_remat": losses[True], "loss_no_remat": losses[False],
                 "wall_s_remat_no_remat": [walls[True], walls[False]]}
        del models, steps
        if (len(batches) != TRAIN_STEPS or not max(diffs) <= ZOO_STATS_TOL
                or not moved > 0
                or not all(math.isfinite(v) for v in losses[True] + losses[False])):
            raise AssertionError(f"zoo BN training: {d_row}")
        # the entry point: an epoch, then resumed for a second from its
        # checkpoint, whose buffers a fresh model restores bit for bit
        kept = []
        trained = run_training(train_raw("d", precompute_x=False),
                               tmp, {}, keep=kept)
        ckpt = os.path.join(kept[0].run_dir, "checkpoint-epoch0")
        fresh = build_model(cfg, device=dev,
                            generator=torch.Generator().manual_seed(seed + 1))
        checkpoint.restore(ckpt, fresh)
        buffers = dict(kept[0].model.named_buffers())
        if not buffers or not all(torch.equal(v, buffers[k])
                                  for k, v in fresh.named_buffers()):
            raise AssertionError("zoo BN: the checkpoint's buffers differ")
        resumed = run_training(train_raw("d", precompute_x=False, epochs=2),
                               tmp, {}, resume=ckpt)
        check_no_jax()
        emit({"phase": "zoo_train", "config": CONFIG,
              "c_first_step_vs_off": {**first, "overrides": ZOO["c"]},
              "d_bn_remat_vs_not": d_row,
              "d_entry_point": trained, "d_resumed": resumed,
              "d_buffers_restored": len(buffers), "nvidia_smi": smi})
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "zoo_done", "phase_s": phase_s, "launches": launches,
          "nvidia_smi": smi})
    return {"launches": launches, "rows": rows, "phase_s": phase_s}


def raw_pipeline_phases(dev, seed, smi):
    """Phase 25: flagship training from raw events.  A synthetic on-disk
    split at HxW read by ``RawEventSequenceDataset`` (every item padded to
    RAW_N_MAX), batched by ``BatchLoader`` at TRAIN_B x TRAIN_L,
    voxelized on the card by ``device_voxelize_prefetch`` (K6, one launch
    sequence per batch of 800 windows, on the tiled path) and trained by
    ``make_train_step`` with the flagship recipe and precompute_x (K1-res,
    K2) for RAW_STEPS steps, the launch counts set to 0 just before and
    read just after; then each batch's grids against the plain scatter of
    the same windows on the card, K7 ('pallas') on the first batch, the
    first step's loss and gradients with K6's grids against the scatter's
    from the same weights, and the per-batch voxelize time (CUDA events)
    beside the step's.  One JSON line; returns what the kernels line
    adds."""
    import numpy as np
    import torch
    from rpg_ramnet_tpu_torch.core.config import Config
    from rpg_ramnet_tpu_torch.data import (BatchLoader, ConcatSequenceDataset,
                                           generate_split)
    from rpg_ramnet_tpu_torch.data.raw_pipeline import (
        RawEventSequenceDataset, device_voxelize_prefetch, voxelize_batch)
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside, voxel
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_grad_fn, make_train_step
    t_phase = time.perf_counter()
    k6, k7 = voxel.events_to_voxel_grid_sortseg, voxel.events_to_voxel_grid_pallas
    counters = {"k6": k6, "k7": k7, "k1_res": gru_hside.conv_gru_hside_res,
                "k2": gru_hside.conv_gru_hside_bwd}
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = json.load(f)
    raw["trainer"].update(precompute_x=True, sequence_length=TRAIN_L)
    raw["data_loader"]["batch_size"] = TRAIN_B
    cfg = Config.from_dict(raw)
    split = raw["data_loader"]["train"]
    K, nb = cfg.model.every_x_rgb_frame, cfg.model.num_bins_events
    grid_kw = dict(num_bins=nb, height=H, width=W)
    n_cells = 3 * (K + 1) * TRAIN_L
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_raw_") as tmp:
        t0 = time.perf_counter()
        generate_split(os.path.join(tmp, "train"), n_sequences=1, seed=seed,
                       n_frames=TRAIN_L * K + K * (TRAIN_B - 1), height=H,
                       width=W, events_per_frame=RAW_EVENTS)
        data_s = time.perf_counter() - t0
        ds = RawEventSequenceDataset(
            os.path.join(tmp, "train", "seq00"), split["event_folder"],
            split["depth_folder"], split["frame_folder"],
            sequence_length=TRAIN_L, step_size=1,
            clip_distance=split["clip_distance"], every_x_rgb_frame=K,
            reg_factor=split["reg_factor"], n_max=RAW_N_MAX)
        loader = BatchLoader(ConcatSequenceDataset([ds]), TRAIN_B,
                             shuffle=True, seed=seed)
        host = []

        def loaded():
            for _ in range(RAW_STEPS):
                for b in loader:
                    host.append(b)
                    yield b

        model = ERGB2DepthRecurrent(cfg.model, device=dev,
                                    generator=torch.Generator().manual_seed(seed))
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        step = make_train_step(cfg, model, make_optimizer(cfg, model.parameters()))
        # the main path, its counts set to 0 just before and read just after
        for w in counters.values():
            w.launches = 0
        for w in (k6, k7):
            w.path_launches = dict.fromkeys(voxel.PATHS, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, grids = [], [], []
        t0 = time.perf_counter()
        for batch in device_voxelize_prefetch(loaded(), **grid_kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            aux = step(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(aux["loss"])
            grids.append(batch["events"])
        path_s = time.perf_counter() - t0
        launched = {k: w.launches for k, w in counters.items()}
        by_path = {k: dict(counters[k].path_launches) for k in ("k6", "k7")}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"k6": RAW_STEPS, "k7": 0, "k1_res": 2 * n_cells * RAW_STEPS,
            "k2": n_cells * RAW_STEPS}
    windows = TRAIN_B * TRAIN_L * K
    shapes = [list(b["events_raw"].shape) for b in host]
    if (launched != want or by_path["k6"]["tiled"] != RAW_STEPS
            or shapes != [[TRAIN_B, TRAIN_L, K, RAW_N_MAX, 4]] * RAW_STEPS
            or [list(g.shape) for g in grids]
            != [[TRAIN_B, TRAIN_L, K, H, W, nb]] * RAW_STEPS
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"raw pipeline: launches {launched} by path "
                             f"{by_path}, expected {want}; batches {shapes}; "
                             f"losses {losses}")

    def on_card(b):
        return (torch.from_numpy(b["events_raw"]).to(dev),
                torch.from_numpy(b["events_count"]).to(dev))

    def rel_err(got, ref):
        return ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()

    # each batch's grids against the plain scatter of its windows: K6's
    # (K7's on the first batch) before the normalization, and the stage's
    # normalized grids over the cells both hold nonzero.  A cell whose
    # contributions cancel can sum to exactly 0 in one order of the adds
    # and not in another; the normalization leaves a 0 and moves any other
    # value by its window's mean/std, so such cells are counted apart,
    # with the largest |value| either sum left there (a rounding residue).
    # The plain scatter adds atomically too: its one run is normalized here
    grid_errs, norm_errs, k7_errs, cancelled, finite = [], [], [], [], []
    k7.launches = 0
    for i, (b, g) in enumerate(zip(host, grids)):
        ev, n = on_card(b)
        plain = voxelize_batch(ev, n, backend="scatter", normalize=False, **grid_kw)
        k6_raw = voxelize_batch(ev, n, backend="sortseg", normalize=False, **grid_kw)
        grid_errs.append(rel_err(k6_raw, plain))
        if i == 0:
            k7_errs.append(rel_err(voxelize_batch(
                ev, n, backend="pallas", normalize=False, **grid_kw), plain))
        apart = (plain != 0) != (g != 0)
        cancelled.append({"cells": int(apart.sum()),
                          "max_abs_plain": plain[apart].abs().max().item()
                          if apart.any() else 0.0,
                          "max_abs_k6": k6_raw[apart].abs().max().item()
                          if apart.any() else 0.0})
        del k6_raw
        flat = plain.reshape(windows, H, W, nb)
        plain = voxel.normalize_voxel_grid(flat, tuple(
            s[:, None, None, None] for s in voxel.voxel_stats(flat))).reshape(g.shape)
        norm_errs.append(rel_err(torch.where(apart, 0.0, g),
                                 torch.where(apart, 0.0, plain)))
        finite.append(bool(g.isfinite().all()))
        if i == 0:
            plain0 = plain
        del plain, flat, apart, ev, n
    k7_launches = k7.launches
    residue = max(max(c["max_abs_plain"], c["max_abs_k6"]) for c in cancelled)
    if not (max(grid_errs + norm_errs + k7_errs) <= VOX_TOL and all(finite)
            and residue <= VOX_TOL and k7_launches == 1):
        raise AssertionError(f"raw pipeline grids vs the plain scatter: "
                             f"{grid_errs}, normalized {norm_errs}, "
                             f"cancelled cells {cancelled}, K7 {k7_errs} "
                             f"({k7_launches} launches), finite {finite}")
    # the first step from the same weights, on K6's grids and the scatter's
    twin = ERGB2DepthRecurrent(cfg.model, device=dev)
    twin.load_state_dict(init)
    grad_fn = make_grad_fn(cfg, twin)
    rest = {k: torch.from_numpy(v).to(dev) for k, v in host[0].items()
            if k not in ("events_raw", "events_count")}
    first = {}
    for name, g in (("k6", grids[0]), ("scatter", plain0)):
        loss = grad_fn({**rest, "events": g})["loss"].item()
        first[name] = (loss, {n: p.grad.float().clone()
                              for n, p in twin.named_parameters()})
    cos = {n: torch.nn.functional.cosine_similarity(
        first["k6"][1][n].flatten(), first["scatter"][1][n].flatten(),
        dim=0).item() for n in first["k6"][1]}
    worst = min(cos, key=cos.get)
    step_row = {"loss_k6": first["k6"][0], "loss_scatter": first["scatter"][0],
                "loss_rel_diff": abs(first["k6"][0] - first["scatter"][0])
                / abs(first["scatter"][0]), "loss_tol": LOSS_TOL,
                "grad_cos_min": cos[worst], "grad_cos_min_tensor": worst,
                "cos_tol": COS_TOL, "tensors": len(cos)}
    if not (step_row["loss_rel_diff"] <= LOSS_TOL
            and step_row["grad_cos_min"] >= COS_TOL):
        raise AssertionError(f"raw pipeline first step, K6 vs scatter: {step_row}")
    del first, twin, grids, plain0, rest
    # the per-batch stage on the card: K6 with the normalization, the plain
    # scatter with it, K6 alone, one index_add_ of the contributions
    ev, n = on_card(host[0])
    flat_ev, flat_n = ev.reshape(windows, RAW_N_MAX, 4), n.reshape(windows)
    idx, vals = index_add_inputs(flat_ev, flat_n, nb * H * W, (nb, H, W))
    flat = torch.empty(windows * nb * H * W, device=dev)
    times = {
        "voxelize_ms": cuda_time_us(lambda: voxelize_batch(ev, n, backend="auto",
                                                           **grid_kw), 3) / 1e3,
        "voxelize_plain_ms": cuda_time_us(lambda: voxelize_batch(
            ev, n, backend="scatter", **grid_kw), 3) / 1e3,
        "k6_ms": cuda_time_us(lambda: k6(flat_ev, flat_n, with_stats=True,
                                         **grid_kw), 3) / 1e3,
        "index_add_ms": cuda_time_us(
            lambda: flat.zero_().index_add_(0, idx, vals), 3) / 1e3}
    events = int(n.sum().item())
    bound_ms = (16 * events + 4 * windows + 4 * windows * nb * H * W) \
        / peaks()[1] * 1e3
    del ev, n, flat_ev, flat_n, idx, vals, flat
    torch.cuda.empty_cache()
    check_no_jax()
    phase_s = time.perf_counter() - t_phase
    row = {"phase": "raw_pipeline", "config": CONFIG, "precompute_x": True,
           "B": TRAIN_B, "L": TRAIN_L, "K": K, "H": H, "W": W,
           "n_max": RAW_N_MAX, "events_per_window": RAW_EVENTS,
           "windows_per_batch": windows, "events_first_batch": events,
           "steps": RAW_STEPS, "data_write_s": data_s,
           "launches": launched, "launches_expected": want,
           "launches_by_path": by_path, "grid_max_rel_err": grid_errs,
           "normalized_max_rel_err": norm_errs, "cancelled_cells": cancelled,
           "k7_max_rel_err": k7_errs[0], "vox_tol": VOX_TOL,
           "first_step_k6_vs_scatter": step_row, "losses": losses,
           "step_s": step_s, "path_s": path_s, "peak_mem_gib": peak_gib,
           **times, "bound_ms": bound_ms, "bound_by": "bytes",
           "phase_s": phase_s, "nvidia_smi": smi}
    emit(row)
    return row


def parallel_train_config():
    """The flagship config as phase 6 trains it (precompute_x, TRAIN_L,
    the global batch TRAIN_B), as a Config."""
    from rpg_ramnet_tpu_torch.core.config import Config
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = json.load(f)
    raw["trainer"].update(precompute_x=True, sequence_length=TRAIN_L)
    raw["data_loader"]["batch_size"] = TRAIN_B
    return Config.from_dict(raw)


def parallel_windows(items, K, dev, seed):
    """Windows ``items`` of phase 26's global batch at TRAIN_CROP, each
    made on the card from its own seed (so that each rank makes its own
    items alone), stacked into a batch."""
    import torch
    c, out = TRAIN_CROP, {}
    for i in items:
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
        win = {"events": torch.randn((TRAIN_L, K, c, c, 5), device=dev,
                                     generator=g),
               "image": torch.rand((TRAIN_L, c, c, 1), device=dev, generator=g),
               "depth_events": torch.rand((TRAIN_L, K, c, c, 1), device=dev,
                                          generator=g),
               "depth_image": torch.rand((TRAIN_L, c, c, 1), device=dev,
                                         generator=g)}
        for k, v in win.items():
            out.setdefault(k, []).append(v)
    return {k: torch.stack(v) for k, v in out.items()}


def ddp_worker(out_dir, seed):
    """One of phase 26's ranks (``chip_smoke.py --ddp_worker DIR``, with
    torchrun's environment): gloo on the current card, the flagship's
    weights from the seed (rank 0's broadcast), this rank's TRAIN_B /
    world windows, one train step's gradients (``make_grad_fn``: the
    global batch's loss, the gradients averaged over the ranks), the
    K1-res and K2 counts set to 0 just before and read just after, the
    peak memory; rank 0 also saves the gradients."""
    import torch
    import torch.distributed as dist
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.parallel import distributed
    from rpg_ramnet_tpu_torch.train.train_step import make_grad_fn
    from rpg_ramnet_tpu_torch.utils import require_cuda
    dev = require_cuda()
    distributed.init_from_env("gloo")
    try:
        r, w = distributed.rank(), distributed.world()
        cfg = parallel_train_config()
        K = cfg.model.every_x_rgb_frame
        per = TRAIN_B // w
        batch = parallel_windows(range(r * per, (r + 1) * per), K, dev, seed)
        model = ERGB2DepthRecurrent(cfg.model, device=dev,
                                    generator=torch.Generator().manual_seed(seed))
        distributed.broadcast_module(model)
        grads = make_grad_fn(cfg, model)
        k1r, k2 = gru_hside.conv_gru_hside_res, gru_hside.conv_gru_hside_bwd
        k1r.launches = k2.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aux = grads(batch)
        torch.cuda.synchronize()
        row = {"rank": r, "world": w, "backend": dist.get_backend(),
               "batch": per, "loss": aux["loss"].item(),
               "launches": {"k1_res": k1r.launches, "k2": k2.launches},
               "step_s": time.perf_counter() - t0,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if r == 0:
            torch.save({n: p.grad.float().cpu()
                        for n, p in model.named_parameters()
                        if p.grad is not None},
                       os.path.join(out_dir, "grads.pt"))
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
            json.dump(row, f)
    finally:
        distributed.destroy()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(cmd, log, env):
    """cmd started from the repository's root, its output to the file
    log (a pipe left unread while this process works could fill)."""
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def spawn_ranks(out_dir, seed):
    """PAR_RANKS processes of ``ddp_worker`` with torchrun's environment
    (rank r on the current card); returns them, started."""
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(PAR_RANKS)}
    return [start([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                   "--seed", str(seed), "--ddp_worker", out_dir],
                  os.path.join(out_dir, f"rank{r}.log"),
                  {**env, "RANK": str(r), "LOCAL_RANK": "0"})
            for r in range(PAR_RANKS)]


def wait_all(procs, timeout):
    """Each process's output; raises if one fails or outlives timeout (all
    are ended either way)."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p in procs:
        with open(p.log) as f:
            outs.append(f.read())
        if p.returncode != 0:
            raise AssertionError(f"{p.args} exited {p.returncode}:\n"
                                 f"{outs[-1][-3000:]}")
    return outs


def single_step_grads(dev, seed, K):
    """Phase 26 (a)'s comparison: one process's train-step gradients on
    the whole global batch (its launches are not the path's)."""
    import torch
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.train.train_step import make_grad_fn
    cfg = parallel_train_config()
    model = ERGB2DepthRecurrent(cfg.model, device=dev,
                                generator=torch.Generator().manual_seed(seed))
    aux = make_grad_fn(cfg, model)(parallel_windows(range(TRAIN_B), K, dev, seed))
    return aux["loss"].item(), {n: p.grad.float() for n, p in
                                model.named_parameters() if p.grad is not None}


def ddp_vs_single(procs, out_dir, single, dev, K):
    """Phase 26 (a): the two gloo ranks (``spawn_ranks``, waited for here)
    against the single process's (loss, gradients) on the same global
    batch: loss, least gradient cosine, each rank's launches and peak
    memory."""
    import torch
    t0 = time.perf_counter()
    wait_all(procs, 300)
    rows = []
    for r in range(PAR_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    grads = torch.load(os.path.join(out_dir, "grads.pt"))
    single_loss, single = single
    if sorted(grads) != sorted(single):
        raise AssertionError("two gloo ranks vs one process: gradients of "
                             "other tensors")
    cos = {n: torch.nn.functional.cosine_similarity(
        grads[n].to(dev).flatten(), single[n].flatten(), dim=0).item()
        for n in single}
    worst = min(cos, key=cos.get)
    n_cells = 3 * (K + 1) * TRAIN_L
    want = {"k1_res": 2 * n_cells, "k2": n_cells}
    out = {"ranks": rows, "single_loss": single_loss,
           "loss_rel_diff": abs(rows[0]["loss"] - single_loss) / abs(single_loss),
           "loss_tol": LOSS_TOL, "grad_cos_min": cos[worst],
           "grad_cos_min_tensor": worst, "cos_tol": COS_TOL,
           "tensors": len(cos), "launches_expected_per_rank": want,
           "waited_s": time.perf_counter() - t0}
    if (any(r["launches"] != want or r["backend"] != "gloo"
            or r["loss"] != rows[0]["loss"] for r in rows)
            or not math.isfinite(single_loss)
            or not out["loss_rel_diff"] <= LOSS_TOL
            or not out["grad_cos_min"] >= COS_TOL):
        raise AssertionError(f"two gloo ranks vs one process: {out}")
    return out


def start_nccl_world_of_one(tmp, K, seed):
    """Phase 26 (b), started: the training entry point as a world of one
    over NCCL (torchrun's environment in a subprocess) for one epoch of
    TRAIN_STEPS steps at NCCL_B on a synthetic split in tmp.  Returns
    (process, run directory, start time)."""
    write_train_data(os.path.join(tmp, "data"), K, seed, batch=NCCL_B)
    raw = train_config(tmp)
    raw["name"] = "smoke_nccl"
    raw["data_loader"]["batch_size"] = NCCL_B
    cfg_path = os.path.join(tmp, "nccl_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    env = {**os.environ, "PREPROCESSED_DATASETS_FOLDER": os.path.join(tmp, "data"),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1"}
    proc = start([sys.executable, "-m", "rpg_ramnet_tpu_torch.train", "-c",
                  cfg_path], os.path.join(tmp, "train.log"), env)
    return proc, os.path.join(tmp, "runs", raw["name"]), time.perf_counter()


def nccl_world_of_one(proc, run, t0):
    """Phase 26 (b), waited for: its 'over nccl' line, one JSONL entry
    with finite losses and the epoch's checkpoint."""
    log = wait_all([proc], 300)[0]
    with open(os.path.join(run, "train_log.jsonl")) as f:
        entries = [json.loads(ln) for ln in f]
    out = {"batch": NCCL_B, "steps": TRAIN_STEPS,
           "wall_s": time.perf_counter() - t0,
           "over_nccl": "rank 0 of 1 over nccl" in log,
           "log_entries": len(entries),
           "checkpoint": os.path.exists(os.path.join(
               run, "checkpoint-epoch0", "state.pt"))}
    if entries:
        out.update(train_loss=entries[0]["train_loss"],
                   val_loss=entries[0]["val_loss"])
    if not (out["over_nccl"] and len(entries) == 1 and out["checkpoint"]
            and all(math.isfinite(out[k]) for k in ("train_loss", "val_loss"))):
        raise AssertionError(f"NCCL world of one: {out}\n{log[-3000:]}")
    return out


def mesh_kernel_check(dev, seed):
    """Phase 26: K1 (gx a step of a [B, K, ...] buffer) and K5 at
    MESH_CELLS, each replica's shapes on the lane mesh, against their
    plain versions under the planner's plan (``lane_kernel_rows``)."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    gen = torch.Generator().manual_seed(seed)
    dgen = torch.Generator(device=dev).manual_seed(seed)
    out = {"k1": {}, "k5": {}}
    for shape in MESH_CELLS:
        B, Hc, Wc, C = shape
        key = "x".join(map(str, shape))
        w_ur, w_o = make_cell_inputs((1, 1, 1, C), dev, gen)[3:]
        h = (torch.rand(shape, device=dev, generator=dgen) * 2 - 1).bfloat16()
        gx = torch.randn((B, 5, Hc, Wc, 3 * C), device=dev,
                         generator=dgen).bfloat16()[:, 2]
        a = (h, gx, w_ur, w_o)
        out["k1"].update(lane_kernel_rows([(
            key, lambda: gru_hside.conv_gru_hside(*a),
            lambda: gru_hside.conv_gru_hside_plain(*a),
            lambda: gru_hside.conv_gru_hside(h[:1], gx[:1], w_ur, w_o),
            K1_TOL, plan_name(gru_hside.plan_k1(*shape)))]))
        _, x, h5, w5 = make_full_cell_inputs(shape, dev, gen)
        out["k5"].update(lane_kernel_rows([(
            key, lambda: gru_hside.conv_gru_full(x, h5, *w5),
            lambda: gru_hside.conv_gru_full_plain(x, h5, *w5),
            lambda: gru_hside.conv_gru_full(x[:1], h5[:1], *w5),
            CELL_TOL, plan_name(gru_hside.plan_k5(*shape)))]))
        del x, h5, w5, a, h, gx
    return out


def lane_mesh_runs(cfg, K, dev, seed):
    """Phase 26 (c): the lane engines over a [cuda:0, cuda:0] mesh (a
    replica and LANES / 2 lanes each) against the single-device engine
    on the same in-memory sequences (LANE_SEQ_LENGTHS at 256x512): lanes
    x chunk (K1 at B = LANES / 2) and per package with fused_gru='on' (K5
    at B = LANES / 2), every item's maps; then the eval entry point with
    --mesh 1 --lanes LANES --scan_chunk LANE_CHUNK against the same
    command without --mesh."""
    import numpy as np
    import torch
    from rpg_ramnet_tpu_torch.core.config import MeshConfig
    from rpg_ramnet_tpu_torch.eval import inference
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.parallel import make_mesh
    k1, k5 = gru_hside.conv_gru_hside, gru_hside.conv_gru_full
    mesh = make_mesh(MeshConfig(data=PAR_RANKS, model=1), [dev] * PAR_RANKS)
    ds = SyntheticDataset(LANE_SEQ_LENGTHS, K, seed + 21)
    model = ERGB2DepthRecurrent(cfg, device=dev,
                                generator=torch.Generator().manual_seed(seed + 21))
    on_model = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="on"),
                                   device=dev)
    on_model.load_state_dict(model.state_dict())
    n_chunked = lane_steps(LANE_SEQ_LENGTHS, LANES, LANE_CHUNK)
    n_pkg = lane_steps(LANE_SEQ_LENGTHS, LANES)
    out = {}
    for name, run, m, kern, kw, steps in (
            ("chunked", inference.run_batched_chunked_streaming, model, k1,
             {"chunk": LANE_CHUNK}, n_chunked),
            ("per_package", inference.run_batched_streaming, on_model, k5, {},
             n_pkg)):
        preds = {}
        counts = {}
        walls = {}
        for which, mesh_arg in (("mesh", mesh), ("single", None)):
            got = {}
            kern.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(ds, m, n_lanes=LANES, mesh=mesh_arg, **kw,
                on_prediction=lambda g, p, item, pos: got.__setitem__(g, p))
            torch.cuda.synchronize()
            walls[which] = time.perf_counter() - t0
            counts[which] = kern.launches
            preds[which] = got
        want = PAR_RANKS * 3 * (K + 1) * steps
        err = max_pred_diff(preds["mesh"], preds["single"])
        finite = all(np.isfinite(v).all() for p in preds["mesh"].values()
                     for v in p.values())
        out[name] = {"launches": counts["mesh"], "launches_expected": want,
                     "launches_single_device": counts["single"],
                     "items": len(preds["mesh"]), "max_abs_err_vs_single":
                     err, "tol": SLICE_TOL, "wall_s_mesh_single":
                     [walls["mesh"], walls["single"]]}
        if (counts["mesh"] != want or len(preds["mesh"]) != sum(LANE_SEQ_LENGTHS)
                or sorted(preds["mesh"]) != sorted(preds["single"])
                or not finite or not err <= SLICE_TOL):
            raise AssertionError(f"lane mesh, {name}: {out[name]}")
    # the eval entry point end to end: a mesh of one card
    lengths = MESH_ENTRY_SEQ_LENGTHS
    n = 3 * (K + 1) * lane_steps(lengths, LANES, LANE_CHUNK)
    args = ("--lanes", str(LANES), "--scan_chunk", str(LANE_CHUNK))
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_mesh_") as tmp:
        write_split(tmp, lengths, K, seed + 31, H, W)
        files = stream_files(tmp, model, "auto", name="mesh")
        with_mesh, c_mesh, w_mesh = lane_run(
            files, tmp, [k1], [n], lengths, extra=args + ("--mesh", "1"),
            what="eval entry --mesh 1")
        without, _, w_plain = lane_run(files, tmp, [k1], [n], lengths,
                                       extra=args, what="eval entry, no mesh")
    out["eval_entry_mesh_1"] = {
        "k1_launches": c_mesh[0], "items": len(with_mesh),
        "max_abs_err_vs_no_mesh": max_pred_diff(with_mesh, without),
        "wall_s_mesh_no_mesh": [w_mesh, w_plain]}
    if not out["eval_entry_mesh_1"]["max_abs_err_vs_no_mesh"] <= SLICE_TOL:
        raise AssertionError(f"eval entry --mesh 1: {out['eval_entry_mesh_1']}")
    return out


def sharded_raw_batch(dev, seed, K):
    """Phase 26 (d): one raw batch of TRAIN_B x TRAIN_L x K windows (RAW_EVENTS
    events each, padded to RAW_N_MAX) at HxW through
    ``device_voxelize_prefetch`` whole and as PAR_RANKS shares
    (``sharding=(r, PAR_RANKS)``): each share's normalized grids against
    that share of the whole batch's, over the cells both hold nonzero (a
    cell whose atomic adds cancel can hold 0 in one run and a residue in
    the other: counted apart, as phase 25), and K6's launches (one per
    share)."""
    import numpy as np
    import torch
    from rpg_ramnet_tpu_torch.data.raw_pipeline import device_voxelize_prefetch
    from rpg_ramnet_tpu_torch.ops import voxel
    rng = np.random.default_rng(seed + 41)
    shape = (TRAIN_B, TRAIN_L, K, RAW_N_MAX)
    ev = np.zeros(shape + (4,), np.float32)
    ev[..., 0] = np.sort(rng.uniform(0.0, 0.05, shape), axis=-1)
    ev[..., 1] = rng.integers(0, W, shape)
    ev[..., 2] = rng.integers(0, H, shape)
    ev[..., 3] = rng.integers(0, 2, shape)
    ev[..., RAW_EVENTS:, :] = 0
    batch = {"events_raw": ev,
             "events_count": np.full(shape[:3], RAW_EVENTS, np.int32),
             "image": rng.random((TRAIN_B, TRAIN_L, 4, 4, 1), dtype=np.float32)}
    kw = dict(num_bins=5, height=H, width=W, device=dev)
    k6 = voxel.events_to_voxel_grid_sortseg
    whole = next(device_voxelize_prefetch(iter([batch]), **kw))["events"]
    torch.cuda.synchronize()
    k6.launches = 0
    errs, apart, per = [], [], TRAIN_B // PAR_RANKS
    for r in range(PAR_RANKS):
        got = next(device_voxelize_prefetch(iter([batch]), sharding=(r, PAR_RANKS),
                                            **kw))["events"]
        want = whole[r * per:(r + 1) * per]
        off = (got != 0) != (want != 0)
        apart.append(int(off.sum()))
        errs.append(((torch.where(off, 0.0, got) - torch.where(off, 0.0, want))
                     .abs().max() / want.abs().max().clamp(min=1.0)).item())
        if list(got.shape) != [per, TRAIN_L, K, H, W, 5]:
            raise AssertionError(f"share {r}: grids {list(got.shape)}")
        del got, want, off
    torch.cuda.synchronize()
    out = {"windows": TRAIN_B * TRAIN_L * K, "shares": PAR_RANKS,
           "k6_launches": k6.launches, "max_rel_err": errs,
           "cancelled_cells": apart, "tol": VOX_SHARD_TOL}
    del whole
    if k6.launches != PAR_RANKS or not max(errs) <= VOX_SHARD_TOL:
        raise AssertionError(f"sharded raw batch: {out}")
    return out


def parallel_phases(dev, seed, smi):
    """Phase 26: data parallelism at the flagship's full width on the one
    card: (a) two gloo ranks sharing it, one train step of TRAIN_B windows
    (TRAIN_B / 2 a rank) against the single process on the same global
    batch; (b) the training entry point as a world of one over NCCL; (c)
    the lane engines over a [cuda:0, cuda:0] mesh against the
    single-device engine, and the eval entry with --mesh 1; (d) the raw
    pipeline's shares; then K1 and K5 at the mesh's replica shapes
    against their plain versions.  (a) and (b) run as subprocesses while
    this process runs its comparison step, (c) and (d), so those walls
    are under contention; the kernels are timed after them.  One JSON
    line; returns what the kernels line adds."""
    import torch
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = ModelConfig.load(os.path.join(ROOT, CONFIG))
    K = cfg.every_x_rgb_frame
    procs = []
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_par_") as tmp:
        try:
            nccl_dir, ranks_dir = (os.path.join(tmp, d) for d in ("nccl", "ranks"))
            os.makedirs(ranks_dir)
            nccl_run = start_nccl_world_of_one(nccl_dir, K, seed)
            procs.append(nccl_run[0])
            ranks = spawn_ranks(ranks_dir, seed)
            procs += ranks
            single = single_step_grads(dev, seed, K)
            lanes = lane_mesh_runs(cfg, K, dev, seed)
            raw = sharded_raw_batch(dev, seed, K)
            ddp = ddp_vs_single(ranks, ranks_dir, single, dev, K)
            del single
            nccl = nccl_world_of_one(*nccl_run)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    torch.cuda.empty_cache()
    krows = mesh_kernel_check(dev, seed)
    check_no_jax()
    row = {"phase": "parallel", "config": CONFIG, "ranks": PAR_RANKS,
           "B": TRAIN_B, "L": TRAIN_L, "crop": TRAIN_CROP, "K": K,
           "ddp_gloo_one_card": ddp, "nccl_world_of_one": nccl,
           "nccl_across_cards": "not run: one card",
           "mesh_kernels": krows, "lane_mesh": lanes, "raw_shares": raw,
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(row)
    return row

def band_rows(height, rows):
    """Band 0's rows with its halo: a band of ``height`` rows of
    SPATIAL_BANDS and the halo of ``rows`` it takes (``spatial._taken``)."""
    from rpg_ramnet_tpu_torch.parallel import spatial
    top, bottom = spatial._taken(SPATIAL_BANDS, height, rows)[0]
    return height + top + bottom


def spatial_kernel_rows(dev, seed, K):
    """Phase 27's kernel rows: K5 and K8 at the flagship's band shapes
    (state rows per band plus the 'convgru' halo; decoder layer inputs plus
    the 'upsample_conv' halo, decode batch K+1), K3 and K4 at the phased
    ones (plus the 'convlstm' and 'phased_cell' halos), each against its
    plain version, device us beside the unsharded shape's
    (``lane_kernel_rows``; K8's error relative to the plain version's
    largest magnitude) and the band's bound."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside, upsample_conv
    from rpg_ramnet_tpu_torch.parallel.spatial import HALO
    gen = torch.Generator().manual_seed(seed)
    out = {"k5": {}, "k8": {}, "k3": {}, "k4": {}}
    bands = {}
    for kind, whole_shapes, halo in (
            ("k5", FLAGSHIP_CELLS, "convgru"), ("k3", PHASED_CELLS, "convlstm"),
            ("k4", PHASED_CELLS, "phased_cell")):
        bands[kind] = []
        for whole in whole_shapes:
            B, Hc, Wc, C = whole
            shape = (B, band_rows(Hc // SPATIAL_BANDS, HALO[halo][0]), Wc, C)
            bands[kind].append(shape)
            key = "x".join(map(str, shape))
            if kind == "k5":
                _, x, h, w = make_full_cell_inputs(shape, dev, gen)
                _, xw, hw, ww = make_full_cell_inputs(whole, dev, gen)
                out[kind].update(lane_kernel_rows([(
                    key, lambda: gru_hside.conv_gru_full(x, h, *w),
                    lambda: gru_hside.conv_gru_full_plain(x, h, *w),
                    lambda: gru_hside.conv_gru_full(xw, hw, *ww), CELL_TOL,
                    plan_name(gru_hside.plan_k5(*shape)))]))
                del x, h, w, xw, hw, ww
            else:
                inputs = make_lstm_inputs(shape, dev, gen)
                kern, plain = lstm_calls(inputs, kind)
                kern_w, _ = lstm_calls(make_lstm_inputs(whole, dev, gen), kind)
                out[kind].update(lane_kernel_rows([(
                    key, kern, plain, kern_w, CELL_TOL,
                    plan_name(gru_hside.plan_lstm(*shape,
                                                  phased=kind == "k4")))]))
                del inputs, kern, plain, kern_w
    bands["k8"] = []
    for i, (C, Cout, h, w) in enumerate(DECODER_LAYERS):
        shape = (K + 1, C, Cout,
                 band_rows(h // SPATIAL_BANDS, HALO["upsample_conv"][0]), w)
        bands["k8"].append(shape)
        layer, x, skip = decoder_inputs(shape, dev, seed + i)
        _, xw, skipw = decoder_inputs((K + 1, C, Cout, h, w), dev, seed + i)
        skip, skipw = (skip, skipw) if i else (None, None)
        with torch.no_grad():
            got = upsample_conv.upsample_conv_fused(layer, x, skip)
            want = upsample_conv.upsample_conv_fused_plain(
                layer.conv2d.weight, layer.conv2d.bias, x, skip)
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            if not err <= DECODER_TOL:
                raise AssertionError(f"K8 at band {shape}: rel err {err}")
            us = cuda_time_us(lambda: upsample_conv.upsample_conv_fused(
                layer, x, skip), 20, queued=True)
            us_w = cuda_time_us(lambda: upsample_conv.upsample_conv_fused(
                layer, xw, skipw), 20, queued=True)
        out["k8"]["x".join(map(str, shape))] = {
            "rel_err": err, "tol": DECODER_TOL, "device_us": us,
            "device_us_whole": us_w}
        del layer, x, skip, xw, skipw, got, want
    for kind in ("k5", "k3", "k4"):
        for r in out[kind].values():
            r["device_us_whole"] = r.pop("device_us_b1")
    bound = {k: cell_bound(k, v) for k, v in bands.items() if k != "k8"}
    bound["k8"] = decoder_bound(K + 1, [s[1:] for s in bands["k8"]])
    return out, bound, bands


def spatial_engine_runs(models, mesh, pkgs, counters):
    """Each package's maps from StreamingInference (batched decode) on
    models['on'] over the mesh, and unsharded on models['on'] and
    models['off']; the kernels' launches in the mesh run (the counters
    zeroed just before it) and its K5/K3/K4 launches of the unsharded
    'on' run."""
    from rpg_ramnet_tpu_torch.eval import StreamingInference
    runs, launches = {}, {}
    for name, mode, m in (("spatial", "on", mesh), ("whole", "on", None),
                          ("off", "off", None)):
        engine = StreamingInference(models[mode], batched_decode=True,
                                    spatial_mesh=m)
        for c in counters.values():
            c.launches = 0
        runs[name] = {i: engine.step(p) for i, p in enumerate(pkgs)}
        launches[name] = {k: c.launches for k, c in counters.items()}
    return runs, launches


def spatial_walls(models, mesh, pkgs):
    """Median and p90 host-clock ms per package of StreamingInference
    (batched decode) on models['on'], unsharded and over the mesh, in
    turns whole, spatial, spatial, whole, SPATIAL_TIMED packages a turn
    after two warm-up ones (each step ends in the maps' copy to the
    host)."""
    import numpy as np
    from rpg_ramnet_tpu_torch.eval import StreamingInference
    turns = []
    for name in ("whole", "spatial", "spatial", "whole"):
        engine = StreamingInference(models["on"], batched_decode=True,
                                    spatial_mesh=mesh if name == "spatial"
                                    else None)
        for p in pkgs[:2]:
            engine.step(p)
        lat = []
        for i in range(SPATIAL_TIMED):
            t0 = time.perf_counter()
            engine.step(pkgs[i % len(pkgs)])
            lat.append((time.perf_counter() - t0) * 1e3)
        turns.append({"engine": name, "median_ms": float(np.median(lat)),
                      "p90_ms": float(np.percentile(lat, 90))})
    best = {n: min(t["median_ms"] for t in turns if t["engine"] == n)
            for n in ("whole", "spatial")}
    return {"turns": turns, "median_ms_whole": best["whole"],
            "median_ms_spatial": best["spatial"],
            "spatial_over_whole": best["spatial"] / best["whole"]}


def spatial_packages(K, h, w, n, seed, times=False):
    """n unbatched packages at h x w (numpy), timestamps for the phased
    regime."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pkgs = [{"events": rng.standard_normal((K, h, w, 5), dtype=np.float32),
             "image": rng.random((h, w, 1), dtype=np.float32)}
            for _ in range(n)]
    if times:
        for i, p in enumerate(pkgs):
            p["times_events"] = np.float32(0.05 * i + 0.01 * np.arange(K))
            p["times_image"] = p["times_events"][-1]
    return pkgs


def spatial_phases(dev, seed, smi):
    """Phase 27: spatial partitioning (parallel/spatial.py) on the one
    card: the flagship at 256x512, B=1, H in two row bands over a
    [cuda:0, cuda:0] mesh with fused_gru and fused_decoder 'on' (K5 and K8
    per band), and the phased regime at 256x352 with fused_gru 'on' (K4
    and K3 per band), through StreamingInference(spatial_mesh=): launches,
    maps against the same kernels unsharded (CELL_TOL) and against 'off'
    (SLICE_TOL); the dry run's DP x SP legs (``entry.dryrun_multichip``
    on [cuda:0] * 4, its ranks sharing the card over gloo) run meanwhile;
    then the per-package wall, spatial against unsharded, and the kernels
    at the band shapes.  One JSON line; returns what the kernels line
    reads."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from rpg_ramnet_tpu_torch import entry
    from rpg_ramnet_tpu_torch.core.config import MeshConfig, ModelConfig
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell, upsample_conv
    from rpg_ramnet_tpu_torch.parallel import make_mesh
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = ModelConfig.load(os.path.join(ROOT, CONFIG))
    K = cfg.every_x_rgb_frame
    mesh = make_mesh(MeshConfig(data=1, model=SPATIAL_BANDS),
                     [dev] * SPATIAL_BANDS)
    pcfg = dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in PHASED.items()})
    legs = {"flagship": (
                dataclasses.replace(cfg, fused_decoder="on"), H, W,
                SPATIAL_PACKAGES, False,
                {"k5": gru_hside.conv_gru_full,
                 "k8": upsample_conv.upsample_conv_fused},
                # per band: 3 scales x (K+1) cells; 3 decoder layers per
                # package's one decode pass
                {"k5": 3 * (K + 1), "k8": 3}),
            "phased": (
                pcfg, PHASED_H, PHASED_W, PHASED_SPATIAL_PACKAGES, True,
                {"k3": gru_hside.conv_lstm_hside,
                 "k4": phased_cell.conv_lstm_phased},
                {"k3": 3 * (K + 1), "k4": 3 * (K + 1)})}
    out, launched = {}, {}
    with ThreadPoolExecutor(1) as pool:
        dry = pool.submit(entry.dryrun_multichip, SPATIAL_DRYRUN)
        for i, (name, (lcfg, h, w, n, times, counters, per)) in enumerate(
                legs.items()):
            on = ERGB2DepthRecurrent(
                dataclasses.replace(lcfg, fused_gru="on"), device=dev,
                generator=torch.Generator().manual_seed(seed + 51 + i))
            off = ERGB2DepthRecurrent(
                dataclasses.replace(lcfg, fused_gru="off",
                                    fused_decoder="off"), device=dev)
            off.load_state_dict(on.state_dict())
            models = {"on": on, "off": off}
            pkgs = spatial_packages(K, h, w, n, seed + 61 + i, times)
            runs, launches = spatial_engine_runs(models, mesh, pkgs, counters)
            want = {k: SPATIAL_BANDS * v * n for k, v in per.items()}
            err_whole = max_pred_diff(runs["spatial"], runs["whole"])
            err_off = max_pred_diff(runs["spatial"], runs["off"])
            finite = all(np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1
                         and v.shape == (h, w, 1)
                         for p in runs["spatial"].values() for v in p.values())
            out[name] = {
                "H": h, "W": w, "packages": n,
                "launches": launches["spatial"], "launches_expected": want,
                "launches_unsharded": launches["whole"],
                "max_abs_err_vs_same_kernels_unsharded": err_whole,
                "tol_same_kernels": CELL_TOL,
                "max_abs_err_vs_off": err_off, "tol_off": SLICE_TOL,
                "max_abs_err_unsharded_vs_off": max_pred_diff(runs["whole"],
                                                              runs["off"]),
                "maps_finite_in_0_1": finite}
            if (launches["spatial"] != want or not finite
                    or sorted(runs["spatial"]) != sorted(runs["whole"])
                    or not err_whole <= CELL_TOL or not err_off <= SLICE_TOL):
                raise AssertionError(f"spatial, {name}: {out[name]}")
            launched[name] = launches["spatial"]
            out[name]["_models"], out[name]["_pkgs"] = models, pkgs
        dryrun = dry.result()
    if not (dryrun.get("dp_sp_max_abs_err", 1) <= 1e-4
            and dryrun.get("dp_sp_flagship_max_abs_err", 1) <= 1e-4):
        raise AssertionError(f"dry run's DP x SP legs: {dryrun}")
    for name in legs:
        models, pkgs = out[name].pop("_models"), out[name].pop("_pkgs")
        out[name]["per_package_wall"] = spatial_walls(models, mesh, pkgs)
        del models, pkgs
    torch.cuda.empty_cache()
    krows, bound, shapes = spatial_kernel_rows(dev, seed, K)
    check_no_jax()
    row = {"phase": "spatial", "config": CONFIG, "bands": SPATIAL_BANDS,
           "mesh": "[cuda:0] x 2, model axis", "legs": out,
           "dryrun_multichip_4": dryrun, "band_kernels": krows,
           "band_shapes": shapes, "band_bound_ms": bound,
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(row)
    return {"launches": {k: v for leg in launched.values()
                         for k, v in leg.items()}, "kernels": krows,
            "bound": bound}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ddp_worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if args.ddp_worker:        # one rank of phase 26
        ddp_worker(args.ddp_worker, args.seed)
        return 0
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, event_loop_range
    from rpg_ramnet_tpu_torch.ops import (gru_chunk, gru_hside, gru_pair,
                                          upsample_conv, voxel)
    from rpg_ramnet_tpu_torch.utils import require_cuda

    # 1. device and build (one nvcc per source, all at once)
    dev = require_cuda()
    smi = nvidia_smi_line()
    peak_flops, hbm_bytes_per_s = peaks()
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
          "peak_bf16_flops": peak_flops, "hbm_bytes_per_s": hbm_bytes_per_s,
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
    shares = slice_costs(cfg, off_model, packages / min(walls[1], walls[2]),
                         dev, args.seed)
    emit({"phase": "timing", "cells": cells,
          "slice_maps": maps,
          "slice_maps_per_s": maps / min(walls[1], walls[2]), **shares,
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
        workers = process_worker_check(tcfg, os.path.join(tmp, "data"))
        kept = []
        trained = run_training(raw, tmp, {
            "k1_res": (gru_hside.conv_gru_hside_res, 2 * n_cells * TRAIN_STEPS),
            "k2": (gru_hside.conv_gru_hside_bwd, n_cells * TRAIN_STEPS),
            "k1_validation": (gru_hside.conv_gru_hside, n_cells)},
            keep=kept, argv=["--worker_mode", "process"])
        workers["pools_down_after_training"] = pools_down(kept.pop())
    check_no_jax()
    emit({"phase": "train", "config": CONFIG, "precompute_x": True,
          "B": TRAIN_B, "L": TRAIN_L, "crop": TRAIN_CROP, "K": K,
          "steps": TRAIN_STEPS, "data_write_s": data_s,
          "worker_mode": "process", "process_workers": workers,
          "first_step_vs_off": first, **trained})

    # 7. training throughput and the training kernels' times
    train_timing = time_training(tcfg, tmodels, batch)
    train_timing.update(train_costs(tcfg, train_timing["train_seq_per_s"]))
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

    # 20-21. lane-batched streaming: the kernels at the lane shapes, then
    #        lanes x chunk, per package and phased through the eval entry
    lanes = lane_phases(cfg, K, dev, args.seed, smi)

    # 22. the paper's baselines through the eval and training entry points
    baselines = baseline_phases(dev, args.seed, smi)

    # 23. the trainer: previews, grad_accum, checkpoint policies, resume
    trainer = trainer_phases(dev, gen, args.seed, smi, train_cells)

    # 24. the model zoo: norms, skips, decoders, encoders, combinations
    zoo = zoo_phases(dev, args.seed, smi)
    zl = zoo["launches"]

    # 25. flagship training from raw events: K6 over each batch's windows
    rawp = raw_pipeline_phases(dev, args.seed, smi)
    rl = rawp["launches"]

    # 26. data parallelism: two gloo ranks on the card, NCCL as a world of
    #     one, lanes over a [cuda:0, cuda:0] mesh, the raw pipeline's shares
    par = parallel_phases(dev, args.seed, smi)
    pl = {k: sum(r["launches"][k] for r in par["ddp_gloo_one_card"]["ranks"])
          for k in ("k1_res", "k2")}
    pl.update(k1=par["lane_mesh"]["chunked"]["launches"],
              k5=par["lane_mesh"]["per_package"]["launches"],
              k6=par["raw_shares"]["k6_launches"])

    # 27. spatial partitioning: H in two row bands over [cuda:0, cuda:0],
    #     the flagship (K5, K8 per band) and the phased regime (K4, K3)
    sp = spatial_phases(dev, args.seed, smi)
    spl = sp["launches"]

    src = "rpg_ramnet_tpu_torch/csrc/"
    v1m = vox_times["1M"]
    vdev = {k: r["min"] / 1e3 for k, r in v1m["device_us"].items()}
    flagship_keys = ["x".join(map(str, c)) for c in FLAGSHIP_CELLS]
    S = CHUNK * (K + 1)
    k11_bound = cell_bound("k11_step", FLAGSHIP_CELLS)

    def lane_extra(kind, launches):
        """A kernel's lane rows (phases 20-21): its launches on the lane
        path, its plan and device us per shape at the lane batch and at B=1."""
        rows = lanes["kernels"][kind]
        return {"launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                **{f: {k: r[f] for k, r in rows.items()}
                   for f in ("plan", "device_us", "device_us_b1")}}

    def micro_extra(kind, launches):
        """K1-res's or K2's micro-batch rows (phase 23): launches on the
        trainer's path, the plan and device us per shape at B=8 and the
        B=8 time over the B=16 time."""
        rows = {"x".join(map(str, r["shape"])): r[kind] for r in trainer["rows"]}
        return {"launches": launches,
                **{f: {k: r[f] for k, r in rows.items()}
                   for f in ("plan", "kernel_us", "b8_over_b16")}}

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    print(smi)
    emit({"kernels": [
        dict(entry("gru_hside", "gru_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:289",
                   launches + zl["k1"] + pl["k1"],
                   max(e for row in errs.values() for e in row.values()),
                   sum(r["kernel_us"] for r in cells) / 1e3,
                   sum(r["plain_us"] for r in cells) / 1e3,
                   cell_bound("k1", FLAGSHIP_CELLS)),
             launches_by_path={"slice": launches, "zoo": zl["k1"],
                               "parallel_lane_mesh": pl["k1"]},
             lanes=lane_extra("k1", lanes["k1"]),
             lane_mesh=par["mesh_kernels"]["k1"]),
        dict(entry("gru_hside_res", "gru_hside.cu",
                   "rpg_ramnet_tpu/ops/gru_hside.py:124",
                   trained["launches"]["k1_res"] + zl["k1_res"] + rl["k1_res"]
                   + pl["k1_res"],
                   max([max(r["res_h_err"], r["res_acts_err"],
                            *r["res_plans"].values()) for r in train_rows]
                       + [e for row in res_edges.values()
                          for e in row["k1_res"].values()]
                       + [max(r["res_h_err"], r["res_acts_err"])
                          for r in trainer["rows"]]),
                   sum(r["res_kernel_us"] for r in train_cells) / 1e3,
                   sum(r["res_plain_us"] for r in train_cells) / 1e3,
                   cell_bound("k1_res", TRAIN_CELLS)),
             launches_by_path={"train": trained["launches"]["k1_res"],
                               "zoo": zl["k1_res"], "raw_pipeline": rl["k1_res"],
                               "parallel_ranks": pl["k1_res"]},
             micro_batch=micro_extra("res", trainer["launches"]["k1_res"])),
        dict(entry("gru_hside_bwd", "gru_hside_bwd.cu",
                   "rpg_ramnet_tpu/ops/gru_hside.py:535",
                   trained["launches"]["k2"] + zl["k2"] + rl["k2"] + pl["k2"],
                   max(max(r["bwd_dh_abs_err"], r["bwd_dgx_abs_err"])
                       for r in train_rows),
                   sum(r["bwd_kernel_us"] for r in train_cells) / 1e3,
                   sum(r["bwd_plain_us"] for r in train_cells) / 1e3,
                   cell_bound("k2", TRAIN_CELLS)),
             wrapper_ms=sum(r["bwd_k2"]["wrapper_us"] for r in train_cells) / 1e3,
             launches_by_path={"train": trained["launches"]["k2"],
                               "zoo": zl["k2"], "raw_pipeline": rl["k2"],
                               "parallel_ranks": pl["k2"]},
             micro_batch=micro_extra("bwd", trainer["launches"]["k2"])),
        dict(entry("gru_full", "gru_full.cu", "rpg_ramnet_tpu/ops/gru_hside.py:777",
                   k5_launches + zl["k5"] + pl["k5"] + spl["k5"],
                   max(e for row in k5_errs.values() for k, e in row.items()
                       if k != "exact_gates"),
                   sum(r["kernel_us"] for r in full_cells) / 1e3,
                   sum(r["plain_us"] for r in full_cells) / 1e3,
                   cell_bound("k5", FLAGSHIP_CELLS)),
             wrapper_ms=sum(r["kernel_wrapper_us"] for r in full_cells) / 1e3,
             plan={"x".join(map(str, r["shape"])): r["plan"] for r in full_cells},
             off_layer_ms=sum(r["plain_layer_bf16_us"] for r in full_cells) / 1e3,
             launches_by_path={"stream": k5_launches, "zoo": zl["k5"],
                               "parallel_lane_mesh": pl["k5"],
                               "spatial": spl["k5"]},
             lanes=lane_extra("k5", lanes["k5"]),
             lane_mesh=par["mesh_kernels"]["k5"],
             spatial_bands=sp["kernels"]["k5"],
             spatial_bands_bound=sp["bound"]["k5"]),
        dict(entry("voxel_scatter", "voxel.cu", "rpg_ramnet_tpu/ops/voxel.py:445",
                   stream_counts["k6"] + batch_run["auto"]["launches"] + rl["k6"]
                   + pl["k6"],
                   max([max(r[p]["k6"], r[p]["k6_stats"]) for r in vox_errs.values()
                        for p in voxel.PATHS] + rawp["grid_max_rel_err"]),
                   vdev["k6"], vdev["plain_scatter"], voxel_bound(VOX_EVENTS),
                   vdev["index_add"]),
             launches_by_path={"stream": stream_counts["by_path"]["k6"],
                               "batch": batch_run["auto"]["by_path"],
                               "raw_pipeline": rawp["launches_by_path"]["k6"],
                               "parallel_raw_shares": pl["k6"]},
             raw_pipeline={f: rawp[f] for f in (
                 "voxelize_ms", "voxelize_plain_ms", "k6_ms", "index_add_ms",
                 "bound_ms", "bound_by", "grid_max_rel_err",
                 "normalized_max_rel_err", "cancelled_cells")},
             path_at_1m=v1m["path"],
             plain_wrapper_ms=v1m["wrapper_us"]["plain_scatter"]["min"] / 1e3),
        dict(entry("voxel_onehot", "voxel.cu", "rpg_ramnet_tpu/ops/voxel.py:242",
                   k7_counts["k7"] + batch_run["pallas"]["launches"],
                   max(r[p]["k7_f32"] for r in vox_errs.values() for p in voxel.PATHS),
                   vdev["k7_f32"], vdev["plain_matmul"], voxel_bound(VOX_EVENTS),
                   vdev["index_add"]),
             launches_by_path={"stream": k7_counts["by_path"]["k7"],
                               "batch": batch_run["pallas"]["by_path"],
                               "raw_pipeline": rawp["launches_by_path"]["k7"]},
             raw_pipeline_pallas_max_rel_err=rawp["k7_max_rel_err"],
             path_at_1m=v1m["path"],
             plain_wrapper_ms=v1m["wrapper_us"]["plain_matmul"]["min"] / 1e3),
        dict(entry("lstm_hside", "lstm_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:368",
                   ph["counts"][0] + spl["k3"],
                   max(e[0] for row in ph["k3_errs"].values() for k, e in row.items()
                       if k != "exact_gates"),
                   sum(r["k3_kernel_us"] for r in ph["cells"]) / 1e3,
                   sum(r["k3_plain_us"] for r in ph["cells"]) / 1e3,
                   cell_bound("k3", PHASED_CELLS)),
             wrapper_ms=sum(r["k3_wrapper_us"] for r in ph["cells"]) / 1e3,
             plan={"x".join(map(str, r["shape"])): r["k3"]["plan"]
                   for r in ph["cells"] + ph["k3_flagship"]},
             lanes=lane_extra("k3", lanes["k3_k4"][0]),
             launches_by_path={"phased": ph["counts"][0], "spatial": spl["k3"]},
             spatial_bands=sp["kernels"]["k3"],
             spatial_bands_bound=sp["bound"]["k3"]),
        dict(entry("phased_cell", "lstm_hside.cu",
                   "rpg_ramnet_tpu/ops/phased_cell.py:113",
                   ph["counts"][1] + spl["k4"],
                   max(e[0] for row in ph["k4_errs"].values() for k, e in row.items()
                       if k != "exact_gates"),
                   sum(r["k4_kernel_us"] for r in ph["cells"]) / 1e3,
                   sum(r["k4_plain_us"] for r in ph["cells"]) / 1e3,
                   cell_bound("k4", PHASED_CELLS)),
             wrapper_ms=sum(r["k4_wrapper_us"] for r in ph["cells"]) / 1e3,
             plan={"x".join(map(str, r["shape"])): r["k4"]["plan"]
                   for r in ph["cells"]},
             lanes=lane_extra("k4", lanes["k3_k4"][1]),
             launches_by_path={"phased": ph["counts"][1], "spatial": spl["k4"]},
             spatial_bands=sp["kernels"]["k4"],
             spatial_bands_bound=sp["bound"]["k4"]),
        dict(entry("gru_pair", "gru_cells.cu", "rpg_ramnet_tpu/ops/gru_pair.py:69",
                   variants["pair"]["launches"]["k9"],
                   max(e for row in chunk_errs["k9"].values() for e in row.values()),
                   chunk_cells["k9"]["kernel_us"] / 1e3,
                   chunk_cells["k9"]["plain_us"] / 1e3,
                   cell_bound("k1", FLAGSHIP_CELLS[:2])),
             wrapper_ms=chunk_cells["k9"]["wrapper_us"] / 1e3,
             plan=chunk_cells["k9"]["plans"],
             k1_pair_ms=chunk_cells["k1_pair"]["kernel_us"] / 1e3,
             lanes=lane_extra("k9", lanes["k9"])),
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
        dict(entry("upsample_conv", "upsample_conv.cu",
                   "rpg_ramnet_tpu/ops/upsample_conv.py:203",
                   dec_variants["k8"]["launches"]["k8"]
                   + baselines["k8"]["launches"] + zl["k8"] + spl["k8"],
                   max(r["k8_rel_err"] for r in dec_errs.values()),
                   composed_rule["sum_us_batch96"]["k8"] / 1e3,
                   composed_rule["sum_us_batch96"]["two_stage"] / 1e3,
                   decoder_bound(96),
                   composed_rule["sum_us_batch96"]["composed"] / 1e3),
             launches_by_path={"chunked": dec_variants["k8"]["launches"]["k8"],
                               "baseline_ergb0": baselines["k8"]["launches"],
                               "zoo": zl["k8"], "spatial": spl["k8"]},
             spatial_bands=sp["kernels"]["k8"],
             spatial_bands_bound=sp["bound"]["k8"]),
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
