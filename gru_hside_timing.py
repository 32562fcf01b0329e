#!/usr/bin/env python3
"""Time kernels K1 and K1-res (the fused ConvGRU h-side cell), with --bwd
K2 (its backward), with --full K5 (the whole ConvGRU cell), or with --lstm
K3 and K4 (the ConvLSTM inference cells) and K3-res and K4-res (their
training variants), on one GPU.

    python3 gru_hside_timing.py [--root DIR] [--plans auto,split1]
                                [--label NAME] [--sweep] [--gates]
    python3 gru_hside_timing.py --fit SWEEP.jsonl
    python3 gru_hside_timing.py --bwd [--root DIR] [--label NAME] [--sweep]
                                [--profile-train]
    python3 gru_hside_timing.py --bwd --fit SWEEP.jsonl
    python3 gru_hside_timing.py --full [--root DIR] [--plans auto,split1]
                                [--label NAME] [--sweep] [--gates]
                                [--latency-pairs N]
    python3 gru_hside_timing.py --full --fit SWEEP.jsonl
    python3 gru_hside_timing.py --lstm [--root DIR] [--plans auto,...]
                                [--kinds k3,k4,k3_res,k4_res]
                                [--label NAME] [--sweep] [--gates]
                                [--profile-train]
    python3 gru_hside_timing.py --lstm --e2e [--root DIR] [--label NAME]
    python3 gru_hside_timing.py --lstm --fit SWEEP.jsonl
    python3 gru_hside_timing.py --variants [--root DIR] [--plans auto,...]
                                [--label NAME]

At the flagship chunked-inference shapes (K1: 1x128x256x64, 1x64x128x128,
1x32x64x256) and the flagship training shapes (K1-res: B=16 at 112x112x64,
56x56x128, 28x28x256) it prints one JSON line per plan set and shape: the
plan, microseconds per launch by CUDA events with the launches queued
behind a sleep kernel (device time; the least over mirrored turns: plan
sets forward, then backward) and without (the wrapper's time, host work
included), the mean device microseconds per launch by torch.profiler, the
weight bytes the launch streams into shared memory, the clusters of the
plan that fit on the card at once (cudaOccupancyMaxActiveClusters) and the
registers and spills ptxas reported for the kernel the plan runs.  Then
one summary line with the sums over the three shapes of each kernel, the
card's name and its power limit.

--root imports ``rpg_ramnet_tpu_torch`` from DIR (for example an unpacked
older commit, to compare in one call; a wrapper without a planner takes no
plan, so the plan set is ``default`` there).  --plans names the plan sets
of this tree's planner: ``auto`` (``plan_k1``) and ``split1`` (``plan_k1``
without the cluster split: the weight ring alone).  --sweep also times
every plan the planner weighs (``k1_plans``) at each shape within 4x of the
cost it estimates for its best, one line each (the lines ``_K1_MODEL`` is
fitted to; gru_hside_sweep.jsonl holds the sweep the committed model was
fitted to).  --gates also builds K1 with the IEEE gates
(-DRAMNET_K1_EXACT_GATES) and gives, at the six shapes under the planner's
plans, the max and mean abs error of h', acts and the ConvGRUHside
Function's gradients against the plain versions for the built kernel and
for the IEEE one on the same inputs, and both kernels' times.  These need
a CUDA device.

--fit reads sweep lines (no device needed) and prints the least-squares
fit of ``_K1_MODEL`` to them: relative error, non-negative weights, three
significant digits, with its median and largest error and the planner's
pick against the swept best at each shape.

--bwd does the same for K2 at the training shapes, one line per plan set
and shape: the plan, queued and wrapper us (mirrored turns), the device
us per call by torch.profiler (all its kernels: the first design's
wrapper also ran two weight-folding copies) and per kernel, the weight
MB one launch streams (the first design's per-item reads where the tree
has no planner), registers and spills, the plain version's queued us and
the max errors of dh and dgx over the plain version's magnitude.  Its one
plan set: ``auto`` (``plan_k2``).  --sweep times every plan ``k2_plans``
weighs within 6x of the cost it estimates for its best, the least of two
timings each (the lines ``_K2_MODEL`` is fitted to;
gru_hside_bwd_sweep.jsonl holds the sweep the committed model was fitted
to), --fit fits ``_K2_MODEL``, and
--profile-train profiles one flagship training step (B=16, L=10, 224^2,
precompute_x, fused_gru 'auto' and 'off') with torch.profiler: device ms
of K1-res and K2, of the ConvGRUHside Function's backward split into
library convolutions and the rest (the a = r*h pass, casts), and of
everything else.

--full does the same for K5 at the flagship per-package shapes (K1's
three), one line per plan set and shape: the plan, queued and wrapper us
(mirrored turns), the device us per launch by torch.profiler, the queued
us of the layer fused_gru='off' runs (two library convolutions and the
gates, timed in the first and the last turn), the plain version's queued
us, the max abs error against it, the weight MB one launch streams (the
first design's per-item reads where the tree has no planner), the shared
memory, registers and spills.  Its plan sets: ``auto`` (``plan_k5``),
``split1`` (``plan_k5`` without the cluster split) and ``fixed`` (no
planner: the largest of pick_tile's tiles that fits with the widest slab,
combo 1, no split).  --sweep times every
plan ``k5_plans`` weighs within 6x of the cost it estimates for its best,
the least of two timings each (the lines ``_K5_MODEL`` is fitted to;
gru_full_sweep.jsonl holds the sweep the committed model was fitted to),
--fit fits ``_K5_MODEL``, --gates builds gru_full.cu with
-DRAMNET_K5_EXACT_GATES and gives both builds' errors and times under the
planner's plans, and --latency-pairs N times the flagship's per-package
latency at 256x512 with fused_gru 'on' (K5) and 'off' in N mirrored pairs
of turns.

--lstm does the same for K3 and K4 at the phased inference shapes (B=1 at
128x176x64, 64x88x128, 32x44x256) and K3 also at the flagship ones (K1's,
where the ConvLSTM state combination runs it), and for K3-res and K4-res
at the phased training shapes (B=8 at 112x112x64, 56x56x128, 28x28x256)
(--kinds picks among k3, k4, k3_res, k4_res), one line per plan set,
kernel and shape with its max and mean abs error against the plain
version beside the times, the weight MB, the shared memory and the
blocks that fit on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
and the plain version's queued time.  On a tree whose K3 and K4 take no
plan (the first design) their plan set is ``default`` and the weight MB
is the first design's (``lstm_first_design_weight_bytes``).  Its plan
sets: ``auto`` (``plan_lstm``), ``split1``, ``split2`` and ``split4``
(``plan_lstm`` with at most that split), ``fixed`` (no planner: the
largest of pick_tile's tiles that fits, warp jobs of 64 pixels, the
widest slab, no split) and ``fixed_split`` (``fixed`` split in two at C
>= 128).  --sweep times every plan ``lstm_plans`` weighs within 6x of the
cost it estimates for its best (K3 and K4: splits up to 4), the least of
two timings each (the lines
``_LSTM_MODEL`` is fitted to; lstm_hside_sweep.jsonl holds the sweep the
committed model was fitted to), --fit fits ``_LSTM_MODEL``, --gates builds
lstm_hside.cu with -DRAMNET_LSTM_EXACT_GATES and gives both builds' errors
(cells, acts and the ConvLSTMHside and PhasedCell Functions' gradients)
and times under the planner's plans, and --profile-train profiles one
phased training step (B=8, L=10, 224^2, fused_gru 'on' and 'off') with
torch.profiler: device ms of K3-res and K4-res, of the Functions'
backward split into library convolutions and the rest, and of everything
else.  --e2e instead times the paths K3 and K4 run on, with the kernels
and with fused_gru='off' in mirrored turns: the phased per-package
latency and maps/s and the phased chunked maps/s at 256x352
(chip_smoke.time_per_package, time_chunked), and the ConvLSTM state
combination's chunked maps/s at 256x512 (the flagship with
state_combination 'convlstm', chip_smoke's two sequences); run it once per
tree (--root) in turns parent, tree, tree, parent to compare two trees.

--variants times the gx-streaming cell K10a and the whole-chunk cell K11
at the flagship shapes, K11 over one chunk's S = 96 steps (K=5), beside
K1 under its own plan and under K11's, and K1 and K1-res under their own
(K1-res at the training shapes), and the pair cells K9 and K10b at the
flagship pair (scales 0 and 1, in the row of scale 0's shape) in the kept
block order and the other, beside the two K1 launches they replace
(``k1_pair``; this tree also under the pair's plans,
``k1_pair_at_k9_plans``), one line per plan set, kernel and shape: queued
us (least of mirrored turns over the plan sets; K10a, K11, K9 and K10b
also unqueued, the wrapper's time, least of two), the plan (K9, K10b: the
plans, the grid and the order), the weight MB per launch (K11: times S),
the registers and spills, K11's grid and the clusters of its plan that
fit at once, and the max abs error against the plain version (K11: every
step against one plain cell on its previous snapshot).  Its plan sets for
K11: ``auto`` (``plan_k11``: one wave of clusters, K10a and the K1 rows
run here), ``split1`` (``plan_k11`` without the cluster split) and
``loop`` (``auto``'s plan on half its
clusters, each looping over two tiles); a tree whose K10a and K11 take no
plan (the first design) runs plan set ``default``.  Its summary line sums
each kernel over the shapes and gives K11's barrier cost per step, (K11 -
S x K1 at K11's plan) / (S - 1), per shape; a last line times the chunk's
forward (ms per 16-package chunk, inputs on the card) and the chunked
path's maps/s (chip_smoke's two sequences) with the default path (K1),
fused_stream='on' (K10a), fused_pair='on' (K9), both (K10b) and
chunk_cells (K11) in mirrored turns.  Run it
once per tree (--root) in turns parent, tree, tree, parent: the least of
the two processes of each tree is its reading.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import chip_smoke   # this tree's helpers; the package comes from --root

FLAGSHIP_CELLS = ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256))
TRAIN_CELLS = ((16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256))
# the shapes each LSTM kernel is timed at
LSTM_CELLS = {"k3": chip_smoke.PHASED_CELLS + chip_smoke.FLAGSHIP_CELLS,
              "k4": chip_smoke.PHASED_CELLS,
              "k3_res": chip_smoke.PHASED_TRAIN_CELLS,
              "k4_res": chip_smoke.PHASED_TRAIN_CELLS}
ITERS = 20   # launches per timed turn
SWEEP_FILE = "gru_hside_sweep.jsonl"
LSTM_SWEEP_FILE = "lstm_hside_sweep.jsonl"
BWD_SWEEP_FILE = "gru_hside_bwd_sweep.jsonl"
FULL_SWEEP_FILE = "gru_full_sweep.jsonl"


def _cost_row(gru_hside, r):
    """(cost terms, waves) of a sweep line's plan: K1's for "k1" and
    "k1_res", K2's for "k2", K5's for "k5", the LSTM kernels' for "k3",
    "k4", "k3_res" and "k4_res"."""
    C = r["shape"][-1]
    if r["sweep"] == "k5":
        plan = gru_hside.K5Plan(*r["plan"])
        return (gru_hside.k5_cost_terms(plan, C),
                gru_hside.plan_waves(plan, *r["shape"][:3]))
    if r["sweep"] == "k2":
        plan = gru_hside.K2Plan(*r["plan"])
        return (gru_hside.k2_cost_terms(plan, C),
                gru_hside.plan_waves(plan, *r["shape"][:3]))
    if r["sweep"] in ("k1", "k1_res"):
        plan = gru_hside.K1Plan(*r["plan"])
        return (gru_hside.k1_cost_terms(plan, C, r["sweep"] == "k1_res"),
                gru_hside.plan_waves(plan, *r["shape"][:3]))
    plan = gru_hside.LstmPlan(*r["plan"])
    phased, res = chip_smoke.lstm_kind(r["sweep"])
    return (gru_hside.lstm_cost_terms(plan, C, phased, res),
            gru_hside.plan_waves(plan, *r["shape"][:3]))


def fit_model(lines, lstm=False, bwd=False, full=False):
    """(model, report): the ``_K1_MODEL`` weights (lstm: ``_LSTM_MODEL``;
    bwd: ``_K2_MODEL``; full: ``_K5_MODEL``) fitted to sweep lines
    ({"sweep": "k1" or "k1_res" (lstm: "k3", "k4", "k3_res" or "k4_res";
    bwd: "k2"; full: "k5"), "shape", "plan", "us"}) by
    non-negative least squares of the relative error, rounded to three
    significant digits, and the fit's median and largest relative error
    and, per shape, the planner's pick under that model against the swept
    best."""
    import numpy as np
    from scipy.optimize import nnls
    from rpg_ramnet_tpu_torch.ops import gru_hside
    rows = [r for r in lines if "sweep" in r]
    keys = list(gru_hside._K2_MODEL if bwd else gru_hside._K5_MODEL if full else
                gru_hside._LSTM_MODEL if lstm else gru_hside._K1_MODEL)
    A, t = [], []
    for r in rows:
        terms, waves = _cost_row(gru_hside, r)
        A.append([waves * terms[k] for k in keys])
        t.append(r["us"])
    A, t = np.array(A, dtype=float), np.array(t, dtype=float)
    coef, _ = nnls(A / t[:, None], np.ones(len(t)))
    model = {k: float(f"{c:.3g}") for k, c in zip(keys, coef)}
    pred = A @ np.array([model[k] for k in keys])
    err = np.abs(pred - t) / t
    picks = {}
    for r, p in zip(rows, pred):
        key = f"{r['sweep']} {'x'.join(map(str, r['shape']))}"
        best, pick = picks.setdefault(key, [None, None])
        if best is None or r["us"] < best[1]:
            picks[key][0] = (r["plan"], r["us"])
        if pick is None or p < pick[2]:
            picks[key][1] = (r["plan"], r["us"], p)
    report = {"plans": len(rows), "median_rel_err": float(np.median(err)),
              "max_rel_err": float(err.max()),
              "picks": {k: {"swept_best": b[0], "best_us": b[1],
                            "model_pick": p[0], "pick_us": p[1],
                            "pick_over_best": p[1] / b[1]}
                        for k, (b, p) in picks.items()}}
    return model, report


def exact_gates_library(gru_hside, kernels):
    """csrc/gru_hside.cu built with -DRAMNET_K1_EXACT_GATES, loaded with the
    wrapper's signatures."""
    return kernels.library("gru_hside", gru_hside._FWD_SIGNATURES,
                           ("RAMNET_K1_EXACT_GATES",))


def gate_errors(torch, gru_hside, kernels, cases, dev):
    """Per shape, for the built kernel ("fast") and the IEEE gates'
    ("exact"), [max abs error, mean abs error, the plain version's max
    magnitude] against the plain versions of h' (K1) or h', acts and the
    Function's four gradients (K1-res), and each build's device us per
    launch (queued, least of mirrored turns)."""
    built = gru_hside.library
    exact = exact_gates_library(gru_hside, kernels)
    builds = {"fast": built, "exact": lambda: exact}
    gen = torch.Generator().manual_seed(1)

    def errs(got, want):
        d = (got.float() - want.float()).abs()
        return [d.max().item(), d.mean().item(), want.float().abs().max().item()]

    lines = []
    for kind, shape, (h, gx, w_ur, w_o) in cases:
        row = {"gates": kind, "shape": list(shape)}
        if kind == "k1":
            want = (gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o),)
            names, run = ("h",), lambda: (gru_hside.conv_gru_hside(h, gx, w_ur, w_o),)
        else:
            g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            want_h, want_acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
            args = [t.detach().clone().requires_grad_() for t in (h, gx, w_ur, w_o)]
            plain_out = gru_hside.conv_gru_hside_res_plain(*args)[0]
            want = (want_h, want_acts) + torch.autograd.grad(plain_out, args, g)
            names = ("h", "acts", "dh", "dgx", "dw_ur", "dw_o")

            def run():
                got = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o)
                a = [t.detach().clone().requires_grad_() for t in (h, gx, w_ur, w_o)]
                return got + torch.autograd.grad(gru_hside.ConvGRUHside.apply(*a), a, g)
        fn = (lambda: gru_hside.conv_gru_hside(h, gx, w_ur, w_o)) if kind == "k1" \
            else (lambda: gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o))
        turns = {}
        for b in ("fast", "exact", "exact", "fast"):
            gru_hside.library = builds[b]
            if b not in row:
                got = run()
                torch.cuda.synchronize()
                row[b] = {n: errs(x, y) for n, x, y in zip(names, got, want)}
            turns.setdefault(b, []).append(chip_smoke.cuda_time_us(fn, ITERS, queued=True))
        gru_hside.library = built
        row["us"] = {b: min(v) for b, v in turns.items()}
        row["us_turns"] = turns
        lines.append(row)
    return lines


def lstm_fixed_plan(gru_hside, shape, kind, split_wide):
    """A plan without the planner: the largest of pick_tile's tiles that
    fits with the widest slab, warp jobs of 64 pixels, no split
    (split_wide: two blocks per tile at C >= 128)."""
    B, H, W, C = shape
    split = 2 if split_wide and C >= 128 else 1
    phased, res = chip_smoke.lstm_kind(kind)
    for th, tw in gru_hside._TILES:
        for ks in (64, 32, 16):
            if C % ks == 0 and gru_hside.lstm_smem_bytes(
                    th, tw, C, split, ks, phased, res) <= gru_hside._SMEM_MAX:
                return gru_hside.LstmPlan(min(th, H), min(tw, W), split, 0, ks)
    raise ValueError(f"no fixed plan fits at {shape}")


def lstm_plan_of(gru_hside, plans, kind, shape):
    """The plan of a plan set (see the module's docstring) for an LSTM
    kernel at shape; None for ``default`` (the wrapper's own)."""
    phased, res = chip_smoke.lstm_kind(kind)
    if plans == "auto":
        return gru_hside.plan_lstm(*shape, phased=phased, residuals=res)
    if plans in ("split1", "split2", "split4"):
        return gru_hside.plan_lstm(*shape, phased=phased, residuals=res,
                                   max_split=int(plans[-1]))
    if plans in ("fixed", "fixed_split"):
        return lstm_fixed_plan(gru_hside, shape, kind, plans == "fixed_split")
    return None


def lstm_first_design_smem_bytes(tile_h, tile_w, C):
    """The first K3/K4 design's footprint: the conv operand's tile with a
    1-pixel halo at pitch C + 8, bf16."""
    return (tile_h + 2) * (tile_w + 2) * (C + 8) * 2


def lstm_first_design_weight_bytes(gru_hside, B, H, W, C):
    """The weight bytes of one launch of the first K3/K4 design: per block
    (pick_tile with its footprint) and 32-pixel x 16-channel warp item, 9
    taps x 4 gates x 16 channels x the C contraction, bf16.  (With tiles
    of 32 pixels or more and no ragged edge, 2.25*B*H*W*C^2.)"""
    th, tw = gru_hside.pick_tile(B, H, W, C, smem=lstm_first_design_smem_bytes)
    blocks = B * -(-H // th) * -(-W // tw)
    return blocks * -(-th * tw // 32) * (C // 16) * 9 * 4 * 16 * C * 2


def lstm_first_design_ptxas(ptxas, kind):
    """The ptxas entry of the first design's lstm_hside_kernel<kPhased>
    (K3, K4) in an older tree's build."""
    flag = f"ILb{int(chip_smoke.lstm_kind(kind)[0])}E"
    return next((info for name, info in ptxas.items()
                 if "lstm_hside_kernel" in name and flag in name), None)


def lstm_function_grads(torch, gru_hside, phased_cell, inputs, phased, cots,
                        fused):
    """Gradients of sum(out * cot) over every tensor input of the
    ConvLSTMHside (phased: PhasedCell) Function (fused) or of the plain
    version under autograd, on the same bf16 inputs."""
    h, c, gx, w4, tau, phase, t = inputs
    args = [v.detach().clone().requires_grad_()
            for v in ((h, c, gx, w4, tau, phase, t) if phased else (h, c, gx, w4))]
    if phased:
        outs = (phased_cell.PhasedCell.apply(*args) if fused
                else phased_cell.conv_lstm_phased_res_plain(*args)[:3])
    else:
        outs = (gru_hside.ConvLSTMHside.apply(*args) if fused
                else gru_hside.conv_lstm_hside_res_plain(*args)[:2])
    return torch.autograd.grad(outs, args, cots[:len(outs)])


def lstm_gate_errors(torch, gru_hside, phased_cell, cases, dev):
    """Per kernel and shape under the planner's plan, for the built kernel
    ("fast") and the IEEE gates' ("exact"): [max abs error, mean abs
    error, the plain version's max magnitude] of each output (K3-res,
    K4-res: acts and each gradient of the Function) against the plain
    versions, and each build's device us per launch (queued, least of
    mirrored turns)."""
    gen = torch.Generator().manual_seed(1)
    lines = []
    for kind, shape, inputs in cases:
        phased, res = chip_smoke.lstm_kind(kind)
        kern, plain = chip_smoke.lstm_calls(inputs, kind)
        cots = [torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                for _ in range(3)]
        with torch.no_grad():
            want = plain()
        want_g = (lstm_function_grads(torch, gru_hside, phased_cell, inputs,
                                      phased, cots, False) if res else ())
        row = {"gates": kind, "shape": list(shape)}
        turns = {}
        for build in ("fast", "exact", "exact", "fast"):
            with chip_smoke.lstm_gates(build):
                if build not in row:
                    with torch.no_grad():
                        got = kern()
                    got_g = (lstm_function_grads(torch, gru_hside, phased_cell,
                                                 inputs, phased, cots, True)
                             if res else ())
                    torch.cuda.synchronize()
                    row[build] = [chip_smoke.abs_errs(a, b) + [b.float().abs().max().item()]
                                  for a, b in zip(got + got_g, want + want_g)]
                with torch.no_grad():
                    turns.setdefault(build, []).append(
                        chip_smoke.cuda_time_us(kern, ITERS, queued=True))
        names = (["h_t", "h_new", "c_new", "acts", "dc0", "dh0", "dgx", "dw4",
                  "dtau", "dphase", "dt"] if phased else
                 ["h", "c", "acts", "dh", "dc", "dgx", "dw4"])
        row["names"] = names if res else names[:3 if phased else 2]
        row["us"] = {b: min(v) for b, v in turns.items()}
        row["us_turns"] = turns
        lines.append(row)
    return lines


def _kernel_ms(torch, prof, steps):
    """{kernel name: device us per step} of a profiled run of steps."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {}
    for e in prof.events():
        if e.device_type == cuda:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time / steps
    return kernels


def _backward_split(torch, prof, steps, functions, node_self=True):
    """Per autograd Function in ``functions``: [library conv us, other us,
    outermost backward nodes, {op name: us}] per step, the device time of
    every op under its outermost backward node (node_self: and of the node
    itself, where the profiler puts kernels launched by hand), split by
    whether an op's name (or an enclosing op's) holds 'conv'."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    out = {fn: [0.0, 0.0, 0, {}] for fn in functions}

    def walk(e, fn, conv):
        conv = conv or "conv" in e.name
        out[fn][0 if conv else 1] += dev_us(e) / steps
        out[fn][3][e.name] = out[fn][3].get(e.name, 0.0) + dev_us(e) / steps
        for ch in e.cpu_children:
            walk(ch, fn, conv)

    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        for fn in functions:
            if f"{fn}Backward" in e.name:
                p = e.cpu_parent
                while p is not None and f"{fn}Backward" not in p.name:
                    p = p.cpu_parent
                if p is None:   # the outermost event of this backward
                    out[fn][2] += 1
                    if node_self:
                        walk(e, fn, False)
                        continue
                    for ch in e.cpu_children:
                        walk(ch, fn, False)
    return out


def step_split(torch, prof, steps):
    """A profiled phased training step's device ms per step: all of it,
    K3-res's and K4-res's kernels, the ConvLSTMHside and PhasedCell
    Functions' backward split into library convolutions (kernels under an
    op whose name holds 'conv') and the rest (the elementwise chain), and
    what is left; the backward nodes counted; the 15 kernels of most
    time."""
    kernels = _kernel_ms(torch, prof, steps)
    total = sum(kernels.values())
    fwd = {k: sum(v for n, v in kernels.items()
                  if f"lstm_kernel<{'true' if k == 'k4' else 'false'}, true," in n)
           for k in ("k3", "k4")}
    bwd = _backward_split(torch, prof, steps, ("ConvLSTMHside", "PhasedCell"))
    out = {"device_ms": total / 1e3, "k3_res_ms": fwd["k3"] / 1e3,
           "k4_res_ms": fwd["k4"] / 1e3}
    for fn, (conv, rest, n, _) in bwd.items():
        out[f"{fn}_bwd"] = {"library_conv_ms": conv / 1e3, "rest_ms": rest / 1e3,
                            "nodes_per_step": n / steps}
    out["rest_ms"] = out["device_ms"] - out["k3_res_ms"] - out["k4_res_ms"] - sum(
        sum(v[:2]) for v in bwd.values()) / 1e3
    out["top_kernels_ms"] = {n: v / 1e3 for n, v in sorted(
        kernels.items(), key=lambda kv: -kv[1])[:15]}
    return out


def gru_step_split(torch, prof, steps):
    """A profiled flagship training step's device ms per step: all of it,
    K1-res's and K2's kernels (by name), the ops under the ConvGRUHside
    Function's outermost backward node (K2, as the node's own time; with
    per-package checkpointing also the recompute of the package's forward,
    K1-res under "ConvGRUHside" among it; the weight gradients' library
    convolutions, aten::convolution_backward; the a = r*h product and the
    casts) split by whether an op's name holds 'conv', with the ops of most
    time, and the device time outside that node; the 15 kernels of most
    time."""
    kernels = _kernel_ms(torch, prof, steps)
    total = sum(kernels.values())
    k1_res = sum(v for n, v in kernels.items() if "k1_kernel<true" in n
                 or "gru_hside_kernel<true" in n)
    k2 = sum(v for n, v in kernels.items() if "k2_kernel" in n
             or "gru_hside_bwd_kernel" in n)
    conv, rest, n, ops = _backward_split(torch, prof, steps, ("ConvGRUHside",),
                                         node_self=False)["ConvGRUHside"]
    out = {"device_ms": total / 1e3, "k1_res_ms": k1_res / 1e3, "k2_ms": k2 / 1e3,
           "ConvGRUHside_bwd": {"node_ms": (conv + rest) / 1e3,
                                "library_conv_ms": conv / 1e3, "other_ms": rest / 1e3,
                                "nodes_per_step": n / steps,
                                "ops_ms": {k: v / 1e3 for k, v in sorted(
                                    ops.items(), key=lambda kv: -kv[1])[:12]}},
           "outside_node_ms": (total - conv - rest) / 1e3}
    out["top_kernels_ms"] = {n: v / 1e3 for n, v in sorted(
        kernels.items(), key=lambda kv: -kv[1])[:15]}
    return out


def profile_train(torch, dev, seed=0, steps=1, recipe="phased"):
    """One training step with the kernels and with fused_gru 'off', after
    a warm-up step each: the phased recipe (B=8, L=10, 224^2,
    chip_smoke's phased_train_config, fused_gru 'on') or the flagship
    ("gru": B=16, L=10, 224^2, train_config with precompute_x, 'auto'):
    the host wall ms of the step and ``step_split`` (``gru_step_split``)
    of its torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    from rpg_ramnet_tpu_torch.core.config import Config, ModelConfig
    from rpg_ramnet_tpu_torch.models import event_loop_range
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_train_step
    K = event_loop_range(ModelConfig.load(os.path.join(chip_smoke.ROOT, chip_smoke.CONFIG)))
    cells = 3 * (K + 1) * chip_smoke.TRAIN_L
    out = {}
    with tempfile.TemporaryDirectory(prefix="ramnet_profile_train_") as tmp:
        data = os.path.join(tmp, "data")
        if recipe == "gru":
            chip_smoke.write_train_data(data, K, seed + 11)
            cfg = Config.from_dict(chip_smoke.train_config(tmp))
            counters = {"k1_res": (gru_hside.conv_gru_hside_res, 2 * cells),
                        "k2": (gru_hside.conv_gru_hside_bwd, cells)}
        else:
            chip_smoke.write_train_data(data, K, seed + 11,
                                        batch=chip_smoke.PHASED_TRAIN_B)
            cfg = Config.from_dict(chip_smoke.phased_train_config(tmp))
            counters = {"k4_res": (phased_cell.conv_lstm_phased_res, 2 * cells),
                        "k3_res": (gru_hside.conv_lstm_hside_res, 2 * cells)}
        batch, models, first = chip_smoke.first_step_vs_off(cfg, data, dev, seed, counters)
    out["first_step_vs_off"] = first
    split = gru_step_split if recipe == "gru" else step_split
    for mode, model in models.items():
        c = dataclasses.replace(cfg, model=model.cfg)
        step = make_train_step(c, model, make_optimizer(c, model.parameters()))
        step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
        out[mode] = {"wall_ms": wall * 1e3, **split(torch, prof, steps)}
    if recipe == "gru":
        out["seq_per_s"] = chip_smoke.time_training(cfg, models, batch)
    return out


def k2_first_design_weight_bytes(gru_hside, B, H, W, C):
    """The weight bytes of one launch of the first K2 design: per
    block (pick_tile with smem_bytes_bwd) and 32-pixel x 16-channel warp
    item, 9 taps x 16 channels x the contraction (C for da on the 1-pixel
    ring, 2C for dh on the tile), bf16."""
    th, tw = gru_hside.pick_tile(B, H, W, C, smem=gru_hside.smem_bytes_bwd)
    blocks = B * -(-H // th) * -(-W // tw)
    items = (-(-(th + 2) * (tw + 2) // 32) * C // 16, -(-th * tw // 32) * C // 16)
    return blocks * (items[0] * 9 * 16 * C + items[1] * 9 * 16 * 2 * C) * 2


def bwd_main(args, torch) -> int:
    """--bwd: K2 (see the module's docstring)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    gru_hside.library_bwd()   # built here, so the build log has its ptxas report
    ptxas = chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_hside_bwd", ""))
    planned = hasattr(gru_hside, "plan_k2")
    sets = (args.plans or "auto").split(",") if planned else ["default"]
    label = args.label or ("tree" if planned else "default")
    gen = torch.Generator().manual_seed(0)
    cases = [(s, chip_smoke.make_bwd_inputs(s, dev, gen)) for s in TRAIN_CELLS]

    def plan_of(plan_set, shape):
        if plan_set == "auto":
            return gru_hside.plan_k2(*shape)
        if plan_set == "default":
            return None
        raise ValueError(f"--bwd has no plan set {plan_set!r}")

    def call(plan, inputs):
        kw = {"_plan": plan} if plan is not None else {}
        return lambda: gru_hside.conv_gru_hside_bwd(*inputs, **kw)

    times, wrapper = {}, {}
    for plan_set in sets + sets[::-1]:   # mirrored turns
        for shape, inputs in cases:
            fn = call(plan_of(plan_set, shape), inputs)
            key = (plan_set, shape)
            times.setdefault(key, []).append(chip_smoke.cuda_time_us(fn, ITERS, queued=True))
            wrapper.setdefault(key, []).append(chip_smoke.cuda_time_us(fn, ITERS))
    lines, sums, plain_us = [], {}, {}
    for plan_set in sets:
        for shape, inputs in cases:
            plan = plan_of(plan_set, shape)
            key = (plan_set, shape)
            fn = call(plan, inputs)
            plain = lambda: gru_hside.conv_gru_hside_bwd_plain(*inputs)  # noqa: E731
            got, want = fn(), plain()
            if shape not in plain_us:
                plain_us[shape] = min(chip_smoke.cuda_time_us(plain, ITERS, queued=True)
                                      for _ in range(2))
            dev_us, names = chip_smoke.device_time_us(fn, 10)
            row = {"label": label, "plans": plan_set, "shape": list(shape),
                   "plan": plan._asdict() if plan else None,
                   "us": min(times[key]), "us_turns": times[key],
                   "wrapper_us": min(wrapper[key]), "wrapper_us_turns": wrapper[key],
                   "device_us_per_call": dev_us, "device_us_by_kernel": names,
                   "plain_us": plain_us[shape],
                   "rel_err": [chip_smoke.rel_err(a, b) for a, b in zip(got, want)],
                   "weight_mb": (gru_hside.k2_weight_bytes(plan, *shape) if plan else
                                 k2_first_design_weight_bytes(gru_hside, *shape)) / 1e6}
            if plan is not None:
                row["smem_bytes"] = gru_hside.k2_smem_bytes(
                    plan.tile_h, plan.tile_w, shape[-1], plan.ks)
            row["ptxas"] = chip_smoke.k2_ptxas(
                ptxas, gru_hside.K2_COMBOS[plan.combo] if plan else None)
            for name, v in (("us", row["us"]), ("wrapper_us", row["wrapper_us"])):
                sums[f"{plan_set}_k2_{name}"] = sums.get(f"{plan_set}_k2_{name}", 0.0) + v
            print(json.dumps(row), flush=True)
    if args.sweep and planned:
        for shape, inputs in cases:
            plans = gru_hside.k2_plans(*shape)
            best = min(gru_hside._k2_cost(p, *shape) for p in plans)
            for plan in plans:
                if gru_hside._k2_cost(plan, *shape) > 6 * best:
                    continue
                lines.append({"sweep": "k2", "shape": list(shape), "plan": list(plan),
                              "us": min(chip_smoke.cuda_time_us(call(plan, inputs), 10,
                                                                queued=True)
                                        for _ in range(2))})
    if args.profile_train:
        del cases
        torch.cuda.empty_cache()
        lines.append({"profile_train": profile_train(torch, dev, recipe="gru")})
    lines.append({"label": label, "summary": sums, "nvidia_smi": smi,
                  "torch": torch.__version__, "cuda": torch.version.cuda})
    for row in lines:
        print(json.dumps(row), flush=True)
    return 0


def full_main(args, torch) -> int:
    """--full: K5 (see the module's docstring)."""
    from rpg_ramnet_tpu_torch.ops import gru_hside
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    gru_hside.library_full()   # built here, so the build log has its ptxas report
    planned = hasattr(gru_hside, "plan_k5")
    sets = (args.plans or "auto").split(",") if planned else ["default"]
    label = args.label or ("tree" if planned else "default")
    gen = torch.Generator().manual_seed(0)
    cases = [(s, chip_smoke.make_full_cell_inputs(s, dev, gen)) for s in FLAGSHIP_CELLS]
    for _, (cell, *_) in cases:
        cell.to(dev)

    def plan_of(plan_set, shape):
        if plan_set == "auto":
            return gru_hside.plan_k5(*shape)
        if plan_set == "split1":
            return gru_hside.plan_k5(*shape, max_split=1)
        if plan_set == "fixed":
            return k5_fixed_plan(gru_hside, shape)
        if plan_set == "default":
            return None
        raise ValueError(f"--full has no plan set {plan_set!r}")

    def calls(plan, inputs):
        cell, x, h, w = inputs
        return chip_smoke.full_cell_calls(cell, x, h, w, plan)

    times, wrapper, layer_times = {}, {}, {}
    with torch.no_grad():
        for turn, plan_set in enumerate(sets + sets[::-1]):   # mirrored turns
            for shape, inputs in cases:
                kern, _, layer = calls(plan_of(plan_set, shape), inputs)
                key = (plan_set, shape)
                if turn in (0, 2 * len(sets) - 1):   # the 'off' layer, first and last
                    layer_times.setdefault(shape, []).append(
                        chip_smoke.cuda_time_us(layer, ITERS, queued=True))
                times.setdefault(key, []).append(
                    chip_smoke.cuda_time_us(kern, ITERS, queued=True))
                wrapper.setdefault(key, []).append(chip_smoke.cuda_time_us(kern, ITERS))
    lines, sums, plain_us = [], {}, {}
    for plan_set in sets:
        for shape, inputs in cases:
            plan = plan_of(plan_set, shape)
            key = (plan_set, shape)
            kern, plain, _ = calls(plan, inputs)
            with torch.no_grad():
                got, want = kern(), plain()
                if shape not in plain_us:
                    plain_us[shape] = min(chip_smoke.cuda_time_us(plain, ITERS, queued=True)
                                          for _ in range(2))
                dev_us, records = chip_smoke.launch_device_us(kern, 10)
            row = {"label": label, "plans": plan_set, "shape": list(shape),
                   "us": min(times[key]), "us_turns": times[key],
                   "wrapper_us": min(wrapper[key]), "wrapper_us_turns": wrapper[key],
                   "device_us": dev_us, "device_records": records,
                   "off_layer_us": min(layer_times[shape]),
                   "off_layer_us_turns": layer_times[shape],
                   "plain_us": plain_us[shape],
                   "max_abs_err": (got.float() - want.float()).abs().max().item(),
                   **k5_report(gru_hside, shape, plan)}
            if plan is not None:
                row["smem_bytes"] = gru_hside.k5_smem_bytes(
                    plan.tile_h, plan.tile_w, shape[-1], plan.split, plan.ks)
            for name, v in (("us", row["us"]), ("wrapper_us", row["wrapper_us"]),
                            ("off_layer_us", row["off_layer_us"])):
                sums[f"{plan_set}_k5_{name}"] = sums.get(f"{plan_set}_k5_{name}", 0.0) + v
            print(json.dumps(row), flush=True)
    if args.sweep and planned:
        with torch.no_grad():
            for shape, inputs in cases:
                plans = gru_hside.k5_plans(*shape)
                best = min(gru_hside._k5_cost(p, *shape) for p in plans)
                for plan in plans:
                    if gru_hside._k5_cost(plan, *shape) > 6 * best:
                        continue
                    kern = calls(plan, inputs)[0]
                    lines.append({"sweep": "k5", "shape": list(shape), "plan": list(plan),
                                  "us": min(chip_smoke.cuda_time_us(kern, 10, queued=True)
                                            for _ in range(2))})
    if args.gates and planned:
        lines += full_gate_errors(torch, gru_hside, cases, calls)
    if args.latency_pairs:
        del cases
        torch.cuda.empty_cache()
        lines.append({"per_package_pairs": per_package_pairs(torch, dev, args.latency_pairs)})
    lines.append({"label": label, "summary": sums, "nvidia_smi": smi,
                  "torch": torch.__version__, "cuda": torch.version.cuda})
    for row in lines:
        print(json.dumps(row), flush=True)
    return 0


def k5_first_design_smem_bytes(tile_h, tile_w, C):
    """The first K5 design's footprint: [x | h] with a 2-pixel halo at
    pitch 2C + 8 and a = r*h with a 1-pixel ring at pitch C + 8, bf16."""
    return ((tile_h + 4) * (tile_w + 4) * (2 * C + 8)
            + (tile_h + 2) * (tile_w + 2) * (C + 8)) * 2


def k5_first_design_weight_bytes(gru_hside, B, H, W, C):
    """The weight bytes of one launch of the first K5 design: per block
    (pick_tile with its footprint) and 32-pixel x 16-channel warp item,
    9 taps x 16 channels x the 2C contraction (r on the 1-pixel ring; z and
    o on the tile), bf16."""
    th, tw = gru_hside.pick_tile(B, H, W, C, smem=k5_first_design_smem_bytes)
    blocks = B * -(-H // th) * -(-W // tw)
    items = (-(-(th + 2) * (tw + 2) // 32) * C // 16, -(-th * tw // 32) * C // 16)
    return blocks * (items[0] + 2 * items[1]) * 9 * 16 * 2 * C * 2


def k5_report(gru_hside, shape, plan):
    """chip_smoke.k5_report's plan, weight MB and ptxas entry; on a tree
    from before ``plan_k5`` (plan None) the first design's weight bytes
    and the ptxas entry of its gru_full_kernel."""
    if plan is not None:
        return chip_smoke.k5_report(shape, plan)
    from rpg_ramnet_tpu_torch import kernels
    ptxas = chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_full", ""))
    return {"plan": None,
            "weight_mb": k5_first_design_weight_bytes(gru_hside, *shape) / 1e6,
            "ptxas": next((info for name, info in ptxas.items()
                           if "gru_full_kernel" in name), None)}


def k5_fixed_plan(gru_hside, shape):
    """A K5 plan without the planner: the largest of pick_tile's tiles that
    fits with the widest slab, combo 1 (warp jobs of 64 pixels x 32
    channels of r, 32 x 32 of z and o), no split."""
    B, H, W, C = shape
    for th, tw in gru_hside._TILES:
        for ks in (64, 32, 16):
            if C % ks == 0 and gru_hside.k5_smem_bytes(th, tw, C, 1, ks) <= gru_hside._SMEM_MAX:
                return gru_hside.K5Plan(min(th, H), min(tw, W), 1, 1, ks)
    raise ValueError(f"no fixed plan fits at {shape}")


def full_gate_errors(torch, gru_hside, cases, calls):
    """Per shape under the planner's plan, for the built K5 ("fast") and
    the IEEE gates' ("exact"): [max abs error, mean abs error] against the
    plain version, and each build's device us per launch (queued, least of
    mirrored turns)."""
    lines = []
    for shape, inputs in cases:
        kern, plain, _ = calls(None, inputs)
        row = {"gates": "k5", "shape": list(shape)}
        turns = {}
        with torch.no_grad():
            want = plain()
            for build in ("fast", "exact", "exact", "fast"):
                with chip_smoke.k5_gates(build):
                    if build not in row:
                        got = kern()
                        torch.cuda.synchronize()
                        row[build] = chip_smoke.abs_errs(got, want)
                    turns.setdefault(build, []).append(
                        chip_smoke.cuda_time_us(kern, ITERS, queued=True))
        row["us"] = {b: min(v) for b, v in turns.items()}
        row["us_turns"] = turns
        lines.append(row)
    return lines


def per_package_pairs(torch, dev, pairs, seed=0):
    """Per-package latency of the flagship's streaming engine at 256x512,
    fused_gru 'on' (K5) against 'off', in ``pairs`` mirrored pairs of turns
    (off, on, on, off, ...; chip_smoke.time_per_package), one model's
    weights in both."""
    import dataclasses
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, event_loop_range
    cfg = ModelConfig.load(os.path.join(chip_smoke.ROOT, chip_smoke.CONFIG))
    K = event_loop_range(cfg)
    models = {}
    for mode in ("on", "off"):
        models[mode] = ERGB2DepthRecurrent(
            dataclasses.replace(cfg, fused_gru=mode), device=dev,
            generator=torch.Generator().manual_seed(seed))
    turns = (("off", "on"), ("on", "off")) * (pairs // 2) + (("off", "on"),) * (pairs % 2)
    return chip_smoke.time_per_package(models, K, seed,
                                       turns=tuple(m for pair in turns for m in pair))


def lstm_e2e(args, torch) -> int:
    """--lstm --e2e: the paths K3 and K4 run on, with the kernels and with
    fused_gru='off' (see the module's docstring); one JSON line."""
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, event_loop_range
    dev = torch.device("cuda")
    cs = chip_smoke
    cfg = ModelConfig.load(os.path.join(cs.ROOT, cs.CONFIG))
    K = event_loop_range(cfg)
    seed = 0
    pcfg = dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in cs.PHASED.items()})
    lcfg = dataclasses.replace(cfg, state_combination="convlstm")
    out = {"label": args.label or "tree", "nvidia_smi": cs.nvidia_smi_line()}
    for name, c, on in (("phased", pcfg, "on"), ("lstm_state_combination", lcfg, "auto")):
        models = {}
        for mode in (on, "off"):
            models["on" if mode == on else "off"] = ERGB2DepthRecurrent(
                dataclasses.replace(c, fused_gru=mode), device=dev,
                generator=torch.Generator().manual_seed(seed + 2))
        with torch.no_grad():
            if name == "phased":
                out["phased_per_package"] = cs.time_per_package(
                    models, K, seed, h=cs.PHASED_H, w=cs.PHASED_W, times=True)
                data = cs.SyntheticDataset(cs.PHASED_SEQ_LENGTHS, K, seed,
                                           h=cs.PHASED_H, w=cs.PHASED_W, times=True)
                packages = sum(-(-n // cs.PHASED_CHUNK) * cs.PHASED_CHUNK
                               for n in cs.PHASED_SEQ_LENGTHS)
                out["phased_chunked"] = cs.time_chunked(models, data, cs.PHASED_CHUNK,
                                                        packages, K)
            else:
                data = cs.SyntheticDataset(cs.SEQ_LENGTHS, K, seed)
                packages = sum(-(-n // cs.CHUNK) * cs.CHUNK for n in cs.SEQ_LENGTHS)
                out["lstm_state_combination_chunked"] = cs.time_chunked(
                    models, data, cs.CHUNK, packages, K)
        del models
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def lstm_main(args, torch) -> int:
    """--lstm: K3, K4, K3-res and K4-res (see the module's docstring)."""
    import inspect
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
    if args.e2e:
        return lstm_e2e(args, torch)
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    lib = gru_hside.library_lstm()
    ptxas = chip_smoke.ptxas_by_kernel(kernels.build_log.get("lstm_hside", ""))
    # a tree from before K3 and K4 took plans: its planner has no residuals
    # argument (it plans K3-res and K4-res alone) and its K3 and K4 take none
    new_api = "residuals" in inspect.signature(gru_hside.plan_lstm).parameters
    kinds = (args.kinds or "k3,k4,k3_res,k4_res").split(",")
    sets = (args.plans or "auto,split1").split(",")
    label = args.label or ("tree" if new_api else "parent")
    gen = torch.Generator().manual_seed(0)
    inputs_of, cases = {}, []
    for kind in kinds:
        for shape in LSTM_CELLS[kind]:
            if shape not in inputs_of:
                inputs_of[shape] = chip_smoke.make_lstm_inputs(shape, dev, gen)
            cases.append((kind, shape, inputs_of[shape]))

    def plan_of(plan_set, kind, shape):
        phased, res = chip_smoke.lstm_kind(kind)
        if new_api:
            return lstm_plan_of(gru_hside, plan_set, kind, shape)
        if not res or plan_set not in ("auto", "split1"):
            return None
        return gru_hside.plan_lstm(*shape, phased=phased,
                                   max_split=1 if plan_set == "split1" else 2)

    def call(kind, plan, inputs):
        kern = chip_smoke.lstm_calls(inputs, kind)[0]
        return (lambda: kern(_plan=plan)) if plan is not None else kern

    # the plan sets each case runs: one, "default", where the tree's
    # wrapper takes no plan
    runs = [(plan_set if new_api or kind.endswith("_res") else "default", kind, shape,
             inputs) for plan_set in sets for kind, shape, inputs in cases]
    runs = list({(r[0], r[1], r[2]): r for r in runs}.values())
    times, wrapper = {}, {}
    with torch.no_grad():
        for plan_set, kind, shape, inputs in runs + runs[::-1]:   # mirrored turns
            fn = call(kind, plan_of(plan_set, kind, shape), inputs)
            key = (plan_set, kind, shape)
            times.setdefault(key, []).append(
                chip_smoke.cuda_time_us(fn, ITERS, queued=True))
            wrapper.setdefault(key, []).append(chip_smoke.cuda_time_us(fn, ITERS))
    lines, sums, plain_us = [], {}, {}
    for plan_set, kind, shape, inputs in runs:   # one line each, printed as it comes
        phased, res = chip_smoke.lstm_kind(kind)
        plan = plan_of(plan_set, kind, shape)
        key = (plan_set, kind, shape)
        fn = call(kind, plan, inputs)
        plain = chip_smoke.lstm_calls(inputs, kind)[1]
        with torch.no_grad():
            want, got = plain(), fn()
            if (kind, shape) not in plain_us:
                plain_us[(kind, shape)] = min(
                    chip_smoke.cuda_time_us(plain, ITERS, queued=True)
                    for _ in range(2))
            dev_us, records = chip_smoke.launch_device_us(fn, 10)
        e = [chip_smoke.abs_errs(a, b) for a, b in zip(got, want)]
        row = {"label": label, "plans": plan_set, "kernel": kind,
               "shape": list(shape), "plan": plan._asdict() if plan else None,
               "us": min(times[key]), "us_turns": times[key],
               "wrapper_us": min(wrapper[key]), "wrapper_us_turns": wrapper[key],
               "device_us": dev_us, "device_records": records,
               "plain_us": plain_us[(kind, shape)],
               "max_abs_err": max(v[0] for v in e),
               "mean_abs_err": max(v[1] for v in e)}
        C = shape[-1]
        if plan is None:
            row["weight_mb"] = lstm_first_design_weight_bytes(gru_hside, *shape) / 1e6
            row["ptxas"] = lstm_first_design_ptxas(ptxas, kind)
        else:
            row["weight_mb"] = gru_hside.lstm_weight_bytes(plan, *shape) / 1e6
            mr = gru_hside.LSTM_COMBOS[plan.combo]
            if new_api:
                row.update({
                    "smem_bytes": gru_hside.lstm_smem_bytes(
                        plan.tile_h, plan.tile_w, C, plan.split, plan.ks, phased, res),
                    "blocks_per_sm": lib.ramnet_lstm_blocks_per_sm(
                        int(phased), int(res), C, *plan),
                    "ptxas": chip_smoke.lstm_ptxas(ptxas, kind, mr)})
            else:   # the older tree's -res kernels: lstm_kernel<kPhased, MR>
                row.update({
                    "smem_bytes": gru_hside.lstm_smem_bytes(
                        plan.tile_h, plan.tile_w, C, plan.split, plan.ks, phased),
                    "blocks_per_sm": lib.ramnet_lstm_blocks_per_sm(int(phased), C, *plan),
                    "ptxas": next((info for name, info in ptxas.items() if
                                   f"11lstm_kernelILb{int(phased)}ELi{mr}EE" in name),
                                  None)})
        for name, v in (("us", row["us"]), ("wrapper_us", row["wrapper_us"])):
            sums[f"{plan_set}_{kind}_{name}"] = sums.get(
                f"{plan_set}_{kind}_{name}", 0.0) + v
        print(json.dumps(row), flush=True)
    if args.sweep and new_api:
        with torch.no_grad():
            for kind, shape, inputs in cases:
                phased, res = chip_smoke.lstm_kind(kind)
                plans = gru_hside.lstm_plans(*shape, phased=phased, residuals=res,
                                             max_split=None if res else 4)
                cost = {p: gru_hside._lstm_cost(p, *shape, phased, res) for p in plans}
                best = min(cost.values())
                for plan in plans:
                    if cost[plan] > 6 * best:
                        continue
                    lines.append({
                        "sweep": kind, "shape": list(shape), "plan": list(plan),
                        "us": min(chip_smoke.cuda_time_us(call(kind, plan, inputs), 10,
                                                          queued=True)
                                  for _ in range(2))})
    if args.gates and new_api:
        lines += lstm_gate_errors(torch, gru_hside, phased_cell, cases, dev)
    if args.profile_train:
        del cases, inputs_of
        torch.cuda.empty_cache()
        lines.append({"profile_train": profile_train(torch, dev)})
    lines.append({"label": label, "summary": sums, "nvidia_smi": smi,
                  "torch": torch.__version__, "cuda": torch.version.cuda})
    for row in lines:
        print(json.dumps(row), flush=True)
    return 0


VARIANT_STEPS = 96   # K11's steps: one 16-package chunk at K = 5


def variants_main(args, torch) -> int:
    """--variants: K10a and K11 (see the module's docstring)."""
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_hside, gru_pair, gru_stream
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    planned = hasattr(gru_chunk, "plan_k11")
    pair_planned = hasattr(gru_pair, "plan_k9")
    gru_hside.library()
    gru_chunk.library()
    gru_pair.library()   # K9, K10b (and a first-design tree's K10a)
    sets = (args.plans or "auto,split1,loop").split(",") if planned else ["default"]
    label = args.label or ("tree" if pair_planned else "parent")
    K, S = 5, VARIANT_STEPS
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {shape: chip_smoke.chunk_cell_inputs(shape, dev, gen, shape[-1], S)
             for shape in FLAGSHIP_CELLS}
    train = {shape: chip_smoke.make_cell_inputs(shape, dev, torch.Generator().manual_seed(1))[1:]
             for shape in TRAIN_CELLS}
    sel = torch.tensor([37], dtype=torch.int32, device=dev)

    def resident(C, plan):
        return gru_chunk.resident_clusters(0, C, plan)

    def k11_plan(plan_set, shape):
        C = shape[-1]
        if plan_set in ("auto", "loop"):
            return gru_chunk.device_plan(0, *shape[1:])
        if plan_set == "split1":
            return gru_chunk.plan_k11(*shape[1:], lambda p: resident(C, p), max_split=1)
        if plan_set == "default":
            return None
        raise ValueError(f"--variants has no plan set {plan_set!r}")

    def pair_calls():
        """{kernel: call} of K9 and K10b at the flagship pair (scales 0 and
        1, gx step 37), each also with the other block order where the
        tree's pair takes one, and the two K1 launches they replace."""
        (h0, gs0, w0, _), (h1, gs1, w1, _) = (cases[s] for s in FLAGSHIP_CELLS[:2])
        v0, v1 = gs0[37:38], gs1[37:38]
        out = {"k9": lambda **kw: gru_pair.conv_gru_hside_pair(h0, v0, *w0, h1, v1, *w1, **kw),
               "k10b": lambda **kw: gru_stream.conv_gru_hside_stream_pair(
                   h0, gs0, *w0, h1, gs1, *w1, sel, **kw)}
        if pair_planned:
            other = {"_first": 1 - gru_pair.PAIR_FIRST}
            out.update({f"{k}_other_order": (lambda f=f: f(**other)) for k, f in out.items()})
        out["k1_pair"] = lambda: (gru_hside.conv_gru_hside(h0, v0, *w0),
                                  gru_hside.conv_gru_hside(h1, v1, *w1))
        if pair_planned:   # K1 under the pair's plans (one combo)
            p0, p1 = gru_pair.plan_k9(*FLAGSHIP_CELLS[:2])
            out["k1_pair_at_k9_plans"] = lambda: (
                gru_hside.conv_gru_hside(h0, v0, *w0, _plan=p0),
                gru_hside.conv_gru_hside(h1, v1, *w1, _plan=p1))
        return out

    def pair_row(name, fn):
        """Wrapper us, max abs error against the plain version, and (this
        tree) the plans, grid, weight MB and registers of a pair row."""
        (h0, gs0, w0, _), (h1, gs1, w1, _) = (cases[s] for s in FLAGSHIP_CELLS[:2])
        v0, v1 = gs0[37:38], gs1[37:38]
        if name.startswith("k1_pair"):
            want = gru_pair.conv_gru_hside_pair_plain(h0, v0, *w0, h1, v1, *w1)
            plans = (gru_pair.plan_k9(*FLAGSHIP_CELLS[:2]) if name.endswith("k9_plans")
                     else [gru_hside.plan_k1(*s) for s in FLAGSHIP_CELLS[:2]])
            return {"plans": [chip_smoke.plan_name(p) for p in plans],
                    "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(fn(), want))}
        want = (gru_pair.conv_gru_hside_pair_plain(h0, v0, *w0, h1, v1, *w1)
                if name.startswith("k9") else
                gru_stream.conv_gru_hside_stream_pair_plain(h0, gs0, *w0, h1, gs1, *w1, sel))
        row = {"wrapper_us": min(chip_smoke.cuda_time_us(fn, ITERS) for _ in range(2)),
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(fn(), want))}
        if pair_planned:
            row.update(chip_smoke.pair_report(FLAGSHIP_CELLS[:2]))
            row["first"] = (1 - gru_pair.PAIR_FIRST if name.endswith("other_order")
                            else gru_pair.PAIR_FIRST)
        else:   # the first design's instance
            log = chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_cells", ""))
            flag = "ILb1E" if name.startswith("k10b") else "ILb0E"
            row["ptxas"] = next((v for k, v in log.items()
                                 if "gru_cells_kernel" + flag in k), None)
        return row

    def calls(plan_set, shape):
        """(K11's plan, its blocks, {kernel: call})."""
        plan = k11_plan(plan_set, shape)
        blocks = 0
        if plan_set == "loop":   # half the clusters, each looping over two tiles
            blocks = plan.split * -(-gru_chunk.tiles(plan, *shape[1:3]) // 2)
        kw = {"_plan": plan} if plan is not None else {}
        out = {}
        if shape in cases:
            h, gseq, w_ev, w_im = cases[shape]
            g1 = gseq[37:38]
            out["k11"] = lambda: gru_chunk.conv_gru_hside_chunk(
                w_ev, w_im, gseq, h, K, blocks=blocks, **kw)
            if plan is not None:
                out["k1_at_k11_plan"] = lambda: gru_hside.conv_gru_hside(
                    h, g1, *w_ev, _plan=plan)
            if plan_set in ("auto", "default"):
                out["k10a"] = lambda: gru_stream.conv_gru_hside_stream(h, gseq, sel, *w_ev)
                out["k1"] = lambda: gru_hside.conv_gru_hside(h, g1, *w_ev)
            if plan_set in ("auto", "default") and shape == FLAGSHIP_CELLS[0]:
                out.update(pair_calls())
        elif plan_set in ("auto", "default"):
            out["k1_res"] = lambda: gru_hside.conv_gru_hside_res(*train[shape])
        return plan, blocks, out

    shapes = list(cases) + list(train)
    times = {}
    with torch.no_grad():
        for plan_set in sets + sets[::-1]:   # mirrored turns
            for shape in shapes:
                for name, fn in calls(plan_set, shape)[2].items():
                    times.setdefault((plan_set, name, shape), []).append(
                        chip_smoke.cuda_time_us(fn, 3 if name == "k11" else ITERS,
                                                queued=True))
    hside_log = chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_hside", ""))
    variant_logs = {"k10a": chip_smoke.ptxas_by_kernel(kernels.build_log.get(
                        "gru_hside" if planned else "gru_cells", "")),
                    "k11": chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_chunk", ""))}
    lines, sums, barrier = [], {}, {}
    for plan_set in sets:
        for shape in shapes:
            plan, blocks, fns = calls(plan_set, shape)
            for name, fn in fns.items():
                key = (plan_set, name, shape)
                row = {"label": label, "plans": plan_set, "kernel": name,
                       "shape": list(shape), "us": min(times[key]), "us_turns": times[key]}
                if name in ("k10a", "k11"):
                    with torch.no_grad():
                        row["wrapper_us"] = min(chip_smoke.cuda_time_us(
                            fn, 3 if name == "k11" else ITERS) for _ in range(2))
                with torch.no_grad():
                    got = None if name.startswith(("k9", "k10b", "k1_pair")) else fn()
                    if got is None:
                        row.update(pair_row(name, fn))
                    elif name == "k11":
                        h, gseq, w_ev, w_im = cases[shape]
                        row["max_abs_err_per_step"] = chip_smoke.chunk_teacher_forced(
                            got, h, gseq, w_ev, w_im, K)
                        row["grid"] = gru_chunk.conv_gru_hside_chunk.last_grid
                        if plan is not None:
                            row.update(resident=resident(shape[-1], plan),
                                       **chip_smoke.variant_report("k11", shape, plan, S))
                        else:
                            row["ptxas"] = chip_smoke.variant_ptxas(variant_logs["k11"],
                                                                    "k11", None)
                    elif name == "k10a":
                        h, gseq, w_ev, _ = cases[shape]
                        want = gru_stream.conv_gru_hside_stream_plain(h, gseq, sel, *w_ev)
                        row["max_abs_err"] = (got.float() - want.float()).abs().max().item()
                        p1 = gru_hside.plan_k1(*shape) if planned else None
                        row.update(plan=chip_smoke.plan_name(p1) if p1 else None,
                                   ptxas=chip_smoke.variant_ptxas(
                                       variant_logs["k10a"], "k10a",
                                       gru_hside.K1_COMBOS[p1.combo] if p1 else None))
                    else:
                        p1 = plan if name == "k1_at_k11_plan" else gru_hside.plan_k1(
                            *shape, residuals=name == "k1_res")
                        row.update(plan=chip_smoke.plan_name(p1),
                                   weight_mb=gru_hside.k1_weight_bytes(p1, *shape) / 1e6,
                                   ptxas=chip_smoke.kernel_ptxas(
                                       hside_log, name == "k1_res",
                                       gru_hside.K1_COMBOS[p1.combo]))
                sums[f"{plan_set}_{name}_us"] = sums.get(f"{plan_set}_{name}_us", 0.0) \
                    + row["us"]
                lines.append(row)
            if ("k11" in fns and "k1_at_k11_plan" in fns):
                k11 = min(times[(plan_set, "k11", shape)])
                k1 = min(times[(plan_set, "k1_at_k11_plan", shape)])
                barrier[f"{plan_set}_{'x'.join(map(str, shape))}"] = (k11 - S * k1) / (S - 1)
    for row in lines:
        print(json.dumps(row), flush=True)
    print(json.dumps({"label": label, "summary": sums, "k11_barrier_us_per_step": barrier,
                      "steps": S, "nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    del cases, train
    torch.cuda.empty_cache()
    print(json.dumps({"label": label, "e2e": variants_e2e(torch, dev), "nvidia_smi": smi}),
          flush=True)
    return 0


def variants_e2e(torch, dev, seed=0):
    """The chunk's forward ms (chip_smoke.time_chunk_forward) and the
    chunked path's maps/s (chip_smoke.run_slice over its two sequences),
    with the default path, fused_stream='on', fused_pair='on', both and
    chunk_cells, in mirrored turns after a warm-up run each."""
    import dataclasses
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, event_loop_range
    cs = chip_smoke
    cfg = ModelConfig.load(os.path.join(cs.ROOT, cs.CONFIG))
    K = event_loop_range(cfg)
    model = ERGB2DepthRecurrent(cfg, device=dev,
                                generator=torch.Generator().manual_seed(seed))
    models = {"default": model}
    for name, over in (("fused_stream", {"fused_stream": "on"}),
                       ("fused_pair", {"fused_pair": "on"}),
                       ("stream_pair", {"fused_pair": "on", "fused_stream": "on"})):
        models[name] = ERGB2DepthRecurrent(dataclasses.replace(cfg, **over), device=dev)
        models[name].load_state_dict(model.state_dict())
    models["chunk_cells"] = cs.chunk_cells_model(model)
    order = list(models)
    with torch.no_grad():
        forward_ms = cs.time_chunk_forward(models, order, K, seed)
    data = cs.SyntheticDataset(cs.SEQ_LENGTHS, K, seed)
    packages = sum(-(-n // cs.CHUNK) * cs.CHUNK for n in cs.SEQ_LENGTHS)
    for name in order:
        cs.run_slice(models[name], data, keep=set())
    walls = {k: [] for k in order}
    for name in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.run_slice(models[name], data, keep=set())
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    maps = packages * (K + 1)
    return {"chunk_forward_ms": forward_ms,
            "chunk_forward_ms_min": {k: min(v) for k, v in forward_ms.items()},
            "maps": maps, "maps_per_s": {k: maps / min(v) for k, v in walls.items()},
            "wall_s": walls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--plans", default=None)   # per kernel: see the docstring
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--fit", default=None, metavar="SWEEP.jsonl")
    ap.add_argument("--lstm", action="store_true")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--latency-pairs", type=int, default=0)
    ap.add_argument("--profile-train", action="store_true")
    ap.add_argument("--kinds", default=None)   # --lstm: k3,k4,k3_res,k4_res
    ap.add_argument("--e2e", action="store_true")   # --lstm: the paths
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.fit:
        with open(args.fit) as f:
            model, report = fit_model([json.loads(line) for line in f if line.strip()],
                                      lstm=args.lstm, bwd=args.bwd, full=args.full)
        print(json.dumps({"_K2_MODEL" if args.bwd else "_K5_MODEL" if args.full else
                          "_LSTM_MODEL" if args.lstm else "_K1_MODEL": model}))
        print(json.dumps(report))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gru_hside_timing: needs a CUDA device", file=sys.stderr)
        return 2
    if args.variants:
        return variants_main(args, torch)
    if args.lstm:
        return lstm_main(args, torch)
    if args.bwd:
        return bwd_main(args, torch)
    if args.full:
        return full_main(args, torch)
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    lib = gru_hside.library()
    ptxas = chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_hside", ""))
    planned = hasattr(gru_hside, "plan_k1")
    sets = (args.plans or "auto,split1").split(",") if planned else ["default"]
    label = args.label or ("tree" if planned else "default")

    def plan_of(plans, kind, shape):
        res = kind == "k1_res"
        if plans == "auto":
            return gru_hside.plan_k1(*shape, residuals=res)
        if plans == "split1":
            return gru_hside.plan_k1(*shape, max_split=1, residuals=res)
        return None

    gen = torch.Generator().manual_seed(0)
    cases = [(kind, s, chip_smoke.make_cell_inputs(s, dev, gen)[1:])
             for kind, cells in (("k1", FLAGSHIP_CELLS), ("k1_res", TRAIN_CELLS))
             for s in cells]

    def call(kind, plan, inputs):
        kw = {"_plan": plan} if plan is not None else {}
        if kind == "k1":
            return lambda: gru_hside.conv_gru_hside(*inputs, **kw)
        return lambda: gru_hside.conv_gru_hside_res(*inputs, **kw)

    times, wrapper = {}, {}
    order = sets + sets[::-1]   # mirrored turns
    for kind_set in order:
        for kind, shape, inputs in cases:
            fn = call(kind, plan_of(kind_set, kind, shape), inputs)
            key = (kind_set, kind, shape)
            times.setdefault(key, []).append(chip_smoke.cuda_time_us(fn, ITERS, queued=True))
            wrapper.setdefault(key, []).append(chip_smoke.cuda_time_us(fn, ITERS))
    lines, sums = [], {}
    for kind_set in sets:
        for kind, shape, inputs in cases:
            plan = plan_of(kind_set, kind, shape)
            res = kind == "k1_res"
            key = (kind_set, kind, shape)
            dev_us, records = chip_smoke.launch_device_us(call(kind, plan, inputs), 10)
            row = {"label": label, "plans": kind_set, "kernel": kind,
                   "shape": list(shape), "plan": plan._asdict() if plan else None,
                   "us": min(times[key]), "us_turns": times[key],
                   "wrapper_us": min(wrapper[key]), "wrapper_us_turns": wrapper[key],
                   "device_us": dev_us, "device_records": records}
            if plan is not None:
                row.update({
                    "weight_mb": gru_hside.k1_weight_bytes(plan, *shape) / 1e6,
                    "smem_bytes": gru_hside.k1_smem_bytes(
                        plan.tile_h, plan.tile_w, shape[-1], plan.split, plan.ks, res),
                    "max_active_clusters": lib.ramnet_gru_hside_max_active_clusters(
                        int(res), shape[-1], *plan)})
            row["ptxas"] = chip_smoke.kernel_ptxas(
                ptxas, res, gru_hside.K1_COMBOS[plan.combo] if plan else None)
            for name, v in (("us", row["us"]), ("wrapper_us", row["wrapper_us"])):
                sums[f"{kind_set}_{kind}_{name}"] = sums.get(
                    f"{kind_set}_{kind}_{name}", 0.0) + v
            lines.append(row)
    if args.sweep and planned:
        for kind, shape, inputs in cases:
            res = kind == "k1_res"
            plans = gru_hside.k1_plans(*shape, residuals=res)
            best = min(gru_hside._k1_cost(p, *shape, res) for p in plans)
            for plan in plans:
                if gru_hside._k1_cost(plan, *shape, res) > 4 * best:
                    continue
                lines.append({
                    "sweep": kind, "shape": list(shape), "plan": list(plan),
                    "us": chip_smoke.cuda_time_us(call(kind, plan, inputs), 10,
                                                  queued=True)})
    if args.gates and planned:
        lines += gate_errors(torch, gru_hside, kernels, cases, dev)
    lines.append({"label": label, "summary": sums, "nvidia_smi": smi,
                  "torch": torch.__version__, "cuda": torch.version.cuda})
    for row in lines:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
