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
state-combination variant on the chunked engine.  It imports nothing of
JAX or of the JAX package.

Phases, each printed as one JSON line:
  1. device        the card, its power limit, the nvcc builds (in parallel);
  2. kernel        K1 against its plain PyTorch version on the card, at the
                   three inference widths and one ragged shape;
  3. slice         two sequences (40 and 8 packages) through the inference
                   path with chunk 16: K1's launch count, finite predictions
                   in [0, 1], the first chunk against fused_gru='off';
  4. timing        K1 and its plain version per cell, the slice's maps/s;
  5. kernel_train  K1-res, K2 and the ConvGRUHside Function against their
                   plain versions at the three training shapes (B=16) and
                   one ragged shape;
  6. train         the first step's loss and gradients against
                   fused_gru='off', then the entry point for TRAIN_STEPS
                   optimizer steps and one validation batch on a synthetic
                   on-disk split: finite losses, the K1-res, K2 and K1
                   launch counts, peak memory;
  7. timing_train  training sequences/s with the kernels and with 'off',
                   K1-res and K2 per cell against their plain versions;
  8. kernel_stream K5 against its plain version at the three per-package
                   shapes and one ragged shape; K6 (with and without stats)
                   and K7 (float32 and bf16 factors) against the plain
                   scatter at 1M events on 5x260x346 and on a sparse
                   padded case;
  9. stream        the per-package engine through the eval entry point on
                   two sequences (40 and 8 packages): K5's launch count,
                   finite predictions in [0, 1], all of them against
                   fused_gru='off'; then the stream entry point on 20
                   windows of 0.35 events per pixel: K6's launch count,
                   every window's grid against its plain version, finite
                   depth maps, and again with --voxel_backend pallas (K7);
 10. timing_stream per-package latency (median, p90) and depth maps/s with
                   K5 and with 'off', K5 per cell against its plain
                   version, the voxelizers' Mev/s at 1M events;
 11. kernel_phased K3 and K4 against their plain versions at the three
                   phased shapes and one ragged shape, K3 at the three
                   flagship shapes;
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
                   plain versions.
Then the card's name and power limit as nvidia-smi gives them, the kernel
summary (with each kernel's bound: the larger of its MACs at the bf16
dense peak and its bytes at the HBM rate), and last {"ok": true,
"device": {...}}.  Exits non-zero, without
that last line, if there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

H, W, CHUNK = 256, 512, 16
SEQ_LENGTHS = (40, 8)
CONFIG = "configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json"
ROOT = os.path.dirname(os.path.abspath(__file__))
CELL_TOL = 2e-2    # one cell in bf16: eps 7.8e-3, a few roundings stack
SLICE_TOL = 5e-2   # sigmoid predictions after L*(K+1) bf16 cells
# (B, H, W, C): the flagship h-side shapes, and a ragged one with B > 1
# whose gx is a strided view, as forward_sequence_precomputed passes it
FLAGSHIP_CELLS = ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256))
RAGGED_CELL = (2, 30, 45, 96)
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
# the card's published peaks (H100 SXM, dense bf16; HBM3)
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
# per cell: (MACs per pixel / C^2, bytes moved per pixel / C, weight
# bytes / C^2): K1 reads h, gx and writes h'; K1-res also acts; K2 reads
# g, h, acts and writes dh, dgx; K5 reads x, h and writes h'; K3 reads h,
# c, gx (4C) and writes h', c'; K4 also reads the f32 tau and phase and
# writes three maps
CELL_WORK = {"k1": (27, 10, 54), "k1_res": (27, 16, 54), "k2": (27, 18, 54),
             "k5": (54, 6, 108), "k3": (36, 16, 72), "k4": (36, 26, 72)}


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


def kernel_check(dev, gen):
    """Max abs error of the kernel against its plain version per shape."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    errs = {}
    for shape in FLAGSHIP_CELLS + (RAGGED_CELL,):
        _, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen,
                                               strided_gx=shape == RAGGED_CELL)
        got = gru_hside.conv_gru_hside(h, gx, w_ur, w_o)
        want = gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        errs["x".join(map(str, shape))] = err
        if not (err <= CELL_TOL):
            raise AssertionError(f"kernel vs plain at {shape}: max abs err "
                                 f"{err} > {CELL_TOL}")
    return errs


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def train_kernel_check(dev, gen):
    """K1-res (h', acts: max abs error), K2 (dh, dgx) and the ConvGRUHside
    Function (dh, dgx, dw_ur, dw_o; max abs error over the plain version's
    max magnitude) against their plain versions, per shape."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    rows = []
    for shape in TRAIN_CELLS + (RAGGED_TRAIN_CELL,):
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
               "fn_rel": [rel_err(a, b) for a, b in zip(fn_grads, want_fn)]}
        rows.append(row)
        if not (max(row["res_h_err"], row["res_acts_err"]) <= CELL_TOL):
            raise AssertionError(f"K1-res vs plain at {shape}: {row}")
        if not (max([row["bwd_dh_rel"], row["bwd_dgx_rel"]] + row["fn_rel"])
                <= GRAD_TOL):
            raise AssertionError(f"K2 / Function vs plain at {shape}: {row}")
    return rows


def cuda_time_us(fn, iters):
    """Microseconds per call of fn by CUDA events over iters calls, after
    three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / iters


def time_train_cells(dev, gen, iters=20):
    """Microseconds per cell of K1-res and K2 and of their plain versions
    at the training shapes, in turns plain, kernel, kernel, plain."""
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
            p1, k1, k2, p2 = (cuda_time_us(f, iters) for f in (plain, kern, kern, plain))
            row.update({f"{name}_kernel_us": min(k1, k2),
                        f"{name}_plain_us": min(p1, p2),
                        f"{name}_us_runs_p_k_k_p": [p1, k1, k2, p2]})
        rows.append(row)
    return rows


def time_cells(dev, gen, iters=50):
    """Microseconds per cell, kernel and plain version (and the plain
    layer the 'off' policy runs), in turns plain, kernel, kernel, plain."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw

    def cuda_us(fn):
        return cuda_time_us(fn, iters)

    rows = []
    for shape in FLAGSHIP_CELLS:
        cell, h, gx, w_ur, w_o = make_cell_inputs(shape, dev, gen)
        kern = lambda: gru_hside.conv_gru_hside(h, gx, w_ur, w_o)  # noqa: E731
        plain = lambda: gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)  # noqa: E731
        layer = lambda: cell.hside(to_nchw(gx), to_nchw(h))  # noqa: E731
        p1, k1, k2, p2 = cuda_us(plain), cuda_us(kern), cuda_us(kern), cuda_us(plain)
        rows.append({"shape": list(shape), "kernel_us": min(k1, k2),
                     "plain_us": min(p1, p2), "plain_layer_bf16_us": cuda_us(layer),
                     "kernel_us_runs": [k1, k2], "plain_us_runs": [p1, p2]})
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


def write_train_data(root, K, seed):
    """Synthetic on-disk splits at the crop size: one training sequence
    with TRAIN_STEPS * TRAIN_B windows of TRAIN_L packages (step_size 1)
    and one validation sequence with two windows."""
    from rpg_ramnet_tpu_torch.data import generate_split
    for split, windows, s in (("train", TRAIN_STEPS * TRAIN_B, seed),
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


def first_step_vs_off(cfg, root, dev, seed):
    """Loss and every parameter gradient of one window batch with the
    kernels (fused_gru 'auto') and with the plain layer ('off'), from the
    same weights.  Returns the batch, both models and the comparison."""
    import torch
    from rpg_ramnet_tpu_torch.data import BatchLoader, concatenate_subfolders
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.train.sequence_loss import (make_sequence_loss,
                                                          pack_train_batch)
    split = cfg.train_data
    ds = concatenate_subfolders(
        os.path.join(root, "train"), split.type, split.event_folder,
        split.depth_folder, split.frame_folder, TRAIN_L, step_size=1,
        clip_distance=split.clip_distance,
        every_x_rgb_frame=split.every_x_rgb_frame,
        reg_factor=split.reg_factor)
    batch = pack_train_batch(next(iter(BatchLoader(ds, TRAIN_B, shuffle=False))),
                             dev)
    models, losses, grads = {}, {}, {}
    for mode in ("auto", "off"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               fused_gru=mode))
        model = ERGB2DepthRecurrent(c.model, device=dev,
                                    generator=torch.Generator().manual_seed(seed))
        n_res = gru_hside.conv_gru_hside_res.launches
        loss, _ = make_sequence_loss(c, remat=True)(
            model, model.init_state(TRAIN_B, TRAIN_CROP, TRAIN_CROP), batch)
        loss.backward()
        torch.cuda.synchronize()
        if (mode == "off") != (gru_hside.conv_gru_hside_res.launches == n_res):
            raise AssertionError(f"fused_gru={mode!r}: K1-res launched "
                                 f"{gru_hside.conv_gru_hside_res.launches - n_res}")
        models[mode], losses[mode] = model, loss.item()
        grads[mode] = {n: p.grad.float() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    cos = {n: torch.nn.functional.cosine_similarity(
        grads["auto"][n].flatten(), grads["off"][n].flatten(), dim=0).item()
        for n in grads["off"]}
    worst = min(cos, key=cos.get)
    out = {"loss_kernels": losses["auto"], "loss_off": losses["off"],
           "loss_rel_diff": abs(losses["auto"] - losses["off"]) / abs(losses["off"]),
           "loss_tol": LOSS_TOL, "grad_cos_min": cos[worst],
           "grad_cos_min_tensor": worst,
           "grad_cos_median": sorted(cos.values())[len(cos) // 2],
           "cos_tol": COS_TOL, "tensors": len(cos)}
    if not (math.isfinite(losses["auto"]) and out["loss_rel_diff"] <= LOSS_TOL
            and out["grad_cos_min"] >= COS_TOL):
        raise AssertionError(f"first step, kernels vs fused_gru='off': {out}")
    return batch, models, out


def time_training(cfg, models, batch, steps=2):
    """Training sequences/s of one window batch through make_train_step,
    kernels ('auto') and plain layer ('off'), in turns off, on, on, off
    after one warm-up step each."""
    import torch
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_train_step
    step_fns = {}
    for mode, model in models.items():
        c = dataclasses.replace(cfg, model=model.cfg)
        step_fns[mode] = make_train_step(c, model,
                                         make_optimizer(c, model.parameters()))
        step_fns[mode](batch)
    walls = []
    for mode in ("off", "auto", "auto", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            aux = step_fns[mode](batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not math.isfinite(aux["loss"]):
            raise AssertionError(f"non-finite loss in timing ({mode}): {aux}")
    seqs = TRAIN_B * steps
    return {"train_seq_per_s": seqs / min(walls[1], walls[2]),
            "train_off_seq_per_s": seqs / min(walls[0], walls[3]),
            "train_wall_s_off_on_on_off": walls, "steps_per_run": steps}


def run_training(raw, tmp, K):
    """The entry point in-process on the synthetic split, with every
    launch count set to 0 just before; returns the trainer, its log and
    the counts read just after."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.train.__main__ import main as train_main
    cfg_path = os.path.join(tmp, "train_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    os.environ["PREPROCESSED_DATASETS_FOLDER"] = os.path.join(tmp, "data")
    counters = (gru_hside.conv_gru_hside, gru_hside.conv_gru_hside_res,
                gru_hside.conv_gru_hside_bwd)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_main(["-c", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, res, bwd = (c.launches for c in counters)
    log = trainer.jsonl.entries[0]
    cells = 3 * (K + 1) * TRAIN_L          # h-side cells per window
    # each checkpointed package runs its forward twice (the recompute)
    want = {"k1_res": 2 * cells * TRAIN_STEPS, "k2": cells * TRAIN_STEPS,
            "k1_validation": cells}
    got = {"k1_res": res, "k2": bwd, "k1_validation": k1}
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
    macs, io, wts = CELL_WORK[kind]
    by = {"operations": 0.0, "bytes": 0.0}
    for B, H, W, C in shapes:
        t_ops = 2 * macs * C * C * B * H * W / PEAK_FLOPS
        t_bytes = (io * C * B * H * W + wts * C * C) / HBM_BYTES_PER_S
        by["operations" if t_ops >= t_bytes else "bytes"] += max(t_ops, t_bytes)
    return sum(by.values()) * 1e3, max(by, key=by.get)


def voxel_bound(n_events):
    """(least ms, 'bytes') of one voxel grid: the events read once (16
    bytes each) and the 5x260x346 float32 grid written once; the few
    float32 operations per event are far below the bytes' time."""
    nb, h, w = VOX_GRID
    return (16 * n_events + 4 * nb * h * w) / HBM_BYTES_PER_S * 1e3, "bytes"


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


def stream_kernel_check(dev, gen, seed):
    """K5 against its plain version per shape (max abs error); K6 with and
    without stats and K7 with float32 and bf16 factors against the plain
    scatter at 1M events and on a sparse padded case."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside, voxel
    k5 = {}
    for shape in FLAGSHIP_CELLS + (RAGGED_CELL,):
        _, x, h, w = make_full_cell_inputs(shape, dev, gen)
        with torch.no_grad():
            got = gru_hside.conv_gru_full(x, h, *w)
            want = gru_hside.conv_gru_full_plain(x, h, *w)
        torch.cuda.synchronize()
        k5["x".join(map(str, shape))] = err = (got.float() - want.float()).abs().max().item()
        if not (err <= CELL_TOL):
            raise AssertionError(f"K5 vs plain at {shape}: {err} > {CELL_TOL}")
    nb, hh, ww = VOX_GRID
    kw = dict(num_bins=nb, height=hh, width=ww)
    vox = {}
    for name, (n, n_valid) in (("1M", (VOX_EVENTS, VOX_EVENTS)),
                               ("sparse_padded", (4096, 64))):
        ev = make_events(n, n_valid, dev, seed)
        want = voxel.events_to_voxel_grid_scatter(ev, n_valid, **kw)
        k6 = voxel.events_to_voxel_grid_sortseg(ev, n_valid, **kw)
        k6s, stats = voxel.events_to_voxel_grid_sortseg(ev, n_valid,
                                                        with_stats=True, **kw)
        k7 = voxel.events_to_voxel_grid_pallas(ev, n_valid, **kw)
        k7b = voxel.events_to_voxel_grid_pallas(
            ev, n_valid, factor_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        row = {f: (g - want).abs().max().item()
               for f, g in (("k6", k6), ("k6_stats", k6s), ("k7_f32", k7),
                            ("k7_bf16", k7b))}
        # each stat against its own magnitude (the sum against the sum of
        # |values|, as its cancellations are the atomics' rounding)
        want_stats = voxel.voxel_stats(want)
        scales = (want_stats[0], want.abs().sum(), want_stats[2])
        row["stats_rel_err"] = max(
            abs(a.item() - b.item()) / max(s.item(), 1.0)
            for a, b, s in zip(stats, want_stats, scales))
        row["grid_max_abs"] = scale
        vox[name] = row
        tol = VOX_TOL * max(scale, 1.0)
        if not (max(row["k6"], row["k6_stats"], row["k7_f32"]) <= tol
                and row["stats_rel_err"] <= VOX_TOL
                and row["k7_bf16"] <= VOX_BF16_TOL):
            raise AssertionError(f"voxelizers vs plain ({name}): {row}")
    return k5, vox


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
    just before; returns the depth maps and the counts read just after."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    from rpg_ramnet_tpu_torch.stream import main as stream_main
    _, h, w = VOX_GRID
    depths = {}
    counters = (voxel.events_to_voxel_grid_sortseg, voxel.events_to_voxel_grid_pallas)
    for c in counters:
        c.launches = 0
    stream_main(["-i", log, "--path_to_model", ckpt, "--config", cfg_path,
                 "--height", str(h), "--width", str(w),
                 "--num_events_per_pixel", str(STREAM_EVENTS_PER_PIXEL),
                 "--voxel_backend", backend], on_window=depths.__setitem__)
    torch.cuda.synchronize()
    return depths, {"k6": counters[0].launches, "k7": counters[1].launches}


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


def time_per_package(models, K, seed, steps=20, h=H, w=W, times=False):
    """Per-package latency of StreamingInference.step (batched decode; host
    clock around each step, which ends in the predictions' copy to the
    host) with the kernels ('on') and the plain cells ('off'), in turns
    off, on, on, off after three warm-up packages each: median and p90 ms
    per package, and depth maps/s over each turn.  times: the packages
    carry timestamps (the phased regime)."""
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
    for mode in ("off", "on", "on", "off"):
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
    out = {"runs_off_on_on_off": runs, "packages_per_run": steps}
    for mode in ("on", "off"):
        mine = [r for r in runs if r["mode"] == mode]
        best = min(mine, key=lambda r: r["median_ms"])
        out[f"per_package_latency_ms_{mode}"] = best["median_ms"]
        out[f"per_package_p90_ms_{mode}"] = best["p90_ms"]
        out[f"stream_maps_per_s_{mode}"] = max(r["maps_per_s"] for r in mine)
    return out


def time_full_cells(dev, gen, iters=50):
    """Microseconds per cell of K5 and its plain version at the flagship
    per-package shapes, in turns plain, kernel, kernel, plain, and of the
    plain bf16 layer that fused_gru='off' runs."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw
    rows = []
    for shape in FLAGSHIP_CELLS:
        cell, x, h, w = make_full_cell_inputs(shape, dev, gen)
        cell.to(dev)
        kern = lambda: gru_hside.conv_gru_full(x, h, *w)  # noqa: E731
        plain = lambda: gru_hside.conv_gru_full_plain(x, h, *w)  # noqa: E731
        layer = lambda: cell(to_nchw(x), to_nchw(h))  # noqa: E731
        with torch.no_grad():
            p1, k1, k2, p2 = (cuda_time_us(f, iters) for f in (plain, kern, kern, plain))
            layer_us = cuda_time_us(layer, iters)
        rows.append({"shape": list(shape), "kernel_us": min(k1, k2),
                     "plain_us": min(p1, p2), "plain_layer_bf16_us": layer_us,
                     "us_runs_p_k_k_p": [p1, k1, k2, p2]})
    return rows


def time_voxelizers(dev, seed, iters=20):
    """Microseconds per grid at 1M events on 5x260x346 and Mev/s: K6
    (without and with stats), K7 (float32 and bf16 factors), their plain
    versions and the one index_add_ call on precomputed contributions."""
    import torch
    from rpg_ramnet_tpu_torch.ops import voxel
    nb, h, w = VOX_GRID
    kw = dict(num_bins=nb, height=h, width=w)
    n = VOX_EVENTS
    ev = make_events(n, n, dev, seed)
    idx, vals, ok = voxel._contributions(ev, n, nb, h, w)
    idx, vals = torch.where(ok, idx, 0), torch.where(ok, vals, 0.0)
    grid = torch.zeros(nb * h * w, device=dev)
    calls = {
        "k6": lambda: voxel.events_to_voxel_grid_sortseg(ev, n, **kw),
        "k6_stats": lambda: voxel.events_to_voxel_grid_sortseg(
            ev, n, with_stats=True, **kw),
        "k7_f32": lambda: voxel.events_to_voxel_grid_pallas(ev, n, **kw),
        "k7_bf16": lambda: voxel.events_to_voxel_grid_pallas(
            ev, n, factor_dtype=torch.bfloat16, **kw),
        "scatter_plain": lambda: voxel.events_to_voxel_grid_scatter(ev, n, **kw),
        "index_add_only": lambda: grid.index_add_(0, idx, vals),
    }
    us = {k: cuda_time_us(f, iters) for k, f in calls.items()}
    us["matmul_plain"] = cuda_time_us(
        lambda: voxel.events_to_voxel_grid_matmul(ev, n, **kw), 2)
    return {"events": n, "grid": list(VOX_GRID), "us": us,
            "mev_per_s": {k: n / v for k, v in us.items()}}


def make_lstm_inputs(shape, dev, gen, strided_gx=False):
    """bf16 NHWC h in (-1, 1) and c in (-2, 2), gx ~ N(0, 1), a ConvLSTM's
    folded h-side weight (torch's conv init), a phased gate's [H, W, C]
    tau and phase (upstream init) and t in (0, 3) s per batch item."""
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
    return h, c, gx, w4, tau, phase, t


def lstm_kernel_check(dev, gen):
    """Max abs error of K3 (h', c') and K4 (h_t, h_new, c_new) against
    their plain versions per shape: the phased shapes and a ragged one for
    both, the flagship shapes for K3."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
    k3, k4 = {}, {}
    for shape in PHASED_CELLS + (RAGGED_LSTM_CELL,) + FLAGSHIP_CELLS:
        h, c, gx, w4, tau, phase, t = make_lstm_inputs(
            shape, dev, gen, strided_gx=shape == RAGGED_LSTM_CELL)
        key = "x".join(map(str, shape))
        with torch.no_grad():
            pairs = list(zip(gru_hside.conv_lstm_hside(h, c, gx, w4),
                             gru_hside.conv_lstm_hside_plain(h, c, gx, w4)))
            k3[key] = max((a.float() - b.float()).abs().max().item()
                          for a, b in pairs)
            if shape not in FLAGSHIP_CELLS:
                pairs = zip(phased_cell.conv_lstm_phased(h, c, gx, w4, tau,
                                                         phase, t),
                            phased_cell.conv_lstm_phased_plain(h, c, gx, w4, tau,
                                                               phase, t))
                k4[key] = max((a.float() - b.float()).abs().max().item()
                              for a, b in pairs)
        torch.cuda.synchronize()
        if not max(k3[key], k4.get(key, 0.0)) <= CELL_TOL:
            raise AssertionError(f"K3/K4 vs plain at {shape}: {k3[key]}, "
                                 f"{k4.get(key)} > {CELL_TOL}")
    return k3, k4


def time_lstm_cells(dev, gen, iters=50):
    """Microseconds per cell of K3 and K4 and of their plain versions at
    the phased shapes, in turns plain, kernel, kernel, plain."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
    rows = []
    for shape in PHASED_CELLS:
        h, c, gx, w4, tau, phase, t = make_lstm_inputs(shape, dev, gen)
        row = {"shape": list(shape)}
        for name, kern, plain in (
                ("k3", lambda: gru_hside.conv_lstm_hside(h, c, gx, w4),
                 lambda: gru_hside.conv_lstm_hside_plain(h, c, gx, w4)),
                ("k4", lambda: phased_cell.conv_lstm_phased(
                    h, c, gx, w4, tau, phase, t),
                 lambda: phased_cell.conv_lstm_phased_plain(
                    h, c, gx, w4, tau, phase, t))):
            with torch.no_grad():
                p1, k1, k2, p2 = (cuda_time_us(f, iters)
                                  for f in (plain, kern, kern, plain))
            row.update({f"{name}_kernel_us": min(k1, k2),
                        f"{name}_plain_us": min(p1, p2),
                        f"{name}_us_runs_p_k_k_p": [p1, k1, k2, p2]})
        rows.append(row)
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

    # 11. the ConvLSTM kernels against their plain versions on the card
    k3_errs, k4_errs = lstm_kernel_check(dev, gen)
    emit({"phase": "kernel_phased", "cell_tol": CELL_TOL,
          "k3_max_abs_err": k3_errs, "k4_max_abs_err": k4_errs})

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
    emit({"phase": "timing_phased", **ph_latency, "chunked": ph_chunked,
          "lstm_cells": lstm_cells, "nvidia_smi": smi})

    return {"k3_errs": k3_errs, "k4_errs": k4_errs, "counts": ph_counts,
            "cells": lstm_cells}


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
    from rpg_ramnet_tpu_torch.ops import gru_hside, voxel
    from rpg_ramnet_tpu_torch.utils import require_cuda

    # 1. device and build (one nvcc per source, all at once)
    dev = require_cuda()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    kernels.build(gru_hside.SOURCES + voxel.SOURCES)
    gru_hside.library()
    gru_hside.library_bwd()
    gru_hside.library_full()
    gru_hside.library_lstm()
    voxel.library()
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
    emit({"phase": "kernel", "name": "gru_hside", "tol": CELL_TOL,
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
    train_rows = train_kernel_check(dev, gen)
    emit({"phase": "kernel_train", "cell_tol": CELL_TOL, "grad_tol": GRAD_TOL,
          "cells": train_rows})

    # 6. training at full width through the entry point
    from rpg_ramnet_tpu_torch.core.config import Config
    with tempfile.TemporaryDirectory(prefix="ramnet_smoke_") as tmp:
        t0 = time.perf_counter()
        write_train_data(os.path.join(tmp, "data"), K, args.seed)
        data_s = time.perf_counter() - t0
        raw = train_config(tmp)
        tcfg = Config.from_dict(raw)
        batch, tmodels, first = first_step_vs_off(
            tcfg, os.path.join(tmp, "data"), dev, args.seed)
        trained = run_training(raw, tmp, K)
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
        depths_k6, stream_counts = run_stream_entry(*files["off"], log, "auto")
        depths_k7, k7_counts = run_stream_entry(*files["off"], log, "pallas")
        window_err, windows = window_grid_check(log, dev)
    if (windows != STREAM_WINDOWS or len(depths_k6) != windows
            or stream_counts != {"k6": windows, "k7": 0}
            or k7_counts != {"k6": 0, "k7": windows}):
        raise AssertionError(f"stream: {windows} windows, {len(depths_k6)} "
                             f"depth maps, launches {stream_counts} (K6 run), "
                             f"{k7_counts} (K7 run)")
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
          "depth_k7_vs_k6_max_abs_err": stream_k7_err,
          "events_per_window": int(vh * vw * STREAM_EVENTS_PER_PIXEL)})

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

    src = "rpg_ramnet_tpu_torch/csrc/"
    vus = vox_times["us"]

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
              launches, max(errs.values()),
              sum(r["kernel_us"] for r in cells) / 1e3,
              sum(r["plain_us"] for r in cells) / 1e3,
              cell_bound("k1", FLAGSHIP_CELLS)),
        entry("gru_hside_res", "gru_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:124",
              trained["launches"]["k1_res"],
              max(max(r["res_h_err"], r["res_acts_err"]) for r in train_rows),
              sum(r["res_kernel_us"] for r in train_cells) / 1e3,
              sum(r["res_plain_us"] for r in train_cells) / 1e3,
              cell_bound("k1_res", TRAIN_CELLS)),
        entry("gru_hside_bwd", "gru_hside_bwd.cu",
              "rpg_ramnet_tpu/ops/gru_hside.py:535", trained["launches"]["k2"],
              max(max(r["bwd_dh_abs_err"], r["bwd_dgx_abs_err"])
                  for r in train_rows),
              sum(r["bwd_kernel_us"] for r in train_cells) / 1e3,
              sum(r["bwd_plain_us"] for r in train_cells) / 1e3,
              cell_bound("k2", TRAIN_CELLS)),
        entry("gru_full", "gru_full.cu", "rpg_ramnet_tpu/ops/gru_hside.py:777",
              k5_launches, max(k5_errs.values()),
              sum(r["kernel_us"] for r in full_cells) / 1e3,
              sum(r["plain_us"] for r in full_cells) / 1e3,
              cell_bound("k5", FLAGSHIP_CELLS)),
        entry("voxel_scatter", "voxel.cu", "rpg_ramnet_tpu/ops/voxel.py:445",
              stream_counts["k6"],
              max(max(r["k6"], r["k6_stats"]) for r in vox_errs.values()),
              vus["k6"] / 1e3, vus["scatter_plain"] / 1e3,
              voxel_bound(VOX_EVENTS), vus["index_add_only"] / 1e3),
        entry("voxel_onehot", "voxel.cu", "rpg_ramnet_tpu/ops/voxel.py:242",
              k7_counts["k7"], max(r["k7_f32"] for r in vox_errs.values()),
              vus["k7_f32"] / 1e3, vus["matmul_plain"] / 1e3,
              voxel_bound(VOX_EVENTS), vus["index_add_only"] / 1e3),
        entry("lstm_hside", "lstm_hside.cu", "rpg_ramnet_tpu/ops/gru_hside.py:368",
              ph["counts"][0], max(ph["k3_errs"].values()),
              sum(r["k3_kernel_us"] for r in ph["cells"]) / 1e3,
              sum(r["k3_plain_us"] for r in ph["cells"]) / 1e3,
              cell_bound("k3", PHASED_CELLS)),
        entry("phased_cell", "lstm_hside.cu",
              "rpg_ramnet_tpu/ops/phased_cell.py:113", ph["counts"][1],
              max(ph["k4_errs"].values()),
              sum(r["k4_kernel_us"] for r in ph["cells"]) / 1e3,
              sum(r["k4_plain_us"] for r in ph["cells"]) / 1e3,
              cell_bound("k4", PHASED_CELLS))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
