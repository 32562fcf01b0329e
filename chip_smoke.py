#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main path, offline chunked depth inference
(``rpg_ramnet_tpu_torch.eval.run_chunked_streaming``), at the full width of
the flagship EventScape recipe
(configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json) at 256x512,
with random weights and synthetic event/frame sequences made from --seed.
It imports nothing of JAX or of the JAX package.

Phases, each printed as one JSON line:
  1. device   the card, its power limit, the nvcc build of the kernels;
  2. kernel   the ConvGRU h-side kernel against its plain PyTorch version on
              the card, at the three flagship widths and one ragged shape;
  3. slice    two sequences (40 and 8 packages) through the main path with
              chunk 16: the kernel's launch count, finite predictions in
              [0, 1], and the first chunk against the same run with
              fused_gru='off' (the plain layer);
  4. timing   the kernel and its plain version per cell, the slice's depth
              maps/s.
Then the card's name and power limit as nvidia-smi gives them, the kernel
summary, and last {"ok": true, "device": {...}}.  Exits non-zero, without
that last line, if there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
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


def time_cells(dev, gen, iters=50):
    """Microseconds per cell, kernel and plain version (and the plain
    layer the 'off' policy runs), in turns plain, kernel, kernel, plain."""
    import torch
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw

    def cuda_us(fn):
        for _ in range(3):
            fn()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) * 1e3 / iters

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
    run_chunked_streaming: item i is {'events': [1, K, H, W, 5],
    'image': [1, H, W, 1]}, events ~ N(0, 1), frames ~ U(0, 1)."""

    def __init__(self, n, K, rng):
        self.events = rng.standard_normal((n, K, H, W, 5), dtype="float32")
        self.image = rng.random((n, H, W, 1), dtype="float32")

    def __len__(self):
        return len(self.events)

    def __getitem__(self, i):
        return {"events": self.events[i:i + 1], "image": self.image[i:i + 1]}


class SyntheticDataset:
    def __init__(self, lengths, K, seed):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.datasets = [SyntheticSequence(n, K, rng) for n in lengths]


def run_slice(model, dataset, keep=None):
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

    run_chunked_streaming(dataset, model, chunk=CHUNK,
                          on_prediction=on_prediction)
    return kept, stats


def max_pred_diff(a, b):
    import numpy as np
    return max(float(np.abs(a[g][k] - b[g][k]).max())
               for g in a for k in a[g])


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
    from rpg_ramnet_tpu_torch.ops import gru_hside
    from rpg_ramnet_tpu_torch.utils import require_cuda

    # 1. device and build
    dev = require_cuda()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    gru_hside.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln for ln in kernels.build_log.get("gru_hside", "").splitlines()
             if "registers" in ln or "spill" in ln]
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
    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "rpg_ramnet_tpu"))
    if jax_modules:
        raise AssertionError(f"the port loaded JAX modules: {jax_modules[:5]}")
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

    kern_ms = sum(r["kernel_us"] for r in cells) / 1e3
    plain_ms = sum(r["plain_us"] for r in cells) / 1e3
    print(smi)
    emit({"kernels": [{
        "name": "gru_hside", "route": "cuda",
        "source": "rpg_ramnet_tpu_torch/csrc/gru_hside.cu",
        "replaces": "rpg_ramnet_tpu/ops/gru_hside.py:289",
        "launches": launches, "max_abs_err": max(errs.values()),
        "ms": kern_ms, "plain_ms": plain_ms}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
