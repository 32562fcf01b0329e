#!/usr/bin/env python3
"""The port's voxelizers timed alone on one GPU, printed as one JSON line.

    python3 voxel_timing.py [--sizes 1M,live,batch800] [--sweep] [--seed N]

--sizes runs chip_smoke.py's ``time_voxelizers`` at the named sizes.
--sweep times K6 (without and with stats) on each of the kernel's two
paths, one-pass and tiled, by device time (torch.profiler; for batches
per kernel the mean of the records it kept) in mirrored
turns, over single windows of growing size and batches of growing window
count on 5x260x346: what the kernel's size rule (csrc/voxel.cu,
kOnePassGridBytes) is read from.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# (windows, events per window): single windows from one stream window to
# 4M events, then batches of the raw pipeline's 32768 bucket
SWEEP = ((1, 31_485), (1, 1 << 18), (1, 1 << 20), (1, 1 << 22),
         (4, 32_768), (8, 32_768), (16, 32_768), (32, 32_768), (64, 32_768),
         (128, 32_768), (800, 32_768))
SWEEP_TURNS = 2


def path_sweep(dev, seed):
    """Per SWEEP size: the path the size rule picks, and per path the
    least device us of K6 and K6 with stats over SWEEP_TURNS mirrored
    turns (min, median, runs)."""
    import torch
    import chip_smoke as smoke
    from rpg_ramnet_tpu_torch.ops import voxel
    nb, h, w = smoke.VOX_GRID
    kw = dict(num_bins=nb, height=h, width=w)
    rows = []
    for B, n in SWEEP:
        if B == 1:
            ev, n_valid = smoke.make_events(n, n, dev, seed), n
        else:
            ev, n_valid = smoke.make_window_batch([n] * B, n, dev, seed)
        calls = {f"{k}_{p}": (lambda p=p, s=s: voxel.events_to_voxel_grid_sortseg(
                     ev, n_valid, with_stats=s, path=p, **kw))
                 for p in voxel.PATHS for k, s in (("k6", False), ("k6_stats", True))}
        times = {k: [] for k in calls}
        reps = 20 if B * n <= 1 << 22 else 3
        # a batch of windows: per kernel name the mean of the records the
        # profiler kept (smoke.call_device_us), as phase 10 times batch800
        timer = smoke.device_time_us if B == 1 else smoke.call_device_us
        for _ in range(SWEEP_TURNS):
            for k in list(calls) + list(reversed(calls)):
                times[k].append(timer(calls[k], reps)[0])
        rows.append({"windows": B, "events_per_window": n,
                     "grid_mb": B * nb * h * w * 4 / 2 ** 20,
                     "picked": voxel._launch_plan(B, n, nb, h, w)[0],
                     "device_us": {k: smoke.spread(v) for k, v in times.items()}})
        del ev, calls
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="1M,live,batch800",
                    help="comma-separated VOX_SIZES names; empty for none")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("voxel_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import voxel
    from rpg_ramnet_tpu_torch.utils import require_cuda
    dev = require_cuda()
    t0 = time.perf_counter()
    voxel.library()
    out = {"nvidia_smi": smoke.nvidia_smi_line(),
           "device": torch.cuda.get_device_name(0),
           "build_s": time.perf_counter() - t0,
           "ptxas": kernels.build_log.get("voxel", "")}
    sizes = [s for s in args.sizes.split(",") if s]
    if sizes:
        out["voxelizers"] = smoke.time_voxelizers(dev, args.seed, sizes)
    if args.sweep:
        out["sweep"] = path_sweep(dev, args.seed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
