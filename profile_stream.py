#!/usr/bin/env python3
"""Where the time of the port's per-package streaming step goes, on one GPU.

    python3 profile_stream.py [--steps N] [--seed S] [--out DIR] [--phased]

The flagship recipe (configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json,
bf16, K=5) at 256x512 with random weights from --seed, through
``StreamingInference.step`` with batched decode, once with
fused_gru='on' (kernel K5 for every cell) and once with 'off' (the plain
bf16 cells), in turns off, on, on, off.  With --phased, the phased
regime instead (the same recipe with phased ConvLSTM encoders and the
ConvLSTM state combination, as chip_smoke.py's phase 12) at 256x352,
packages with timestamps: 'on' runs kernels K4 and K3.  Each turn runs three warm-up
packages, then N packages under torch.profiler (CPU and CUDA activities).
Per turn it prints one JSON line: the wall ms per package, device time by
kernel name (the top 12, summed over the turn), the device's busy time
(the union of its kernel and copy intervals) and idle share of the
turn's wall time, and the host's time in cudaLaunchKernel,
cudaFuncSetAttribute, aten::copy_ and aten::convolution.  Traces go to
--out (chrome trace JSON; runs/profile_stream by default).  Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json"
H, W = 256, 512


def busy_ms(events):
    """Length of the union of the device intervals, ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/profile_stream")
    ap.add_argument("--phased", action="store_true",
                    help="the phased regime at 256x352")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_stream: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from rpg_ramnet_tpu_torch.core.config import ModelConfig
    from rpg_ramnet_tpu_torch.eval import StreamingInference
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, event_loop_range
    from rpg_ramnet_tpu_torch.utils import require_cuda

    dev = require_cuda()
    cfg = ModelConfig.load(os.path.join(ROOT, CONFIG))
    h, w = H, W
    if args.phased:
        h, w = 256, 352
        cfg = dataclasses.replace(
            cfg, recurrent_block_type="convlstm", state_combination="convlstm",
            use_phased_arch=True, spatial_resolution=(h, w))
    K = event_loop_range(cfg)
    models = {}
    for mode in ("on", "off"):
        models[mode] = ERGB2DepthRecurrent(
            dataclasses.replace(cfg, fused_gru=mode), device=dev,
            generator=torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    pkgs = [{"events": rng.standard_normal((K, h, w, 5), dtype=np.float32),
             "image": rng.random((h, w, 1), dtype=np.float32)} for _ in range(4)]
    if args.phased:
        for i, p in enumerate(pkgs):
            p["times_events"] = np.float32(0.05 * i + 0.01 * np.arange(K))
            p["times_image"] = p["times_events"][-1]
    os.makedirs(args.out, exist_ok=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    for turn, mode in enumerate(("off", "on", "on", "off")):
        engine = StreamingInference(models[mode], batched_decode=True)
        for i in range(3):
            engine.step(pkgs[i % 4])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                engine.step(pkgs[i % 4])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(args.out, f"{turn}_{mode}.json"))
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in dev_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        busy = busy_ms(dev_events)
        host = {name: sum(e.cpu_time_total for e in prof.key_averages()
                          if e.key == name) / 1e3
                for name in ("cudaLaunchKernel", "cudaFuncSetAttribute",
                             "aten::copy_", "aten::convolution")}
        print(json.dumps({
            "mode": mode, "turn": turn, "packages": args.steps,
            "wall_ms_per_package": wall_ms / args.steps,
            "device_busy_ms_per_package": busy / args.steps,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_kernels": len(dev_events) / args.steps,
            "top_device_ms_per_package": {k: v / args.steps for k, v in top},
            "host_ms_per_package": {k: v / args.steps for k, v in host.items()},
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
