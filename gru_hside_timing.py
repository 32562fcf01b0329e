#!/usr/bin/env python3
"""Time kernels K1 and K1-res (the fused ConvGRU h-side cell) on one GPU.

    python3 gru_hside_timing.py [--root DIR] [--plans auto,split1]
                                [--label NAME] [--sweep] [--gates]
    python3 gru_hside_timing.py --fit SWEEP.jsonl

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
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import chip_smoke   # this tree's helpers; the package comes from --root

FLAGSHIP_CELLS = ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256))
TRAIN_CELLS = ((16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256))
ITERS = 20   # launches per timed turn
SWEEP_FILE = "gru_hside_sweep.jsonl"


def fit_model(lines):
    """(model, report): the ``_K1_MODEL`` weights fitted to sweep lines
    ({"sweep": "k1" or "k1_res", "shape", "plan", "us"}) by non-negative
    least squares of the relative error, rounded to three significant
    digits, and the fit's median and largest relative error and, per
    shape, the planner's pick under that model against the swept best."""
    import numpy as np
    from scipy.optimize import nnls
    from rpg_ramnet_tpu_torch.ops import gru_hside
    rows = [r for r in lines if "sweep" in r]
    keys = list(gru_hside._K1_MODEL)
    A, t = [], []
    for r in rows:
        res, plan = r["sweep"] == "k1_res", gru_hside.K1Plan(*r["plan"])
        terms = gru_hside.k1_cost_terms(plan, r["shape"][-1], res)
        waves = gru_hside.k1_waves(plan, *r["shape"][:3])
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
    """csrc/gru_hside.cu built with -DRAMNET_K1_EXACT_GATES into a
    temporary directory, loaded with the wrapper's signatures."""
    out = os.path.join(tempfile.mkdtemp(), "libgru_hside_exact.so")
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DRAMNET_K1_EXACT_GATES",
         "-o", out, str(kernels.CSRC / "gru_hside.cu")],
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    for name, (restype, argtypes) in gru_hside._FWD_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)
    return lib


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--plans", default="auto,split1")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--gates", action="store_true")
    ap.add_argument("--fit", default=None, metavar="SWEEP.jsonl")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.fit:
        with open(args.fit) as f:
            model, report = fit_model([json.loads(line) for line in f if line.strip()])
        print(json.dumps({"_K1_MODEL": model}))
        print(json.dumps(report))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gru_hside_timing: needs a CUDA device", file=sys.stderr)
        return 2
    from rpg_ramnet_tpu_torch import kernels
    from rpg_ramnet_tpu_torch.ops import gru_hside
    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi_line()
    lib = gru_hside.library()
    ptxas = chip_smoke.ptxas_by_kernel(kernels.build_log.get("gru_hside", ""))
    planned = hasattr(gru_hside, "plan_k1")
    sets = args.plans.split(",") if planned else ["default"]
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
