"""Top-level entry points of the port: the counterparts of the repo's
``__graft_entry__.py``.

entry(device=None)          -> (fn, args): one datapackage forward (5
                               event voxel grids + 1 frame) of the
                               flagship ERGB2DepthRecurrent at B=2,
                               128x128; fn(model, state, pkg) ->
                               (preds['image'], new state).
dryrun_multichip(n, ...)    -> one data-parallel train step over n ranks
                               (one process each, started as torchrun
                               starts them), the deferred-decode step,
                               and one lane-mesh engine step with reset
                               masks, on tiny shapes.

    python -m rpg_ramnet_tpu_torch.entry --dryrun N [--device cpu]

The JAX dry run's DP x spatial legs wait for spatial partitioning
(ROADMAP queue 1, item 15).  Both run on the card unless the caller asks
for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from .core.config import Config, MeshConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flagship_config(tiny: bool = False) -> Config:
    """``__graft_entry__._flagship_config``, as the port's Config."""
    model = {
        "num_bins_rgb": 1, "num_bins_events": 5, "skip_type": "sum",
        "recurrent_block_type": "conv", "state_combination": "convgru",
        "num_encoders": 2 if tiny else 3,
        "base_num_channels": 4 if tiny else 32,
        "num_residual_blocks": 1 if tiny else 2,
        "use_upsample_conv": True, "norm": "none",
    }
    return Config.from_dict({
        "name": "graft", "arch": "ERGB2DepthRecurrent",
        "use_phased_arch": False,
        "data_loader": {"train": {"every_x_rgb_frame": 3 if tiny else 5,
                                  "baseline": False,
                                  "clip_distance": 80.0, "reg_factor": 3.70378},
                        "batch_size": 2},
        "optimizer_type": "Adam", "optimizer": {"lr": 3e-4, "weight_decay": 0},
        "loss": {"type": "scale_invariant_loss",
                 "config": {"weight": 1.0, "n_lambda": 1.0}},
        "grad_loss": {"weight": 0.25},
        "trainer": {"epochs": 1, "sequence_length": 2,
                    "loss_composition": ["image", "events2" if tiny else "events4"],
                    "loss_weights": [1, 1]},
        "model": model,
    })


def _device(device) -> torch.device:
    if device is None:
        from .utils import require_cuda
        return require_cuda()
    return torch.device(device)


def entry(device=None):
    """(fn, (model, state, pkg)): the flagship's seeded weights, its zero
    state and a package drawn from numpy seed 0, as JAX's entry() draws
    them."""
    from .models import build_model
    dev = _device(device)
    cfg = _flagship_config()
    B, H, W, K = 2, 128, 128, cfg.model.every_x_rgb_frame
    model = build_model(cfg, device=dev)
    state = model.init_state(B, H, W)
    rng = np.random.RandomState(0)
    pkg = {"events": torch.from_numpy(
               rng.randn(B, K, H, W, 5).astype(np.float32)).to(dev),
           "image": torch.from_numpy(
               rng.rand(B, H, W, 1).astype(np.float32)).to(dev)}

    def fn(model, state, pkg):
        with torch.inference_mode():
            new_state, preds = model.forward_package(state, pkg)
        return preds["image"], new_state

    return fn, (model, state, pkg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_devices(n: int, device: torch.device):
    """(rank r's device, backend) for n ranks: cuda:r with NCCL where the
    host has n cards, else ranks share the cards over gloo (NCCL refuses
    two ranks on one GPU); the CPU over gloo."""
    if device.type != "cuda":
        return [torch.device("cpu")] * n, "gloo"
    count = torch.cuda.device_count()
    return ([torch.device("cuda", r % count) for r in range(n)],
            "nccl" if count >= n else "gloo")


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 600.0) -> Dict[str, float]:
    """Start n ranks of ``_dryrun_rank`` (``python -m
    rpg_ramnet_tpu_torch.entry``, torchrun's environment on localhost),
    wait for them, and return rank 0's results; raises if any rank
    fails."""
    dev = _device(device)
    port = _free_port()
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "WORLD_SIZE": str(n_devices),
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rpg_ramnet_tpu_torch.entry", "--rank_worker",
         "--dryrun", str(n_devices), "--device", dev.type],
        cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:\n"
                               f"{out[-3000:]}")
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def _dryrun_rank(n_devices: int, device: torch.device) -> Dict[str, float]:
    """One rank of the dry run (the process group from torchrun's
    environment): the train step and the deferred-decode step on this
    rank's share of a global batch of n_devices windows; rank 0 also runs
    the lane engine over an n-device mesh."""
    import dataclasses
    import torch.distributed as dist
    from .eval.inference import BatchedStreamingInference
    from .models import build_model
    from .parallel import distributed, make_mesh
    from .parallel.input_pipeline import local_batch
    from .train.optim import make_optimizer
    from .train.train_step import make_train_step

    devices, backend = _rank_devices(n_devices, device)
    dev = devices[int(os.environ["RANK"])]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    distributed.init_from_env(backend)
    try:
        r, w = distributed.rank(), distributed.world()
        if w != n_devices:
            raise RuntimeError(f"world {w}, expected {n_devices}")
        cfg = _flagship_config(tiny=True)
        K = cfg.model.every_x_rgb_frame
        B, L, H, W = n_devices, 2, 32, 32
        model = build_model(cfg, device=dev)
        distributed.broadcast_module(model)
        opt = make_optimizer(cfg, model.parameters())
        rng = np.random.RandomState(0)
        batch = {"events": rng.randn(B, L, K, H, W, 5).astype(np.float32),
                 "image": rng.rand(B, L, H, W, 1).astype(np.float32),
                 "depth_events": rng.rand(B, L, K, H, W, 1).astype(np.float32),
                 "depth_image": rng.rand(B, L, H, W, 1).astype(np.float32)}
        mine = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in local_batch(batch, r, w).items()}
        aux = make_train_step(cfg, model, opt)(mine)
        cfg_dd = dataclasses.replace(cfg, trainer=dataclasses.replace(
            cfg.trainer, deferred_decode=True))
        aux_dd = make_train_step(cfg_dd, model, opt)(mine)
        # the ranks hold one model: the parameters' sum agrees everywhere
        total = torch.stack([p.detach().double().sum()
                             for p in model.parameters()]).sum().reshape(1)
        lo, hi = total.clone(), total.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        spread = float(hi - lo)
        out = {"loss": aux["loss"], "grad_norm": aux["grad_norm"],
               "loss_deferred": aux_dd["loss"], "param_sum_spread": spread}
        if not (np.isfinite(out["loss"]) and np.isfinite(out["loss_deferred"])
                and spread == 0.0):
            raise RuntimeError(f"dry run rank {r}: {out}")
        if r == 0:
            lane_devices = (devices if dev.type == "cuda"
                            else [dev] * n_devices)
            mesh = make_mesh(MeshConfig(data=n_devices, model=1),
                             lane_devices)
            eng = BatchedStreamingInference(model, n_devices, H, W, mesh=mesh)
            preds = eng.step(
                {"events": rng.randn(n_devices, K, H, W, 5).astype(np.float32),
                 "image": rng.rand(n_devices, H, W, 1).astype(np.float32)},
                np.arange(n_devices) % 2 == 0)
            out["lane_finite"] = bool(torch.isfinite(preds["image"]).all())
            if not out["lane_finite"]:
                raise RuntimeError("lane-mesh step: non-finite maps")
        return out
    finally:
        distributed.destroy()


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, default=2,
                    help="number of ranks of the data-parallel dry run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank_worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = _device(None if args.device == "cuda" else "cpu")
    if args.rank_worker:
        out = _dryrun_rank(args.dryrun, dev)
    else:
        out = dryrun_multichip(args.dryrun, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
