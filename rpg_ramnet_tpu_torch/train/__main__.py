"""Training entry point: ``python -m rpg_ramnet_tpu_torch.train``.

Counterpart of the repo's ``train.py`` (reference RAM_Net/train.py:246-279):
  -c/--config              JSON config (reference schema, usable as-is)
  -r/--resume              checkpoint directory to resume (model, optimizer,
                           epoch), or a reference .pth.tar (weights, epoch,
                           and its Adam moments for an Adam/AdamW config)
  -i/--initial_checkpoint  weights-only init (.pth.tar or checkpoint dir)
  -g/--gpu_id              the CUDA device index (a single process only)
  --device                 'cuda' (default) or 'cpu'
  --no_mesh                one process, even under torchrun (JAX train.py:28)
  --worker_mode            'thread' (default) or 'process': the data
                           loaders' workers (``data.BatchLoader``); a
                           process pool is shut down when training ends,
                           also when it raises
Data-parallel training: ``torchrun --nproc_per_node N -m
rpg_ramnet_tpu_torch.train -c cfg.json`` starts N ranks, each on
cuda:LOCAL_RANK over NCCL (the CPU over gloo with --device cpu), one
process group over them (``parallel.distributed``);
data_loader.batch_size is the global batch, of which each rank loads and
steps its share, and rank 0 alone writes.  The group is destroyed at the
end.
The dataset root comes from $PREPROCESSED_DATASETS_FOLDER (train.py:95), a
run directory that already exists is refused (train.py:276), and the
transforms are the reference's: RandomRotationFlip(0, 0.5, 0) +
RandomCrop for training, CenterCrop for validation, of
data_loader.crop_size (224 by default).  The trainer reads the rest from
the config as the JAX train.py does: optimizer_type (Adam, AdamW, SGD,
RMSprop), trainer.grad_accum, remat, remat_chunk, remat_policy,
deferred_decode, precompute_x, async_checkpoint and the preview settings
(num_previews, num_val_previews, still_previews, movie, state_preview,
preview_metrics_all_steps; metrics); TensorBoard files go to
<save_dir>/<name>/tensorboard.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from os.path import join
from typing import Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None, writer=None):
    """Parse the flags, build data, model and trainer, train; returns the
    trainer.  writer: a TensorBoard writer for the trainer in place of its
    SummaryWriter (a caller in the same process that records the calls)."""
    ap = argparse.ArgumentParser(description="RAM-Net training (PyTorch)")
    ap.add_argument("-c", "--config", default=None, type=str)
    ap.add_argument("-r", "--resume", default=None, type=str)
    ap.add_argument("-i", "--initial_checkpoint", default=None, type=str)
    ap.add_argument("-g", "--gpu_id", default=None, type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no_mesh", action="store_true",
                    help="one process: no data parallelism under torchrun")
    ap.add_argument("--worker_mode", default="thread",
                    choices=("thread", "process"),
                    help="the data loaders' workers: threads or spawned "
                         "processes")
    args = ap.parse_args(argv)

    config_dict = None
    if args.resume is not None:
        if args.resume.endswith((".pth.tar", ".pth")):
            config_dict = torch.load(args.resume, map_location="cpu",
                                     weights_only=False).get("config")
        else:
            with open(join(args.resume, "meta.json")) as f:
                config_dict = json.load(f)["config"]
    if args.config is not None:
        with open(args.config) as f:
            config_dict = json.load(f)
        run_path = join(config_dict["trainer"]["save_dir"], config_dict["name"])
        if args.resume is None and os.path.exists(run_path):
            raise SystemExit(f"Path {run_path} already exists!")
    if config_dict is None:
        raise SystemExit("need --config or --resume")

    from ..compat import load_reference_checkpoint
    from ..core.config import Config
    from ..data import (BatchLoader, CenterCrop, Compose, RandomCrop,
                        RandomRotationFlip, concatenate_subfolders)
    from ..models import build_model
    from ..parallel import distributed
    from ..utils import require_cuda
    from . import checkpoint
    from .trainer import Trainer

    cfg = Config.from_dict(config_dict)
    data_parallel = distributed.launched() and not args.no_mesh
    if data_parallel:
        if args.device == "cuda":
            torch.cuda.set_device(distributed.local_rank())
        backend = "nccl" if args.device == "cuda" else "gloo"
        distributed.init_from_env(backend)
        # every rank has checked the run directory before rank 0 makes it
        distributed.barrier()
        print(f"data parallel: rank {distributed.rank()} of "
              f"{distributed.world()} over {backend}", flush=True)
    if args.device == "cuda":
        if args.gpu_id is not None and not data_parallel:
            torch.cuda.set_device(args.gpu_id)
        device = require_cuda()
    else:
        device = torch.device("cpu")
    root = os.environ["PREPROCESSED_DATASETS_FOLDER"]
    # the non-recurrent baseline reads raw events (train.py:61,78)
    recurrency = cfg.arch != "ERGB2Depth"

    def build(split, transform):
        return concatenate_subfolders(
            join(root, split.base_folder), split.type, split.event_folder,
            split.depth_folder, split.frame_folder,
            sequence_length=cfg.trainer.sequence_length, transform=transform,
            proba_pause_when_running=split.proba_pause_when_running,
            proba_pause_when_paused=split.proba_pause_when_paused,
            step_size=split.step_size, clip_distance=split.clip_distance,
            every_x_rgb_frame=split.every_x_rgb_frame,
            normalize=cfg.normalize, scale_factor=split.scale_factor,
            reg_factor=split.reg_factor, use_phased_arch=cfg.use_phased_arch,
            baseline=split.baseline,
            loss_composition=cfg.trainer.loss_composition,
            recurrency=recurrency)

    crop = cfg.crop_size
    train_ds = build(cfg.train_data, Compose([RandomRotationFlip(0.0, 0.5, 0.0),
                                              RandomCrop(crop)]))
    val_ds = build(cfg.val_data, CenterCrop(crop))
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=cfg.shuffle,
                               num_workers=cfg.num_workers,
                               worker_mode=args.worker_mode)
    val_loader = BatchLoader(val_ds, cfg.batch_size, shuffle=False,
                             num_workers=cfg.num_workers,
                             worker_mode=args.worker_mode)

    model = build_model(cfg, device=device)
    init = args.initial_checkpoint
    if init is not None:
        if init.endswith((".pth.tar", ".pth")):
            load_reference_checkpoint(model, init)
        else:
            checkpoint.restore(init, model)
        print(f"Loaded initial model weights from: {init}")
    try:
        trainer = Trainer(cfg, train_loader, val_loader, resume=args.resume,
                          model=model, writer=writer)
        trainer.train()
    finally:
        train_loader.close()
        val_loader.close()
        if data_parallel:
            distributed.destroy()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="")
    main()
