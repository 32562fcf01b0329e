"""Epoch-loop trainer.

Counterpart of ``rpg_ramnet_tpu/train/trainer.py`` (reference
RAM_Net/base/base_trainer.py: epoch loop, monitor-best checkpointing,
save_freq, resume; RAM_Net/trainer/lstm_trainer.py: the TBPTT epoch).  The
host sets the learning rate per epoch, moves each batch to the device,
runs one train step per window, validates, logs JSONL and checkpoints.
TensorBoard scalars, previews and histograms are not ported yet (ROADMAP
queue 1, item 8).
"""
from __future__ import annotations

import json
import logging
import os
import time
from os.path import join
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..compat import load_reference_checkpoint
from ..core.config import Config
from ..data.loader import BatchLoader
from ..models import build_model
from . import checkpoint
from .optim import lr_at_epoch, make_optimizer, set_learning_rate
from .sequence_loss import pack_train_batch
from .train_step import make_eval_step, make_train_step


class JsonlLogger:
    """The training log as JSONL, one entry per epoch."""

    def __init__(self, path: str):
        self.path = path
        self.entries: Dict[int, Any] = {}

    def add_entry(self, entry: Dict[str, Any]) -> None:
        self.entries[len(self.entries)] = entry
        with open(self.path, "a") as f:
            f.write(json.dumps(entry, default=float) + "\n")


class Trainer:
    """Trains ``model`` (a fresh model of cfg.arch on ``device`` when
    None) with cfg's optimizer and schedule.  resume: a checkpoint
    directory of this trainer (model, optimizer, epoch) or a reference
    .pth.tar (weights and epoch; the optimizer starts afresh)."""

    def __init__(self, cfg: Config, train_loader: BatchLoader,
                 valid_loader: Optional[BatchLoader] = None,
                 resume: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None,
                 device: Optional[torch.device] = None,
                 run_dir: Optional[str] = None):
        self.cfg = cfg
        self.logger = logging.getLogger("Trainer")
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.run_dir = run_dir or join(cfg.trainer.save_dir, cfg.name)
        os.makedirs(self.run_dir, exist_ok=True)
        with open(join(self.run_dir, "config.json"), "w") as f:
            json.dump(cfg.raw, f, indent=2)
        self.jsonl = JsonlLogger(join(self.run_dir, "train_log.jsonl"))
        self.ckpt = checkpoint.CheckpointManager(self.run_dir)
        self.model = (model if model is not None
                      else build_model(cfg, device=device))
        self.device = self.model.device
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
        self.eval_step = make_eval_step(cfg, self.model)
        self.start_epoch = 0
        self.monitor = cfg.trainer.monitor
        self.monitor_mode = cfg.trainer.monitor_mode
        self.monitor_best = (float("inf") if self.monitor_mode == "min"
                             else -float("inf"))
        if resume:
            self._resume(resume)

    def _resume(self, path: str) -> None:
        if path.endswith((".pth.tar", ".pth")):
            load_reference_checkpoint(self.model, path)
            meta = torch.load(path, map_location="cpu", weights_only=False)
        else:
            meta = checkpoint.restore(path, self.model, self.optimizer)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        mb = meta.get("monitor_best")
        if mb is not None and np.isfinite(float(mb)):
            self.monitor_best = float(mb)
        self.logger.info("Resumed from %s at epoch %d", path, self.start_epoch)

    def _run_epoch(self, loader: BatchLoader, train: bool,
                   epoch: int) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        count = 0
        t0 = time.time()
        loader.set_epoch(epoch)    # resume reproduces the data order
        for i, batch in enumerate(loader):
            batch = pack_train_batch(batch, self.device)
            aux = (self.train_step if train else self.eval_step)(batch)
            for k, v in aux.items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
            if train and self.cfg.trainer.verbosity >= 2 and \
                    i % self.cfg.trainer.log_every == 0:
                self.logger.info("epoch %d [%d/%d] loss=%.4f", epoch, i,
                                 len(loader), aux["loss"])
        out = {k: v / max(count, 1) for k, v in sums.items()}
        out["sec_per_epoch"] = time.time() - t0
        return out

    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        final_log: Dict[str, Any] = {}
        for epoch in range(self.start_epoch, cfg.trainer.epochs):
            lr = lr_at_epoch(cfg, epoch)
            set_learning_rate(self.optimizer, lr)
            log = {"epoch": epoch, "lr": lr,
                   **{f"train_{k}": v for k, v in
                      self._run_epoch(self.train_loader, True, epoch).items()}}
            if self.valid_loader is not None:
                log.update({f"val_{k}": v for k, v in self._run_epoch(
                    self.valid_loader, False, epoch).items()})
            self.jsonl.add_entry(log)
            monitored = log.get(self.monitor)
            if monitored is None:
                monitored = log.get("val_loss", log.get("train_loss"))
            improved = (monitored < self.monitor_best
                        if self.monitor_mode == "min"
                        else monitored > self.monitor_best)
            if improved or epoch % cfg.trainer.save_freq == 0:
                name = f"checkpoint-epoch{epoch}"
                if improved:
                    self.monitor_best = monitored
                self.ckpt.save(name, self.model, self.optimizer, epoch=epoch,
                               monitor_best=self.monitor_best, config=cfg.raw,
                               logger=self.jsonl.entries)
                if improved:
                    self.ckpt.save_best(name)
                    self.logger.info("epoch %d: new best %s=%.5f", epoch,
                                     self.monitor, monitored)
            final_log = log
        return final_log

    def export_reference_checkpoint(self, path: str, epoch: int = 0) -> None:
        """Write a .pth.tar the reference implementation can load."""
        checkpoint.export_pth_tar(path, self.model, self.cfg.arch,
                                  self.cfg.raw, epoch, self.monitor_best)
