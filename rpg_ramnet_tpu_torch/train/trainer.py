"""Epoch-loop trainer.

Counterpart of ``rpg_ramnet_tpu/train/trainer.py`` (reference
RAM_Net/base/base_trainer.py: epoch loop, monitor-best checkpointing,
save_freq, resume, TensorBoard and JSON logging;
RAM_Net/trainer/lstm_trainer.py: the TBPTT epoch and the previews).  The
host sets the learning rate per epoch, takes each batch through
``device_prefetch`` (the next ones copied to the card while a step runs),
runs one train step per window, validates, logs JSONL and TensorBoard
scalars, writes the previews, and checkpoints.

TensorBoard: a ``SummaryWriter`` under ``<run_dir>/tensorboard``, or the
writer passed in; none where tensorboard does not import, and then, as in
JAX, nothing but the JSONL log is written.  Per epoch, with
trainer.still_previews or trainer.movie: a grid of inputs, predictions and
depth per key for num_previews training and num_val_previews validation
items, each also as a GIF movie (trainer.movie; needs PIL), the preview
metric vector, and the weights' and last training batch's gradients'
histograms with the gradient-flow figure (needs matplotlib); with
trainer.state_preview the super-state change images.  A preview that fails
is logged and kept in ``preview_errors``, as JAX logs it, and training
goes on.
"""
from __future__ import annotations

import importlib
import json
import logging
import os
import sys
import time
import types
from os.path import join
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..compat import import_reference_optimizer_state, load_reference_checkpoint
from ..core.config import Config
from ..data.loader import BatchLoader, device_prefetch
from ..models import build_model, statenet
from ..utils.layout import to_nchw
from ..utils.training_utils import (add_video_gif, named_weights,
                                    plot_grad_flow_bars,
                                    select_evenly_spaced_elements,
                                    strip_arch_prefix)
from . import checkpoint
from .optim import lr_at_epoch, make_optimizer, set_learning_rate
from .train_step import make_eval_step, make_grad_fn, make_train_step


def importable(module: str) -> bool:
    try:
        importlib.import_module(module)
        return True
    except ImportError:
        return False


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
    .pth.tar (weights, epoch, and its Adam moments where the optimizer is
    Adam or AdamW).  writer: the TensorBoard writer (a SummaryWriter
    under the run directory when None)."""

    def __init__(self, cfg: Config, train_loader: BatchLoader,
                 valid_loader: Optional[BatchLoader] = None,
                 resume: Optional[str] = None,
                 model: Optional[torch.nn.Module] = None,
                 device: Optional[torch.device] = None,
                 run_dir: Optional[str] = None, writer=None):
        self.cfg = cfg
        self.logger = logging.getLogger("Trainer")
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.run_dir = run_dir or join(cfg.trainer.save_dir, cfg.name)
        os.makedirs(self.run_dir, exist_ok=True)
        with open(join(self.run_dir, "config.json"), "w") as f:
            json.dump(cfg.raw, f, indent=2)
        self.jsonl = JsonlLogger(join(self.run_dir, "train_log.jsonl"))
        self.tb = (writer if writer is not None
                   else self._make_tb(join(self.run_dir, "tensorboard")))
        self.preview_errors: List[str] = []
        self.ckpt = checkpoint.CheckpointManager(
            self.run_dir, use_async=cfg.trainer.async_checkpoint)
        self.model = (model if model is not None
                      else build_model(cfg, device=device))
        self.device = self.model.device
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
        self.eval_step = make_eval_step(cfg, self.model)
        self._last_batch = None
        self.start_epoch = 0
        self.monitor = cfg.trainer.monitor
        self.monitor_mode = cfg.trainer.monitor_mode
        self.monitor_best = (float("inf") if self.monitor_mode == "min"
                             else -float("inf"))
        if resume:
            self._resume(resume)

    def _make_tb(self, path: str):
        if "tensorflow" not in sys.modules:
            # tensorboard writes through TensorFlow where TensorFlow
            # imports, which takes seconds and may import JAX; its own
            # stub writes the same event files
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            self.logger.warning("tensorboard does not import (%s): no "
                                "TensorBoard scalars or previews", e)
            return None
        return SummaryWriter(path)

    def _resume(self, path: str) -> None:
        if path.endswith((".pth.tar", ".pth")):
            load_reference_checkpoint(self.model, path)
            meta = torch.load(path, map_location="cpu", weights_only=False)
            if meta.get("optimizer") and isinstance(
                    self.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
                import_reference_optimizer_state(self.optimizer, self.model,
                                                 meta)
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
        for i, batch in enumerate(device_prefetch(loader, self.device)):
            if train:
                aux = self.train_step(batch)
                self._last_batch = batch
            else:
                aux = self.eval_step(batch)
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

    # ------------------------------------------------------------------
    # previews (lstm_trainer.py:295-377, 480-550; JAX trainer.py:166-339)
    # ------------------------------------------------------------------

    def _item_seq(self, item) -> Dict[str, torch.Tensor]:
        """A dataset item's window as a batch-1 sequence on the device;
        the phased regime's timestamps too, so that previews see the
        training forward."""
        keys = ["events", "image"]
        if self.cfg.use_phased_arch:
            keys += ["times_events", "times_image"]
        return {k: torch.from_numpy(np.asarray(item[k])[None]).to(self.device)
                for k in keys if k in item}

    def _write_previews(self, epoch: int, tag_prefix: str,
                        loader: BatchLoader, num_previews: int) -> None:
        """Per key: a grid of inputs, predictions and depth over the
        window, its movie, and the preview metric vector (cfg.metrics on
        evenly spaced items, lstm_trainer.py:100-106,488-523)."""
        if self.tb is None or num_previews <= 0 or len(loader.dataset) == 0:
            return
        from ..eval.metrics import get_metric
        tr = self.cfg.trainer
        metric_fns = [(m, get_metric(m)) for m in self.cfg.metrics]
        total = np.zeros(len(metric_fns))
        movies = tr.movie and self._can_write_movies()
        idxs = select_evenly_spaced_elements(num_previews, len(loader.dataset))
        for p_i, idx in enumerate(idxs):
            item, _ = loader.dataset[idx]
            h, w = item["image"].shape[1:3]
            with torch.no_grad():
                _, preds = self.model.forward_sequence(
                    self.model.init_state(1, h, w), self._item_seq(item))
            preds = {k: v[:, 0, :, :, 0].float().cpu().numpy()
                     for k, v in preds.items()}          # [L, H, W]

            def gt_for(key):
                if key == "image":
                    return item["depth_image"][:, :, :, 0]
                return item["depth_events"][:, int(key[len("events"):]), :, :, 0]

            # the reference scores every key against `new_target` carried
            # out of its loss loop: the depth of the last supervised key in
            # prediction order (lstm_trainer.py:283,377,516)
            sup = tr.loss_composition
            sup_keys = [k for k in preds if (not sup) or k in sup]
            gt_ref = gt_for((sup_keys or list(preds))[-1])
            for key, pred in preds.items():
                gt = gt_for(key)
                inp = (item["image"] if key == "image" else
                       item["events"][:, int(key[len("events"):])]).sum(axis=-1)
                inp = np.clip(inp * 0.5 + 0.5, 0, 1)
                grid = np.concatenate([
                    np.concatenate(list(inp), axis=1),
                    np.concatenate(list(pred), axis=1),
                    np.concatenate(list(np.nan_to_num(gt)), axis=1)], axis=0)
                self.tb.add_image(f"{tag_prefix}{p_i}_{key}__input_pred_gt",
                                  grid[None], epoch)
                if movies:
                    # frames input | prediction | depth, at fps 5
                    frames = np.concatenate([inp, pred, np.nan_to_num(gt)],
                                            axis=-1)      # [L, H, 3W]
                    add_video_gif(self.tb,
                                  f"movie_{p_i}__{key}__prediction__groundtruth",
                                  frames[None, :, None], fps=5,
                                  global_step=epoch)
                for mi, (_, fn) in enumerate(metric_fns):
                    if tr.preview_metrics_all_steps:
                        total[mi] += float(np.nanmean(
                            [fn(pred[t][None, None], gt[t][None, None])
                             for t in range(pred.shape[0])]))
                    else:
                        total[mi] += fn(pred[0][None, None],
                                        gt_ref[0][None, None])
        for (name, _), v in zip(metric_fns, total / max(num_previews, 1)):
            self.tb.add_scalar(f"{tag_prefix}metric_{name}", float(v), epoch)

    def _can_write_movies(self) -> bool:
        missing = [m for m in ("PIL", "tensorboard") if not importable(m)]
        if missing:
            self.logger.warning("%s does not import: no preview movies",
                                " and ".join(missing))
        return not missing

    def _write_histograms(self, epoch: int) -> None:
        """Histograms of every weight and of its gradient on the last
        training batch, and the gradient-flow figure
        (lstm_trainer.py:505-548, training_utils.py:85-124).  The
        gradients come from one more backward of the training loss, with
        no optimizer step, split as the train step splits the batch
        (trainer.grad_accum micro-batches, so the peak memory stays the
        step's; JAX takes the whole batch at once: ROADMAP queue 3); no
        .grad is left behind."""
        if self.tb is None or self._last_batch is None:
            return
        if not hasattr(self, "_grad_fn"):
            self._grad_fn = make_grad_fn(self.cfg, self.model)
        self._grad_fn(self._last_batch)
        grads = {strip_arch_prefix(n): (p.grad if p.grad is not None
                                        else torch.zeros_like(p))
                 .float().cpu().numpy()
                 for n, p in self.model.named_parameters()}
        self.model.zero_grad(set_to_none=True)
        for name, w in named_weights(self.model).items():
            self.tb.add_histogram(name + "/weights", w, epoch)
        for name, g in grads.items():
            self.tb.add_histogram(name + "/grad", g, epoch)
        if importable("matplotlib"):
            self.tb.add_figure("grad_figure", plot_grad_flow_bars(grads),
                               global_step=epoch)
        else:
            self.logger.warning("matplotlib does not import: no "
                                "gradient-flow figure (grad_figure)")

    def _write_state_previews(self, epoch: int, loader: BatchLoader) -> None:
        """The '--record' images: per-scale super-state changes over each
        modality step, normalised by their 98th percentile, 3 channel
        slices upsampled to a common grid (lstm_trainer.py:295-377), at
        window steps {1, L/2, L-1} of the loader's first item."""
        if self.tb is None or len(loader.dataset) == 0:
            return
        from scipy.ndimage import zoom as nd_zoom
        mcfg = self.cfg.model
        item, _ = loader.dataset[0]
        l_steps = item["image"].shape[0]
        h, w = item["image"].shape[1:3]
        state = self.model.init_state(1, h, w)
        if not hasattr(state, "super_states"):
            return
        net = self.model.statenetphasedrecurrent
        state = statenet.map_state(to_nchw, state)
        K = mcfg.every_x_rgb_frame

        def change_grid(prev, cur):
            rows = []
            for i, (c, p) in enumerate(zip(cur.super_states,
                                           prev.super_states)):
                if isinstance(c, tuple):
                    c, p = c[0], p[0]
                delta = (c[0] - p[0]).float().cpu().numpy()   # [C, h, w]
                p98 = np.percentile(np.abs(delta), 98)
                delta = np.clip(delta / (p98 + 1e-8), -1, 1)
                dim = delta.shape[0]
                slices = nd_zoom(delta[(0, dim // 2, dim - 1), :, :],
                                 (1, 2 ** i, 2 ** i), order=1)
                rows.append(np.concatenate(list(slices), axis=1))
            return np.concatenate(rows, axis=0)

        def frame(x):
            return to_nchw(torch.from_numpy(np.asarray(x)[None]).to(self.device))

        grids: Dict[str, list] = {}
        record_steps = {1, l_steps // 2, l_steps - 1}
        with torch.no_grad():
            for l in range(l_steps):
                pkg_states = [state]
                for k in range(K):
                    state = statenet.forward_modality(
                        net, mcfg, frame(item["events"][l, k]), state,
                        "image" if mcfg.is_baseline else "events")
                    pkg_states.append(state)
                state = statenet.forward_modality(
                    net, mcfg, frame(item["image"][l]), state, "image")
                pkg_states.append(state)
                if l in record_steps and l > 0:
                    keys = [f"events{k}" for k in range(K)] + ["image"]
                    for ki, key in enumerate(keys):
                        grids.setdefault(key, []).append(
                            change_grid(pkg_states[ki], pkg_states[ki + 1]))
        for key, gs in grids.items():
            grid = np.concatenate(gs, axis=1)
            self.tb.add_image(f"state_change_{key}",
                              (np.clip(grid, -1, 1)[None] + 1) / 2, epoch)

    def _write_tensorboard(self, epoch: int, log: Dict[str, Any]) -> None:
        """The epoch's scalars, then the previews in JAX's order."""
        tr = self.cfg.trainer
        for k, v in log.items():
            if isinstance(v, (int, float)):
                self.tb.add_scalar(k, v, epoch)
        try:
            if tr.still_previews or tr.movie:
                self._write_previews(epoch, "preview_", self.train_loader,
                                     tr.num_previews)
                if self.valid_loader is not None:
                    self._write_previews(epoch, "val_preview_",
                                         self.valid_loader,
                                         tr.num_val_previews)
                self._write_histograms(epoch)
            if tr.state_preview:
                self._write_state_previews(epoch, self.train_loader)
        except Exception as e:       # as JAX: log, and go on training
            self.model.zero_grad(set_to_none=True)
            self.preview_errors.append(f"epoch {epoch}: {e!r}")
            self.logger.warning("preview writing failed: %r", e,
                                exc_info=True)

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
            if self.tb is not None:
                self._write_tensorboard(epoch, log)
            monitored = log.get(self.monitor)
            if monitored is None:
                monitored = log.get("val_loss", log.get("train_loss"))
            improved = (monitored < self.monitor_best
                        if self.monitor_mode == "min"
                        else monitored > self.monitor_best)
            if improved or epoch % cfg.trainer.save_freq == 0:
                # the checkpoint carries the best before this epoch, as
                # JAX's (trainer.py:382-386): inf at a first improvement
                name = f"checkpoint-epoch{epoch}"
                self.ckpt.save(name, self.model, self.optimizer, epoch=epoch,
                               monitor_best=self.monitor_best, config=cfg.raw,
                               logger=self.jsonl.entries)
                if improved:
                    self.monitor_best = monitored
                    self.ckpt.save_best(name)
                    self.logger.info("epoch %d: new best %s=%.5f", epoch,
                                     self.monitor, monitored)
            final_log = log
        self.ckpt.wait()
        if self.tb is not None:
            self.tb.flush()
        return final_log

    def export_reference_checkpoint(self, path: str, epoch: int = 0) -> None:
        """Write a .pth.tar the reference implementation can load."""
        checkpoint.export_pth_tar(path, self.model, self.cfg.arch,
                                  self.cfg.raw, epoch, self.monitor_best)
