"""Events -> frame image-reconstruction trainer.

Counterpart of ``rpg_ramnet_tpu/train/frame_trainer.py`` (the reference's
legacy E2VID-style ``Trainer``, RAM_Net/trainer/trainer.py:8-189): per-item
supervised reconstruction of the grayscale frame from an event voxel
grid, with an optional CONTRAST loss ``w * (std(pred) - std(target))^2``
(trainer/trainer.py:106-107), preview grids [events | pred | target]
(:59-69) and per-batch metric rows (:44-50).  One step is the loss,
autograd's gradients and the torch optimizer's update; previews and
metrics are host-side numpy, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def contrast_loss(pred: torch.Tensor, target: torch.Tensor,
                  weight: float) -> torch.Tensor:
    """w * (std(pred) - std(target))^2 — trainer/trainer.py:106 (torch.std
    is the sample std, ddof=1)."""
    def _std(x):
        m = x.mean()
        return torch.sqrt(((x - m) ** 2).sum() / max(x.numel() - 1, 1))
    return weight * (_std(pred) - _std(target)) ** 2


def make_preview(events: np.ndarray, target: np.ndarray,
                 pred: np.ndarray) -> np.ndarray:
    """[events-sum | pred | target] 1x3 grid, each panel min/max normalized
    (utils.make_grid(normalize=True, scale_each=True) semantics,
    trainer/trainer.py:59-69).  events [H,W,C]; target/pred [H,W,1].
    Returns [H, 3W] float in [0,1]."""
    panels = [np.sum(events, axis=-1), pred[..., 0], target[..., 0]]
    out = []
    for p in panels:
        lo, hi = float(p.min()), float(p.max())
        out.append((p - lo) / (hi - lo) if hi > lo else np.zeros_like(p))
    return np.concatenate(out, axis=1)


class FrameReconstructionTrainer:
    """Per-item reconstruction training: batches {'events': [B,H,W,C],
    'frame': [B,H,W,1]} (numpy or tensors) -> model pred -> base_loss +
    contrast loss.

    model: the nn.Module whose parameters ``optimizer`` (a torch
    optimizer) updates, on the device the batches are moved to;
    model_apply(model, events) -> pred [B,H,W,1]; base_loss(pred, target)
    -> scalar tensor; metrics: list of (name, fn(pred_np, target_np))."""

    def __init__(self, model: torch.nn.Module, model_apply: Callable,
                 base_loss: Callable, optimizer: torch.optim.Optimizer,
                 weight_contrast_loss: float = 0.0,
                 metrics: Optional[List[Tuple[str, Callable]]] = None):
        self.model = model
        self.opt = optimizer
        self.metrics = metrics or []
        self.weight_contrast = float(weight_contrast_loss)
        self._apply = model_apply
        self.base_loss = base_loss
        self.device = next(model.parameters()).device

    def _loss(self, events, frame):
        pred = self._apply(self.model, events)
        loss = (self.base_loss(pred, frame)
                + contrast_loss(pred, frame, self.weight_contrast))
        return loss, pred

    def _tensors(self, batch):
        return tuple(torch.as_tensor(batch[k]).to(self.device)
                     for k in ("events", "frame"))

    def _metric_row(self, pred: np.ndarray, target: np.ndarray) -> np.ndarray:
        return np.asarray([fn(pred, target) for _, fn in self.metrics])

    def _epoch(self, batches, train: bool):
        total_loss, n = 0.0, 0
        total_metrics = np.zeros(len(self.metrics))
        for batch in batches:
            ev, fr = self._tensors(batch)
            with torch.set_grad_enabled(train):
                loss, pred = self._loss(ev, fr)
            if train:
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                self.opt.step()
            total_loss += loss.item()
            total_metrics += self._metric_row(pred.detach().float().cpu().numpy(),
                                              fr.float().cpu().numpy())
            n += 1
        return total_loss / max(n, 1), (total_metrics / max(n, 1)).tolist()

    def train_epoch(self, batches: Iterable[Dict[str, Any]],
                    preview_items: Iterable[Dict[str, Any]] = ()) \
            -> Dict[str, Any]:
        loss, metrics = self._epoch(batches, train=True)
        return {"loss": loss, "metrics": metrics,
                "previews": [self.preview(item) for item in preview_items]}

    def valid_epoch(self, batches: Iterable[Dict[str, Any]],
                    preview_items: Iterable[Dict[str, Any]] = ()) \
            -> Dict[str, Any]:
        loss, metrics = self._epoch(batches, train=False)
        return {"val_loss": loss, "val_metrics": metrics,
                "val_previews": [self.preview(item) for item in preview_items]}

    @torch.no_grad()
    def preview(self, item: Dict[str, Any]) -> np.ndarray:
        """item: unbatched {'events': [H,W,C], 'frame': [H,W,1]}."""
        ev = torch.as_tensor(item["events"]).to(self.device)[None]
        pred = self._apply(self.model, ev)[0].float().cpu().numpy()
        return make_preview(np.asarray(item["events"]),
                            np.asarray(item["frame"]), pred)
