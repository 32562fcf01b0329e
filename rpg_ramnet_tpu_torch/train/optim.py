"""Optimizer and learning-rate schedule from the reference config schema.

Counterpart of ``rpg_ramnet_tpu/train/optim.py`` (reference
RAM_Net/base/base_trainer.py:36-43): the optimizer named by
``optimizer_type`` with ``optimizer``'s arguments, and an ExponentialLR
stepped every ``lr_scheduler_freq`` epochs, lr(epoch) = lr0 *
gamma^(epoch // freq), set per epoch by the trainer.  torch's Adam adds its
weight_decay to the gradient (L2), as optax's ``add_decayed_weights``
placed before ``scale_by_adam`` does.  Adam is what every shipped config
names; the JAX package's other optimizers are not ported yet.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ..core.config import Config


def lr_at_epoch(cfg: Config, epoch: int) -> float:
    lr0 = float(cfg.optimizer.get("lr", 1e-3))
    if cfg.lr_scheduler_type == "ExponentialLR":
        gamma = float(cfg.lr_scheduler.get("gamma", 1.0))
        return lr0 * gamma ** (epoch // max(cfg.lr_scheduler_freq, 1))
    if cfg.lr_scheduler_type == "StepLR":
        gamma = float(cfg.lr_scheduler.get("gamma", 0.1))
        step_size = int(cfg.lr_scheduler.get("step_size", 30))
        return lr0 * gamma ** (epoch // step_size)
    return lr0


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    if cfg.optimizer_type != "Adam":
        raise NotImplementedError(
            f"optimizer_type={cfg.optimizer_type!r} is not ported yet: "
            "ROADMAP queue 1, item 8")
    o = cfg.optimizer
    return torch.optim.Adam(params, lr=float(o.get("lr", 1e-3)),
                            betas=tuple(o.get("betas", (0.9, 0.999))),
                            eps=float(o.get("eps", 1e-8)),
                            weight_decay=float(o.get("weight_decay", 0.0)))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
