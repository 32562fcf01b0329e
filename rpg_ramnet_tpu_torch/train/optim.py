"""Optimizer and learning-rate schedule from the reference config schema.

Counterpart of ``rpg_ramnet_tpu/train/optim.py`` (reference
RAM_Net/base/base_trainer.py:36-43): the optimizer named by
``optimizer_type`` with ``optimizer``'s arguments, and an ExponentialLR
stepped every ``lr_scheduler_freq`` epochs, lr(epoch) = lr0 *
gamma^(epoch // freq), set per epoch by the trainer.  The JAX package's
optax chains, each as its torch counterpart:
  Adam     torch Adam: weight_decay added to the gradient (L2), as
           ``add_decayed_weights`` before ``scale_by_adam``
  AdamW    torch AdamW: decay decoupled from the Adam transform, as
           ``add_decayed_weights`` after it
  SGD      torch SGD: L2 decay, then momentum (``optax.trace``, nesterov
           optional; none when momentum is 0)
  RMSprop  ``RMSpropSqrtEps``: optax's ``scale_by_rms``, which divides by
           sqrt(v + eps) where torch's RMSprop divides by sqrt(v) + eps;
           L2 decay first; no momentum, no centring (the JAX chain reads
           neither)
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


class RMSpropSqrtEps(torch.optim.Optimizer):
    """RMSprop as optax 0.2's ``scale_by_rms`` (eps inside the square
    root): v = alpha v + (1 - alpha) g^2, p -= lr g / sqrt(v + eps), with
    v starting at 0 and g the gradient plus weight_decay * p."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, eps, wd = group["alpha"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad.add(p, alpha=wd)
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                v = state["square_avg"]
                v.mul_(alpha).addcmul_(g, g, value=1 - alpha)
                p.add_(g * torch.rsqrt(v + eps), alpha=-group["lr"])
        return loss


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    name, o = cfg.optimizer_type, cfg.optimizer
    lr = float(o.get("lr", 1e-3))
    wd = float(o.get("weight_decay", 0.0))
    if name in ("Adam", "AdamW"):
        cls = torch.optim.Adam if name == "Adam" else torch.optim.AdamW
        return cls(params, lr=lr, betas=tuple(o.get("betas", (0.9, 0.999))),
                   eps=float(o.get("eps", 1e-8)), weight_decay=wd)
    if name == "SGD":
        momentum = float(o.get("momentum", 0.0))
        return torch.optim.SGD(
            params, lr=lr, momentum=momentum, weight_decay=wd,
            nesterov=bool(momentum and o.get("nesterov", False)))
    if name == "RMSprop":
        return RMSpropSqrtEps(params, lr=lr, alpha=float(o.get("alpha", 0.99)),
                              eps=float(o.get("eps", 1e-8)), weight_decay=wd)
    raise KeyError(f"unknown optimizer_type {name}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
