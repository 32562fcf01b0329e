"""Train and eval steps over one TBPTT window.

Counterpart of ``rpg_ramnet_tpu/train/train_step.py`` (reference
lstm_trainer.py:445-453: zero_grad, forward over the L packages, one
backward, optimizer step).  Each window starts from the zero state
(model.py:146-159).  Gradients come from autograd, with each package
checkpointed when ``remat``; the h-side cells' backward is the fused
kernel K2 where the fused_gru policy takes the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import Config
from .sequence_loss import make_sequence_loss


def _batch_dims(batch):
    """(B, H, W) of an 'image' [B, L, H, W, C] batch."""
    s = batch["image"].shape
    return s[0], s[2], s[3]


def make_train_step(cfg: Config, model, optimizer: torch.optim.Optimizer,
                    remat: Optional[bool] = None):
    """Returns step(batch) -> aux: one optimizer step on one window, with
    the loss terms and the global gradient norm ('grad_norm') as floats.
    remat defaults to cfg.trainer.remat."""
    if int(cfg.raw.get("trainer", {}).get("grad_accum", 1)) > 1:
        raise NotImplementedError(
            "trainer.grad_accum > 1 is not ported yet: ROADMAP queue 1, "
            "item 8")
    loss_fn = make_sequence_loss(
        cfg, remat=cfg.trainer.remat if remat is None else remat)

    def step(batch) -> Dict[str, float]:
        state0 = model.init_state(*_batch_dims(batch))
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, state0, batch)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        aux["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        optimizer.step()
        return {k: float(v.detach()) for k, v in aux.items()}

    return step


def make_eval_step(cfg: Config, model):
    """Returns step(batch) -> aux: the validation loss terms of one window,
    without gradients."""
    loss_fn = make_sequence_loss(cfg, training=False)

    @torch.no_grad()
    def step(batch) -> Dict[str, float]:
        _, aux = loss_fn(model, model.init_state(*_batch_dims(batch)), batch)
        return {k: float(v) for k, v in aux.items()}

    return step
