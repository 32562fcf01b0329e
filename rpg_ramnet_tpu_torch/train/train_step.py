"""Train and eval steps over one TBPTT window.

Counterpart of ``rpg_ramnet_tpu/train/train_step.py`` (reference
lstm_trainer.py:445-453: zero_grad, forward over the L packages, one
backward, optimizer step).  Each window, and with trainer.grad_accum
each micro-batch, starts from the zero state (model.py:146-159).
Gradients come from autograd, with each package checkpointed when
``remat``; the h-side cells' backward is the fused kernel K2 where the
fused_gru policy takes the kernels.  With BN/IN norms the train step
writes the window's running stats into the norms' buffers after the
optimizer step (JAX train_step.py:86-93); under grad_accum n they are the
average of the n micro-batches' final stats, each micro-batch started
from the same stats, as JAX averages its aux.  The eval step runs the
norms in eval mode.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import Config
from ..models.layers import merge_norm_stats
from .sequence_loss import make_sequence_loss


def _batch_dims(batch):
    """(B, H, W) of an 'image' [B, L, H, W, C] batch."""
    s = batch["image"].shape
    return s[0], s[2], s[3]


def micro_batch(batch: Dict[str, torch.Tensor], n: int, i: int
                ) -> Dict[str, torch.Tensor]:
    """The i-th of n equal micro-batches along the batch dimension (every
    key of the port's batches is batch-leading)."""
    b = batch["image"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not divisible by grad_accum={n}")
    size = b // n
    return {k: v[i * size:(i + 1) * size] for k, v in batch.items()}


def make_grad_fn(cfg: Config, model, remat: Optional[bool] = None):
    """Returns grads(batch) -> aux: the parameters' .grad set to the
    window's gradients and the loss terms as tensors.  With
    cfg.trainer.grad_accum n > 1 the batch runs as n micro-batches of
    B/n, each from its own zero state; their gradients and loss terms are
    summed, then divided by n (JAX train_step.py:47-85), and so are the
    training-mode norms' final running stats ('norm_stats', the buffers
    left as they were).  remat defaults to cfg.trainer.remat."""
    n = max(int(cfg.trainer.grad_accum), 1)
    loss_fn = make_sequence_loss(
        cfg, remat=cfg.trainer.remat if remat is None else remat)

    def grads(batch) -> Dict[str, torch.Tensor]:
        model.zero_grad(set_to_none=True)
        total: Dict[str, torch.Tensor] = {}
        stats = []
        for i in range(n):
            mb = micro_batch(batch, n, i) if n > 1 else batch
            loss, aux = loss_fn(model, model.init_state(*_batch_dims(mb)), mb)
            loss.backward()
            if "norm_stats" in aux:
                stats.append(aux.pop("norm_stats"))
            for k, v in aux.items():
                total[k] = total[k] + v.detach() if k in total else v.detach()
        if n > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(n)
            total = {k: v / n for k, v in total.items()}
        if stats:
            total["norm_stats"] = {
                key: {name: sum(s[key][name] for s in stats) / n
                      for name in stats[0][key]}
                for key in stats[0]}
        return total

    return grads


def make_train_step(cfg: Config, model, optimizer: torch.optim.Optimizer,
                    remat: Optional[bool] = None):
    """Returns step(batch) -> aux: one optimizer step on one window, with
    the loss terms and the global norm of the (averaged) gradients
    ('grad_norm') as floats.  remat defaults to cfg.trainer.remat;
    cfg.trainer.grad_accum splits the window batch (make_grad_fn)."""
    grads = make_grad_fn(cfg, model, remat)

    def step(batch) -> Dict[str, float]:
        aux = grads(batch)
        stats = aux.pop("norm_stats", None)
        gs = [p.grad for p in model.parameters() if p.grad is not None]
        aux["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in gs]))
        optimizer.step()
        if stats is not None:
            merge_norm_stats(model, stats)
        return {k: float(v) for k, v in aux.items()}

    return step


def make_eval_step(cfg: Config, model):
    """Returns step(batch) -> aux: the validation loss terms of one window,
    without gradients, the norms in eval mode."""
    loss_fn = make_sequence_loss(cfg, training=False)

    @torch.no_grad()
    def step(batch) -> Dict[str, float]:
        _, aux = loss_fn(model, model.init_state(*_batch_dims(batch)), batch)
        return {k: float(v) for k, v in aux.items()}

    return step
