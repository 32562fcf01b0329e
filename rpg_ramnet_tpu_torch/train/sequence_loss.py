"""TBPTT sequence loss.

Counterpart of ``rpg_ramnet_tpu/train/sequence_loss.py`` (reference
RAM_Net/trainer/lstm_trainer.py:152-226,228-390): per-step losses for the
supervised keys (loss_composition/loss_weights), summed over the L packages
of a window, /L, plus the weighted multi-scale gradient loss and the
optional downsampled MSE loss.  The window runs through
``ERGB2DepthRecurrent.forward_sequence_batched_decode`` with
trainer.deferred_decode (the supervised keys decoded once, after the
packages), else through ``forward_sequence`` (a decode per package and
supervised key, each package checkpointed with its decodes); ERGB2Depth,
which has no deferred decode, always through its ``forward_sequence``
(the window as one batch).  With BN/IN norms a training loss runs them in
training mode (batch statistics), the running stats carried through the
window by ``forward_sequence`` and returned as aux['norm_stats'], which
the train step writes back (JAX sequence_loss.py:103-173).

Known reference bug (lstm_trainer.py:253,281): all supervised keys alias
one loss-accumulator dict, so the reference's effective total is num_keys
x (sum over keys).  The per-key sum here is the fixed one;
``legacy_loss_scaling=True`` multiplies by num_keys to reproduce the
reference's scale.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch

from ..core.config import Config
from ..models import get_model, statenet, unet
from ..models.layers import extract_norm_stats
from ..models.model import prediction_keys
from . import losses as L



def supervised_keys(cfg: Config) -> Tuple[str, ...]:
    lc = cfg.trainer.loss_composition
    all_keys = prediction_keys(cfg.model)
    if not lc:
        return all_keys
    return tuple(k for k in all_keys if k in lc)


def _target_for(batch: Dict[str, torch.Tensor], key: str) -> torch.Tensor:
    """Time-leading squeezed target [L, B, H, W] for a prediction key."""
    if key == "image":
        t = batch["depth_image"]
    else:
        t = batch["depth_events"][:, :, int(key[len("events"):])]
    return t[..., 0].movedim(1, 0)


def make_sequence_loss(cfg: Config, remat: bool = False,
                       training: bool = True):
    """Returns loss_fn(model, state0, batch) -> (scalar, aux dict).

    batch: a loader batch as tensors (``data.device_prefetch``): 'events'
    [B, L, K, H, W, Ce], 'image' [B, L, H, W, Ci], 'depth_events'
    [B, L, K, H, W, 1], 'depth_image' [B, L, H, W, 1] (NHWC, the layout the
    model's channels_last convs read), with 'times_events' [B, L, K] and
    'times_image' [B, L] for the phased regime.  state0: the model's zero
    state.  The branches of the JAX package (sequence_loss.py:124-220):
    training with BN/IN norms (``training`` and cfg.model.norm): the
    in-scan branch with the norms in training mode from the model's
    running stats, every package group checkpointed when ``remat``,
    deferred_decode and precompute_x given way with JAX's warnings, and
    aux['norm_stats'] the window's final stats (no gradient).  Else the
    deferred-decode branch for trainer.deferred_decode with remat_chunk 1
    (a model without it, ERGB2Depth, takes its forward_sequence), the
    package's x side batched when trainer.precompute_x holds (never for a
    baseline, as JAX warns), every package checkpointed when ``remat``;
    the cells may run the kernels where precompute_x holds or fused_gru is
    'on' (JAX's allow_fused): the ConvGRU and ConvLSTM h-side cells
    (ConvGRUHside, ConvLSTMHside) with precompute_x, else the phased
    encoders' cells (PhasedCell) and the ConvLSTM state combination's
    (ConvLSTMHside).  Otherwise the in-scan branch: forward_sequence with
    its decodes, on the plain cells, checkpointed in groups of
    trainer.remat_chunk packages.  trainer.remat_policy is accepted and
    every checkpoint recomputes its packages whole, as 'none' (ROADMAP
    queue 3).  training=False: the norms in eval mode, as the reference
    validates under model.eval()."""
    mcfg = cfg.model
    tr = cfg.trainer
    model_cls = get_model(cfg.arch)
    deferred_model = hasattr(model_cls, "forward_sequence_batched_decode")
    (statenet if deferred_model else unet).check_supported(mcfg)
    keys = supervised_keys(cfg)
    lc = tr.loss_composition
    weights = {k: (tr.loss_weights[list(lc).index(k)] if lc else 1.0)
               for k in keys}
    base_loss = L.get_loss(cfg.loss_type)
    loss_kwargs = dict(cfg.loss_config)
    use_grad = cfg.grad_loss_weight is not None
    use_mse = cfg.mse_loss_weight is not None
    num_keys = max(len(keys), 1)
    rc = max(int(tr.remat_chunk), 1)
    train_norm = training and mcfg.norm in ("BN", "IN")
    if tr.deferred_decode and rc > 1:
        warnings.warn(
            "trainer.deferred_decode is incompatible with remat_chunk>1 "
            "(the batched-decode scan checkpoints per package); honoring "
            "remat_chunk with the in-scan decode path instead",
            stacklevel=2)
    if tr.deferred_decode and train_norm:
        warnings.warn(
            "trainer.deferred_decode is incompatible with training-mode "
            "BN/IN (batch stats must match the reference's per-step "
            "statistics); using the in-scan decode path",
            stacklevel=2)
    deferred = tr.deferred_decode and rc == 1 and not train_norm
    pre_x = bool(tr.precompute_x)
    if pre_x and not (deferred and statenet.supports_x_precompute(mcfg)):
        warnings.warn(
            "trainer.precompute_x requires an effective deferred_decode "
            "(remat_chunk==1, no BN/IN training mode) AND "
            "recurrent_block_type='conv' with convgru/convlstm state "
            "combination; ignoring it",
            stacklevel=2)
        pre_x = False
    allow_fused = pre_x or mcfg.fused_gru == "on"

    def loss_fn(model, state0, batch):
        seq = {k: batch[k] for k in ("events", "image", "times_events",
                                     "times_image") if k in batch}
        stats = None
        if train_norm:
            _, preds, stats = model.forward_sequence(
                state0, seq, decode_keys=keys, remat=remat,
                squeeze_preds=True, remat_chunk=rc,
                norm_stats=extract_norm_stats(model))
        elif deferred and deferred_model:
            # the composed decoder layers on the L*B*|keys|-deep decode
            # batch (differentiable; statenet._use_composed_decoder's
            # policy), never K8, which has no gradient
            # (sequence_loss.py:190-200 of JAX)
            _, preds = model.forward_sequence_batched_decode(
                state0, seq, decode_keys=keys, remat=remat,
                squeeze_preds=True, package_precompute=pre_x,
                allow_fused=allow_fused, allow_composed=True)
        else:
            _, preds = model.forward_sequence(
                state0, seq, decode_keys=keys, remat=remat,
                squeeze_preds=True, remat_chunk=rc)
        l_steps = batch["image"].shape[1]
        total_si = total_grad = total_mse = 0.0
        per_key: Dict[str, torch.Tensor] = {}
        for k in keys:
            pred = preds[k]                       # [L, B, H, W]
            target = _target_for(batch, k)
            w = weights[k]
            si = sum(base_loss(p, t, **loss_kwargs)
                     for p, t in zip(pred, target))
            si = w * si / l_steps
            total_si = total_si + si
            per_key[f"L_si_{k}"] = si
            if use_grad:
                g = sum(L.multi_scale_grad_loss(p[..., None], t[..., None])
                        for p, t in zip(pred, target))
                g = cfg.grad_loss_weight * w * g / l_steps
                total_grad = total_grad + g
                per_key[f"L_grad_{k}"] = g
            if use_mse:
                f = cfg.mse_loss_downsampling_factor
                pr, ta = pred, target
                if f != 1.0:
                    size = (int(pred.shape[2] * f), int(pred.shape[3] * f))
                    pr, ta = (L.resize_bilinear(x, *size)
                              for x in (pred, target))
                m = sum(L.mse_loss(p, t) for p, t in zip(pr, ta))
                m = cfg.mse_loss_weight * w * m / l_steps
                total_mse = total_mse + m
                per_key[f"L_mse_{k}"] = m
        loss = total_si + total_grad + total_mse
        if tr.legacy_loss_scaling:
            loss = loss * num_keys
        aux = {"loss": loss, "L_si": total_si}
        if use_grad:
            aux["L_grad"] = total_grad
        if use_mse:
            aux["L_mse"] = total_mse
        aux.update(per_key)
        if stats is not None:
            aux["norm_stats"] = stats
        return loss, aux

    return loss_fn
