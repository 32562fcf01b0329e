"""TBPTT sequence loss.

Counterpart of ``rpg_ramnet_tpu/train/sequence_loss.py`` (reference
RAM_Net/trainer/lstm_trainer.py:152-226,228-390): per-step losses for the
supervised keys (loss_composition/loss_weights), summed over the L packages
of a window, /L, plus the weighted multi-scale gradient loss and the
optional downsampled MSE loss.  The window runs through
``ERGB2DepthRecurrent.forward_sequence_batched_decode`` (the deferred-decode
branch), which decodes only the supervised keys, once.

Known reference bug (lstm_trainer.py:253,281): all supervised keys alias
one loss-accumulator dict, so the reference's effective total is num_keys
x (sum over keys).  The per-key sum here is the fixed one;
``legacy_loss_scaling=True`` multiplies by num_keys to reproduce the
reference's scale.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..models import statenet
from ..models.model import prediction_keys
from . import losses as L

_IN_SCAN = ("the in-scan decode path (forward_sequence with per-step "
            "decodes, remat_chunk > 1, training-mode BN/IN) is not ported "
            "yet: ROADMAP queue 1, item 8")


def supervised_keys(cfg: Config) -> Tuple[str, ...]:
    lc = cfg.trainer.loss_composition
    all_keys = prediction_keys(cfg.model)
    if not lc:
        return all_keys
    return tuple(k for k in all_keys if k in lc)


def pack_train_batch(batch: Dict[str, np.ndarray],
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch of numpy arrays (NHWC, batch-leading: 'events'
    [B, L, K, H, W, Ce], 'image' [B, L, H, W, Ci], 'depth_events'
    [B, L, K, H, W, 1], 'depth_image' [B, L, H, W, 1]) as tensors on
    ``device``; for a CUDA device through pinned memory without blocking.
    The NHWC layout is already the one the model's channels_last convs
    read, so nothing is transposed."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


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

    batch: pack_train_batch's tensors, with 'times_events' [B, L, K] and
    'times_image' [B, L] for the phased regime.  state0: the model's zero
    state.  The deferred-decode branch of the JAX package
    (sequence_loss.py:174): trainer.deferred_decode with remat_chunk 1, the
    package's x side batched when trainer.precompute_x holds, every
    package checkpointed when ``remat``.  The cells may run the kernels
    where precompute_x holds or fused_gru is 'on' (JAX's allow_fused):
    the ConvGRU and ConvLSTM h-side cells (ConvGRUHside, ConvLSTMHside)
    with precompute_x, else the phased encoders' cells (PhasedCell) and
    the ConvLSTM state combination's (ConvLSTMHside).  The in-scan branch
    and the configurations ``statenet.check_supported`` names raise
    NotImplementedError."""
    mcfg = cfg.model
    tr = cfg.trainer
    statenet.check_supported(mcfg)
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
    if tr.remat_policy not in ("", "none"):
        raise NotImplementedError(
            f"trainer.remat_policy={tr.remat_policy!r} (saving tagged "
            "activations in the per-package checkpoint) is not ported yet: "
            "ROADMAP queue 1, item 8")
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
    deferred = tr.deferred_decode and not train_norm and rc == 1
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
        if not deferred:
            raise NotImplementedError(_IN_SCAN)
        seq = {k: batch[k] for k in ("events", "image", "times_events",
                                     "times_image") if k in batch}
        # the composed decoder layers on the L*B*|keys|-deep decode batch
        # (differentiable; statenet._use_composed_decoder's policy), never
        # K8, which has no gradient (sequence_loss.py:190-200 of JAX)
        _, preds = model.forward_sequence_batched_decode(
            state0, seq, decode_keys=keys, remat=remat, squeeze_preds=True,
            package_precompute=pre_x, allow_fused=allow_fused,
            allow_composed=True)
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
        return loss, aux

    return loss_fn
