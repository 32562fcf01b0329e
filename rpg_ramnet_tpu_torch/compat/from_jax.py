"""Weights into the port: from the JAX package's params or a .pth.tar,
and a reference checkpoint's Adam state into the port's optimizer.

The port's parameter names are the upstream torch names, so both sources
load with ``load_state_dict(strict=True)`` and no remapping.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn


def params_to_state_dict(params: Any, arch: str = "ERGB2DepthRecurrent"
                         ) -> Dict[str, np.ndarray]:
    """A JAX param tree (nested dicts and lists of arrays, HWIO conv
    weights) -> upstream-named numpy arrays: the arch prefix, dotted
    paths with list indices, conv weights transposed HWIO -> OIHW and
    ConvTranspose2d weights to (in, out, kh, kw).  The port's own copy of
    ``rpg_ramnet_tpu/compat/torch_import.py::params_to_state_dict``, so
    that loading JAX params imports nothing of the JAX package."""
    prefix = ("statenetphasedrecurrent." if arch == "ERGB2DepthRecurrent"
              else "unet.")
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            value = np.asarray(node)
            parent = path[-2] if len(path) >= 2 else ""
            if path[-1] == "weight" and value.ndim == 4:
                value = np.transpose(value, (2, 3, 0, 1)
                                     if parent == "transposed_conv2d"
                                     else (3, 2, 0, 1))
            out[prefix + ".".join(path)] = value

    walk(params, ())
    return out


def params_from_jax(model: nn.Module, params: Any,
                    arch: str = "ERGB2DepthRecurrent") -> nn.Module:
    """Load a JAX param tree (arrays or numpy) into ``model``:
    ``params_to_state_dict``, then ``load_state_dict(strict=True)``, which
    casts to the model's dtype and memory format."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in params_to_state_dict(params, arch).items()}
    model.load_state_dict(sd, strict=True)
    return model


def load_reference_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load an upstream RAM-Net checkpoint (``.pth.tar``: a dict with a
    'state_dict', as RAM_Net/base/base_trainer.py:133-158 writes it, or a
    bare state dict) into ``model``.  Upstream checkpoints pickle more
    than tensors (the config and logger), so this unpickles: load only
    trusted files.  The port's norms keep no ``num_batches_tracked`` (their
    momentum is fixed, so the count is never read): the key is dropped
    where upstream's BatchNorm2d/InstanceNorm2d wrote it, and a file with
    or without it loads with strict=True."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)
    return model


def ordered_param_names(state_dict: Dict[str, Any]) -> list:
    """A reference state dict's parameter names in torch registration
    order, which is the index order of its optimizer's state
    (``optim.Adam(model.parameters())``, base_trainer.py:36-43); the
    buffers (BN running stats, num_batches_tracked) left out.  The
    counterpart of JAX ``compat/torch_import.py::ordered_param_names``."""
    return [n for n in state_dict
            if not n.endswith("num_batches_tracked") and ".running_" not in n]


def import_reference_optimizer_state(optimizer: torch.optim.Optimizer,
                                     model: nn.Module,
                                     ckpt: Dict[str, Any]) -> None:
    """Load a reference checkpoint's torch Adam state ('exp_avg',
    'exp_avg_sq', 'step' per parameter index) into ``optimizer`` (an Adam
    or AdamW over ``model.parameters()``), so that a resumed run continues
    the reference's moments (JAX ``import_torch_optimizer_state``,
    compat/torch_import.py:115-176).  Each index is mapped to its name
    through ``ordered_param_names`` of the checkpoint's state dict and to
    the port's parameter of that name; every parameter takes the largest
    step, as JAX's one Adam count, and one absent from the checkpoint's
    state zero moments."""
    names = ordered_param_names(ckpt["state_dict"])
    moments, step = {}, 0
    for idx, st in ckpt["optimizer"]["state"].items():
        moments[names[int(idx)]] = (st["exp_avg"], st["exp_avg_sq"])
        step = max(step, int(torch.as_tensor(st["step"]).item()))
    for name, p in model.named_parameters():
        state = {"step": torch.tensor(float(step))}
        for key, i in (("exp_avg", 0), ("exp_avg_sq", 1)):
            buf = torch.zeros_like(p, memory_format=torch.preserve_format)
            if name in moments:
                buf.copy_(torch.as_tensor(moments[name][i]))
            state[key] = buf
        optimizer.state[p] = state
