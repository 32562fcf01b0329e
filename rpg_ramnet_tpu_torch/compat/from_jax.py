"""Weights into the port: from the JAX package's params or a .pth.tar.

The port's parameter names are the upstream torch names, so both sources
load with ``load_state_dict(strict=True)`` and no remapping.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn


def params_from_jax(model: nn.Module, params: Any,
                    arch: str = "ERGB2DepthRecurrent") -> nn.Module:
    """Load a JAX param tree (arrays or numpy) into ``model``: the JAX
    package's own ``params_to_state_dict`` (OIHW transposes, upstream
    names), then ``load_state_dict(strict=True)``, which casts to the
    model's dtype and memory format.  Imports that JAX-free module of the
    JAX package only here, where JAX params exist."""
    from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in params_to_state_dict(params, arch).items()}
    model.load_state_dict(sd, strict=True)
    return model


def load_reference_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load an upstream RAM-Net checkpoint (``.pth.tar``: a dict with a
    'state_dict', as RAM_Net/base/base_trainer.py:133-158 writes it, or a
    bare state dict) into ``model``.  Upstream checkpoints pickle more
    than tensors (the config and logger), so this unpickles: load only
    trusted files."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)
    return model
