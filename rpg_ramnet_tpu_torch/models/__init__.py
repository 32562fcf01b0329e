from typing import Optional

import torch

from ..core.config import Config
from ..core.registry import MODELS
from .model import ERGB2Depth, ERGB2DepthRecurrent, event_loop_range, prediction_keys


def get_model(arch: str):
    """The model class a config's ``arch`` names."""
    return MODELS.get(arch)


def build_model(cfg: Config, device=None,
                generator: Optional[torch.Generator] = None):
    """A new model of the config file's ``arch`` and ``model`` section on
    ``device``, its weights drawn from ``generator`` (seeded 0 when
    None)."""
    return get_model(cfg.arch)(cfg.model, device=device, generator=generator)


__all__ = ["ERGB2Depth", "ERGB2DepthRecurrent", "MODELS", "build_model",
           "event_loop_range", "get_model", "prediction_keys"]
