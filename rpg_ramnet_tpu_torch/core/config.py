"""Model configuration, parsed from the reference JSON schema.

Counterpart of ``rpg_ramnet_tpu/core/config.py::ModelConfig``, reduced to
the fields the ported slice reads.  It is its own class so that the port
loads nothing of the JAX package.  ``from_dict`` reads a config file's
``model`` section and inherits ``every_x_rgb_frame`` and ``baseline`` from
``data_loader.train`` as the reference's train.py does.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Union


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_bins_rgb: int = 1
    num_bins_events: int = 5
    skip_type: str = "sum"
    state_combination: str = "sum"
    num_encoders: int = 4
    base_num_channels: int = 32
    num_residual_blocks: int = 2
    recurrent_block_type: str = "convlstm"
    norm: Optional[str] = None
    use_upsample_conv: bool = True
    every_x_rgb_frame: int = 1
    baseline: Union[bool, str] = False
    num_output_channels: int = 1
    activation: str = "sigmoid"
    use_phased_arch: bool = False
    compute_dtype: str = "float32"         # 'float32' | 'bfloat16'
    fast_upsample: bool = False
    # the ConvGRU h-side kernel on the precomputed path (ops/gru_hside.py):
    # 'auto' = CUDA bf16 tensors of a supported shape, 'on' = always (raises
    # where the kernel cannot run), 'off' = the plain layer
    fused_gru: str = "auto"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        norm = d.get("norm")
        if norm in ("none", "None", ""):
            norm = None
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["norm"] = norm
        return ModelConfig(**kw)

    @staticmethod
    def from_config_dict(cfg: Dict[str, Any]) -> "ModelConfig":
        """The ``model`` section of a whole reference config file."""
        model_d = dict(cfg.get("model", {}))
        train_d = cfg.get("data_loader", {}).get("train", {})
        model_d.setdefault("every_x_rgb_frame",
                           train_d.get("every_x_rgb_frame", 1))
        model_d.setdefault("baseline", train_d.get("baseline", False))
        model_d.setdefault("use_phased_arch", cfg.get("use_phased_arch", False))
        return ModelConfig.from_dict(model_d)

    @staticmethod
    def load(path: str) -> "ModelConfig":
        with open(path) as f:
            return ModelConfig.from_config_dict(json.load(f))

    @property
    def max_num_channels(self) -> int:
        return self.base_num_channels * (2 ** self.num_encoders)

    @property
    def encoder_input_sizes(self) -> List[int]:
        return [self.base_num_channels * (2 ** i)
                for i in range(self.num_encoders)]

    @property
    def encoder_output_sizes(self) -> List[int]:
        return [self.base_num_channels * (2 ** (i + 1))
                for i in range(self.num_encoders)]

    @property
    def is_baseline(self) -> bool:
        return bool(self.baseline)
