"""Configuration, parsed from the reference JSON schema.

Counterpart of ``rpg_ramnet_tpu/core/config.py`` (``ModelConfig``,
``DataSplitConfig``, ``TrainerConfig``, ``MeshConfig``, ``Config``), reduced to the fields
the ported slices read, with the JAX package's defaults.  These are the
port's own classes so that it loads nothing of the JAX package.
``ModelConfig.from_dict`` reads a config file's ``model`` section and
inherits ``every_x_rgb_frame`` and ``baseline`` from ``data_loader.train``
as the reference's train.py does, and ``loss_composition`` from ``trainer``
as the JAX ``Config.from_dict`` does (``event_loop_range`` reads it).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Union


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
    baseline: Union[bool, str] = False      # False | 'rgb' | 'e' | 'ergb' | 'ergb0'
    # the supervised keys, inherited from trainer.loss_composition; a
    # baseline 'e' runs K-1 event steps only where it is the string
    # 'image' (model.event_loop_range, as JAX), never for a list
    loss_composition: Union[bool, str, Tuple[str, ...]] = False
    num_output_channels: int = 1
    activation: str = "sigmoid"
    # the post-conv feature map of the first phased encoder is
    # spatial_resolution / 2 (the time gate is per feature), so it must
    # match the crop the model runs at
    spatial_resolution: Tuple[int, int] = (112, 112)
    use_phased_arch: bool = False
    compute_dtype: str = "float32"         # 'float32' | 'bfloat16'
    fast_upsample: bool = False
    # the ConvGRU h-side kernel on the precomputed path (ops/gru_hside.py):
    # 'auto' = CUDA bf16 tensors of a supported shape, 'on' = always (raises
    # where the kernel cannot run), 'off' = the plain layer
    fused_gru: str = "auto"
    # the JAX package's opt-in h-side launch structures on the precomputed
    # path; only 'on' enables them.  fused_pair: scales 0 and 1 in one
    # launch (ops/gru_pair.py, K9) where the fused cells run; fused_stream:
    # the gx-streaming cells (ops/gru_stream.py, K10a, K10b; batch 1),
    # whatever fused_gru says
    fused_pair: str = "auto"
    fused_stream: str = "auto"
    # the JAX package's decoder switches: 'on' selects the fused
    # upsample-conv kernel (K8) or the composed transposed-conv layers,
    # neither ported yet (statenet.check_supported raises); 'auto' and
    # 'off' run the two-stage layers, as the JAX streaming engines do
    fused_decoder: str = "auto"
    composed_decoder: str = "auto"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        norm = d.get("norm")
        if norm in ("none", "None", ""):
            norm = None
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["norm"] = norm
        if "spatial_resolution" in kw:
            kw["spatial_resolution"] = tuple(int(v) for v in
                                             kw["spatial_resolution"])
        if isinstance(kw.get("loss_composition"), list):
            kw["loss_composition"] = tuple(kw["loss_composition"])
        return ModelConfig(**kw)

    @staticmethod
    def from_config_dict(cfg: Dict[str, Any]) -> "ModelConfig":
        """The ``model`` section of a whole reference config file."""
        model_d = dict(cfg.get("model", {}))
        train_d = cfg.get("data_loader", {}).get("train", {})
        model_d.setdefault("every_x_rgb_frame",
                           train_d.get("every_x_rgb_frame", 1))
        model_d.setdefault("baseline", train_d.get("baseline", False))
        model_d.setdefault("loss_composition", cfg.get("trainer", {}).get(
            "loss_composition", False))
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


@dataclasses.dataclass(frozen=True)
class DataSplitConfig:
    """config['data_loader'][split] (reference train.py:99-137)."""
    type: str = "SequenceSynchronizedFramesEventsDataset"
    base_folder: str = ""
    event_folder: str = "events/voxels"
    depth_folder: str = "depth/data"
    frame_folder: str = "rgb/data"
    proba_pause_when_running: float = 0.0
    proba_pause_when_paused: float = 0.0
    step_size: int = 1
    clip_distance: float = 100.0
    every_x_rgb_frame: int = 1
    scale_factor: float = 1.0
    reg_factor: float = 5.7
    baseline: Union[bool, str] = False

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DataSplitConfig":
        return DataSplitConfig(**_typed(DataSplitConfig, d))


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    epochs: int = 100
    sequence_length: int = 10
    save_dir: str = "runs"
    save_freq: int = 4
    verbosity: int = 2
    monitor: str = "val_loss"
    monitor_mode: str = "min"
    # per-epoch TensorBoard previews (lstm_trainer.py:480-550): grids of
    # num_previews training and num_val_previews validation items, their
    # movies, the preview metric vector, weight and gradient histograms
    num_previews: int = 2
    num_val_previews: int = 2
    still_previews: bool = False
    movie: bool = True
    grid_loss: bool = False
    # the '--record' super-state change images (lstm_trainer.py:295-377)
    state_preview: bool = False
    loss_composition: Union[bool, Tuple[str, ...]] = False
    loss_weights: Tuple[float, ...] = (1.0,)
    # replicate the reference's loss-aliasing scale (x num_keys)
    legacy_loss_scaling: bool = False
    # the preview metrics: False scores each key's first-step prediction
    # against the last supervised key's first-step depth (the reference,
    # lstm_trainer.py:283,377,516); True each key against its own depth,
    # averaged over the window
    preview_metrics_all_steps: bool = False
    log_every: int = 25
    remat: bool = True          # torch.utils.checkpoint per package
    remat_chunk: int = 1        # packages per checkpoint (in-scan path)
    # decode the supervised keys once, outside the per-package loop
    deferred_decode: bool = False
    # with deferred_decode: batch each package's x side, leaving only the
    # h-side cells sequential (and on the fused cell kernels)
    precompute_x: bool = False
    # what each package's checkpoint saves: 'none', or a '+'-joined list
    # of tags ('enc_out': the encoder outputs; 'gru_gx': the x-side gate
    # pre-activations of the precompute_x path)
    remat_policy: str = "none"
    # micro-batches per optimizer step (gradients averaged); the JAX
    # package reads it from the raw config (train_step.py:47)
    grad_accum: int = 1
    # write checkpoints on a background thread (trainer.py:63)
    async_checkpoint: bool = False

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainerConfig":
        kw = _typed(TrainerConfig, d)
        if isinstance(kw.get("loss_composition"), list):
            kw["loss_composition"] = tuple(kw["loss_composition"])
        if "loss_weights" in kw:
            kw["loss_weights"] = tuple(float(w) for w in kw["loss_weights"])
        return TrainerConfig(**kw)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The device mesh of a config's ``mesh`` key (JAX config.py:244-258):
    ``data`` devices on the data axis (-1: all the devices there are,
    divided by ``model``), ``model`` on the model axis (spatial
    partitioning, not ported: ROADMAP queue 1, item 15).  ``dcn_data`` is
    parsed and ignored, as JAX's ``make_mesh`` ignores it."""
    data: int = -1
    model: int = 1
    dcn_data: int = 1

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MeshConfig":
        return MeshConfig(data=int(d.get("data", -1)),
                          model=int(d.get("model", 1)),
                          dcn_data=int(d.get("dcn_data", 1)))


@dataclasses.dataclass(frozen=True)
class Config:
    """A whole reference-schema config file (what train.py reads)."""
    name: str = "run"
    arch: str = "ERGB2DepthRecurrent"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train_data: DataSplitConfig = dataclasses.field(
        default_factory=DataSplitConfig)
    val_data: DataSplitConfig = dataclasses.field(
        default_factory=DataSplitConfig)
    batch_size: int = 8
    num_workers: int = 4
    normalize: bool = True
    shuffle: bool = True
    crop_size: int = 224
    optimizer_type: str = "Adam"
    optimizer: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"lr": 3e-4})
    lr_scheduler_type: str = "ExponentialLR"
    lr_scheduler_freq: int = 100
    lr_scheduler: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"gamma": 0.5})
    loss_type: str = "scale_invariant_loss"
    loss_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    grad_loss_weight: Optional[float] = None   # None: no gradient loss
    mse_loss_weight: Optional[float] = None
    mse_loss_downsampling_factor: float = 0.5
    # the config file's top-level key, which test.py passes to the dataset
    # (timestamps in the items)
    use_phased_arch: bool = False
    # the preview metric vector's metrics (eval.metrics.get_metric names)
    metrics: Tuple[str, ...] = ("mse", "abs_rel_diff",
                                "scale_invariant_error", "median_error")
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                            hash=False, compare=False)

    @staticmethod
    def from_dict(cfg: Dict[str, Any]) -> "Config":
        dl = cfg.get("data_loader", {})
        train_d = dl.get("train", {})
        loss = cfg.get("loss", {})
        grad_loss, mse_loss = cfg.get("grad_loss"), cfg.get("mse_loss")
        return Config(
            name=str(cfg.get("name", "run")),
            arch=str(cfg.get("arch", "ERGB2DepthRecurrent")),
            model=ModelConfig.from_config_dict(cfg),
            train_data=DataSplitConfig.from_dict(train_d),
            val_data=DataSplitConfig.from_dict(dl.get("validation", train_d)),
            batch_size=int(dl.get("batch_size", 8)),
            num_workers=int(dl.get("num_workers", 4)),
            normalize=bool(dl.get("normalize", True)),
            shuffle=bool(dl.get("shuffle", True)),
            crop_size=int(dl.get("crop_size", 224)),
            optimizer_type=str(cfg.get("optimizer_type", "Adam")),
            optimizer=dict(cfg.get("optimizer", {"lr": 3e-4})),
            lr_scheduler_type=str(cfg.get("lr_scheduler_type",
                                          "ExponentialLR")),
            lr_scheduler_freq=int(cfg.get("lr_scheduler_freq", 100)),
            lr_scheduler=dict(cfg.get("lr_scheduler", {"gamma": 0.5})),
            loss_type=str(loss.get("type", "scale_invariant_loss")),
            loss_config=dict(loss.get("config", {})),
            grad_loss_weight=(None if grad_loss is None
                              else float(grad_loss.get("weight", 1.0))),
            mse_loss_weight=(None if mse_loss is None
                             else float(mse_loss.get("weight", 1.0))),
            mse_loss_downsampling_factor=(
                0.5 if mse_loss is None
                else float(mse_loss.get("downsampling_factor", 0.5))),
            use_phased_arch=bool(cfg.get("use_phased_arch", False)),
            metrics=tuple(cfg.get("metrics", Config.metrics)),
            trainer=TrainerConfig.from_dict(cfg.get("trainer", {})),
            mesh=MeshConfig.from_dict(cfg.get("mesh", {})),
            raw=cfg)

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            return Config.from_dict(json.load(f))


def _typed(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of d that are fields of cls, converted to the field's
    type where it is a plain int, float, str or bool."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            if f.type in ("int", "float", "str", "bool"):
                v = {"int": int, "float": float, "str": str,
                     "bool": bool}[f.type](v)
            kw[f.name] = v
    return kw
