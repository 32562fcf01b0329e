"""RAM-Net in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``rpg_ramnet_tpu`` (JAX), which stays the numerical reference.
This package imports ``torch`` and never ``jax``; it runs on the CPU through
the plain PyTorch versions of its kernels and on a CUDA card through the
hand-written kernels under ``csrc/`` (built by ``kernels``).

Layout (each module names its JAX counterpart):

  core/config.py        Config, TrainerConfig, DataSplitConfig, ModelConfig,
                        parsed from the reference JSON schema
  models/layers.py      conv layers and the ConvGRU cell (nn.Modules)
  models/statenet.py    encoders, x-side gates, h-side combination, decoder
                        (the baselines: the image branch alone)
  models/unet.py        the plain UNet of the non-recurrent baseline
  models/model.py       ERGB2DepthRecurrent (inference and training forwards),
                        ERGB2Depth; models.build_model picks one by arch
  ops/gru_hside.py      the ConvGRU h-side cell: kernels K1, K1-res, K2, the
                        ConvGRUHside autograd.Function, plain versions
  ops/gradient.py       sobel gradients and pooling for the gradient loss
  ops/depth.py, voxel.py  numpy log-depth, gray and voxel helpers
  kernels/              nvcc build + ctypes loader for csrc/*.cu
  compat/from_jax.py    weights from the JAX package or a .pth.tar
  eval/inference.py     chunked offline inference over recorded sequences
  train/                losses, TBPTT sequence loss, Adam, train/eval steps,
                        checkpoints, the trainer; python -m
                        rpg_ramnet_tpu_torch.train
  data/                 datasets, loader, augmentation, synthetic splits
  utils/device.py       require_cuda and the float32 precision settings

Public tensors are NHWC, as in the JAX package; modules run NCHW-shaped
views in ``torch.channels_last`` memory, which is physically NHWC.
"""
