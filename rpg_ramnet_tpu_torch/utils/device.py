"""Device selection for the port: a CUDA card or an explicit error.

Nothing here picks the CPU by itself.  Code that measures or smoke-tests
the card calls ``require_cuda()``; CPU runs (the tests) pass
``torch.device('cpu')`` explicitly.
"""
from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The current CUDA device, with float32 convolutions and matrix
    products in full float32 (cuDNN's default is TF32, about three decimal
    digits).  Raises RuntimeError when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on an NVIDIA GPU only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())
