from .device import require_cuda

__all__ = ["require_cuda"]
