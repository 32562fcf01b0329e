"""Training: losses, the TBPTT sequence loss, optimizer, steps, checkpoints
and the epoch-loop trainer (``python -m rpg_ramnet_tpu_torch.train``), and
the legacy frame-reconstruction trainer."""
from .frame_trainer import (FrameReconstructionTrainer, contrast_loss,
                            make_preview)

__all__ = ["FrameReconstructionTrainer", "contrast_loss", "make_preview"]
