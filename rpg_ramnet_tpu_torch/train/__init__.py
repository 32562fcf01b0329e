"""Training: losses, the TBPTT sequence loss, optimizer, steps, checkpoints
and the epoch-loop trainer (``python -m rpg_ramnet_tpu_torch.train``)."""
