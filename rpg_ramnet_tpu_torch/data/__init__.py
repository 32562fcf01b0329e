"""Host data path: on-disk sequences -> numpy TBPTT batches (JAX-free)."""
from .augmentation import CenterCrop, Compose, RandomCrop, RandomRotationFlip
from .datasets import (SequenceSynchronizedFramesEventsDataset,
                       SynchronizedFramesEventsDataset, VoxelGridDataset)
from .loader import BatchLoader, ConcatSequenceDataset, concatenate_subfolders
from .synthetic import generate_split

__all__ = [
    "Compose", "CenterCrop", "RandomCrop", "RandomRotationFlip",
    "VoxelGridDataset", "SynchronizedFramesEventsDataset",
    "SequenceSynchronizedFramesEventsDataset", "BatchLoader",
    "ConcatSequenceDataset", "concatenate_subfolders", "generate_split",
]
