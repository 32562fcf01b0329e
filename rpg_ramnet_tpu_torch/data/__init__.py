"""Host data path: on-disk sequences -> numpy TBPTT batches (JAX-free)."""
from .augmentation import CenterCrop, Compose, RandomCrop, RandomRotationFlip
from .datasets import (RawEventsDataset,
                       SequenceSynchronizedFramesEventsDataset,
                       SynchronizedFramesEventsDataset,
                       SynchronizedFramesEventsRawDataset, VoxelGridDataset)
from .loader import BatchLoader, ConcatSequenceDataset, concatenate_subfolders
from .synthetic import generate_split

__all__ = [
    "Compose", "CenterCrop", "RandomCrop", "RandomRotationFlip",
    "VoxelGridDataset", "RawEventsDataset", "SynchronizedFramesEventsDataset",
    "SynchronizedFramesEventsRawDataset",
    "SequenceSynchronizedFramesEventsDataset", "BatchLoader",
    "ConcatSequenceDataset", "concatenate_subfolders", "generate_split",
]
