"""Host data path: on-disk sequences -> numpy TBPTT batches (JAX-free);
``raw_pipeline`` voxelizes raw-event batches on the device."""
from .timestamps import (TimestampIndex, first_element_greater_than,
                         last_element_less_than)
from .augmentation import CenterCrop, Compose, RandomCrop, RandomRotationFlip
from .datasets import (FrameDataset, RawEventsDataset,
                       SequenceSynchronizedFramesEventsDataset,
                       SynchronizedFramesEventsDataset,
                       SynchronizedFramesEventsRawDataset, VoxelGridDataset)
from .loader import (BatchLoader, ConcatSequenceDataset,
                     concatenate_subfolders, device_prefetch)
from . import synthetic
from .synthetic import generate_split

__all__ = [
    "TimestampIndex", "first_element_greater_than", "last_element_less_than",
    "Compose", "CenterCrop", "RandomCrop", "RandomRotationFlip",
    "VoxelGridDataset", "RawEventsDataset", "FrameDataset",
    "SynchronizedFramesEventsDataset", "SynchronizedFramesEventsRawDataset",
    "SequenceSynchronizedFramesEventsDataset", "ConcatSequenceDataset",
    "BatchLoader", "concatenate_subfolders", "device_prefetch", "synthetic",
    "generate_split",
]
