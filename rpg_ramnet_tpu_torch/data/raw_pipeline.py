"""Raw-event pipeline with ON-DEVICE voxelization.

Counterpart of ``rpg_ramnet_tpu/data/raw_pipeline.py``.  The reference
voxelizes raw events on the CPU inside DataLoader workers
(dataset_asynchronous.py:253-298, the hot CPU loop).  Here the host only
pads raw event windows to bucketed fixed shapes with validity counts;
voxelization and normalization run on the card, over all windows of a
batch in one launch sequence of the voxel kernel (K6), inside the
prefetch stage, while the consumer trains on the batch before.

Shapes: a batch of event windows is [B, L, K, N_max, 4] + counts [B, L, K];
the device stage produces [B, L, K, H, W, num_bins] voxel grids ready for
the model: the grids the synchronized dataset's voxel files hold,
normalized as it normalizes them.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import voxel as V
from .loader import device_prefetch


def bucket_size(n: int, buckets: Sequence[int] = (2048, 8192, 32768, 131072, 524288)) -> int:
    """Static-shape bucketing for per-window event counts (irregular MVSEC
    counts take few distinct padded shapes)."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 524287) // 524288) * 524288


def pad_event_windows(windows: List[np.ndarray],
                      n_max: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """List of [N_i, 4] windows -> ([W, N_max, 4] padded, [W] counts).
    n_max None: the bucket of the longest window, so two calls can pad to
    different N_max; pass n_max where their results are stacked."""
    counts = np.array([w.shape[0] for w in windows], np.int32)
    if n_max is None:
        n_max = bucket_size(int(counts.max()) if len(counts) else 1)
    out = np.zeros((len(windows), n_max, 4), np.float32)
    for i, w in enumerate(windows):
        out[i, :w.shape[0]] = w[:, :4]
    return out, counts


def voxelize_batch(events, counts, *, num_bins: int, height: int, width: int,
                   backend: str = "scatter", normalize: bool = True
                   ) -> torch.Tensor:
    """[..., N, 4] padded events + [...] counts -> [..., H, W, num_bins] on
    the events' device.

    The leading dims are flattened into one batch of windows, which the
    voxelizer entry point (``ops.voxel.events_to_voxel_grid``) takes in
    one launch sequence, then each window is normalized over its own
    nonzero cells (the JAX package vmaps the same per-window steps).
    backend: the JAX package's names; 'auto' is K6 ('sortseg') for a CUDA
    tensor and the plain scatter for a CPU tensor.  The JAX package picks
    its one-hot kernel K7 ('pallas') on the TPU; on the card K6 and K7
    are one kernel (csrc/voxel.cu), K7 with optional bf16 factors.  With
    K6 the nonzero stats come from the kernel's epilogue (with_stats), in
    place of a second pass over the grids."""
    events = torch.as_tensor(events)
    lead = events.shape[:-2]
    flat_ev = events.reshape((-1,) + tuple(events.shape[-2:]))
    flat_n = torch.as_tensor(counts).reshape(-1)
    if backend == "auto":
        backend = "sortseg" if flat_ev.is_cuda else "scatter"
    kw = dict(num_bins=num_bins, height=height, width=width)
    stats = None
    if backend == "sortseg":
        grids, stats = V.events_to_voxel_grid_sortseg(flat_ev, flat_n,
                                                      with_stats=True, **kw)
    else:
        grids = V.events_to_voxel_grid(flat_ev, flat_n, backend=backend, **kw)
    if normalize:
        if stats is None:
            stats = V.voxel_stats(grids)
        grids = V.normalize_voxel_grid(
            grids, tuple(s[:, None, None, None] for s in stats))
    grids = grids.permute(0, 2, 3, 1)                     # CHW -> HWC
    return grids.reshape(tuple(lead) + tuple(grids.shape[1:]))


class RawEventSequenceDataset:
    """Sequence windows over RAW events: like
    SequenceSynchronizedFramesEventsDataset but the 'events' entry is the
    PADDED raw event array (voxelization deferred to the device).

    Output per index: {'events_raw': [L, K, N_max, 4],
                       'events_count': [L, K],
                       'image': [L, H, W, 1],
                       'depth_events': [L, K, H, W, 1],
                       'depth_image': [L, H, W, 1]}

    transform reaches the frames and depth maps only, as in the JAX
    package, which passes it to the synchronized dataset alone; raw
    events cannot be cropped, so a transform that changes the size of a
    map is refused (ROADMAP queue 3).  n_max None pads each item to the
    bucket of its longest window (JAX's default): items of one batch then
    stack only if they fall in one bucket, so batched loading passes
    n_max."""

    def __init__(self, base_folder: str, event_folder: str,
                 depth_folder: str = "depth/data", frame_folder: str = "rgb/data",
                 sequence_length: int = 2, step_size: int = 1,
                 clip_distance: float = 100.0, every_x_rgb_frame: int = 1,
                 reg_factor: float = 5.7, transform=None, n_max: Optional[int] = None):
        from .datasets import RawEventsDataset, SynchronizedFramesEventsDataset
        # the synchronized dataset for depth and frames; its voxels unused
        self.sync = SynchronizedFramesEventsDataset(
            base_folder, event_folder, depth_folder, frame_folder,
            clip_distance=clip_distance, every_x_rgb_frame=every_x_rgb_frame,
            reg_factor=reg_factor, transform=transform, baseline="rgb")
        if transform is not None:
            h, w = self.sync._load_depth(0).shape[:2]
            shape = transform(np.zeros((h, w, 1), np.float32),
                              np.random.RandomState(0), False).shape[:2]
            if shape != (h, w):
                raise ValueError(
                    f"the transform maps {h}x{w} frames to {shape[0]}x"
                    f"{shape[1]}, and raw event windows cannot be cropped: "
                    "their grids would not match the frames (ROADMAP queue 3)")
        self.raw = RawEventsDataset(base_folder, event_folder.replace("voxels", "data"))
        self.L = sequence_length
        self.step_size = step_size
        self.K = every_x_rgb_frame
        self.n_max = n_max
        if self.L * self.K >= len(self.raw):
            self.length = 0
        else:
            self.length = (len(self.raw) - self.L * self.K) // step_size // self.K + 1

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        assert 0 <= i < self.length
        j0 = i * self.step_size
        images, d_events, d_images = [], [], []
        windows: List[np.ndarray] = []
        for l in range(self.L):
            pkg = self.sync.__getitem__(j0 + l, seed)
            images.append(pkg["image"])
            d_images.append(pkg["depth_image"])
            for k in range(self.K):
                windows.append(self.raw[(j0 + l) * self.K + k].astype(np.float32))
            # per-step ground truth at the package's rate
            d_events.append(np.stack([pkg["depth_image"]] * self.K))
        padded, counts = pad_event_windows(windows, self.n_max)
        n_max = padded.shape[1]
        return {
            "events_raw": padded.reshape(self.L, self.K, n_max, 4),
            "events_count": counts.reshape(self.L, self.K),
            "image": np.stack(images),
            "depth_events": np.stack(d_events),
            "depth_image": np.stack(d_images),
        }


def device_voxelize_prefetch(iterator, *, num_bins: int, height: int,
                             width: int, backend: str = "auto",
                             normalize: bool = True, sharding=None,
                             size: int = 2, device=None
                             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetch wrapper: copy raw-event batches (dicts of numpy arrays) to
    the device, voxelize them there (``voxelize_batch``: 'events_raw' and
    'events_count' in, 'events' [B, L, K, H, W, num_bins] out) and hand
    the model a standard batch dict, the next ``size`` batches staged
    while the consumer computes on the current one.

    device: None for the current CUDA device, or torch.device('cpu').
    ``loader.device_prefetch`` stages the batches: on a CUDA device the
    copy and the voxelization run on its side stream, so that the voxel
    kernel runs beside the consumer's work.  sharding (the JAX package's
    device layout) belongs to parallelism and is not taken (ROADMAP queue
    1, item 15)."""
    if sharding is not None:
        raise NotImplementedError("sharding: parallelism is not ported yet "
                                  "(ROADMAP queue 1, item 15)")
    if device is None:
        from ..utils import require_cuda
        device = require_cuda()

    def voxelized(dev):
        dev["events"] = voxelize_batch(
            dev.pop("events_raw"), dev.pop("events_count"), num_bins=num_bins,
            height=height, width=width, backend=backend, normalize=normalize)
        return dev

    return device_prefetch(iterator, torch.device(device), size, stage=voxelized)
