"""Host-side dataset layer: on-disk sequence folders -> fixed-shape numpy
datapackages and TBPTT windows of them.

Counterpart of ``rpg_ramnet_tpu/data/datasets.py`` for precomputed voxel
grids (``.npy``) and non-baseline packaging: ``VoxelGridDataset``,
``SynchronizedFramesEventsDataset`` and
``SequenceSynchronizedFramesEventsDataset`` (reference
RAM_Net/data_loader/event_dataset.py:113-160, dataset.py:23-141,144-416).
A datapackage is a dict of stacked NHWC arrays: 'events' [K, H, W, C],
'image' [H, W, 1], 'depth_events' [K, H, W, 1], 'depth_image' [H, W, 1];
a window stacks L of them.  File indices are resolved once at init, and
randomness is explicit (seed-keyed numpy RandomStates).

On-disk format (EventScape, as the reference): <seq>/events/voxels/
*_%04d_voxel.npy, <seq>/depth/data/*_%04d_depth.npy, <seq>/rgb/data/
*_%04d_image.png, each folder with its timestamps.txt; MVSEC names
(event_tensor_%010d.npy, depth_%010d.npy, frame_%010d.png) where the base
folder's name says "mvsec"; with load_semantic, the semantic labels
<seq>/semantic/data/*_%04d_gt_labelIds.png ('semantic_events' [K, H, W, 1],
'semantic_image' [H, W, 1]) that test.py writes out.  Raw-event inputs,
baselines and scale_factor < 1 are not ported (ROADMAP queue 1, items 6
and 13).  With use_phased_arch (the irregular-timestamp regime) an item
also carries its steps' timestamps: 'times_events' [K] and 'times_image'
(a scalar), float32 seconds from the sequence's first event stamp.
"""
from __future__ import annotations

import os
import re
from os.path import join
from typing import Dict, List, Optional

import numpy as np

from ..ops.depth import depth_to_log_np, rgb_to_gray_np
from ..ops.voxel import normalize_voxel_grid_np
from .timestamps import TimestampIndex, first_element_greater_than, is_mvsec_folder

_PATTERNS = {
    "voxel": (re.compile(r"_(\d{4})_voxel\.npy$"),
              re.compile(r"^event_tensor_(\d{10})\.npy$")),
    "depth": (re.compile(r"_(\d{4})_depth\.npy$"),
              re.compile(r"^depth_(\d{10})\.npy$")),
    "image": (re.compile(r"_(\d{4})_image\.png$"),
              re.compile(r"^frame_(\d{10})\.png$")),
    "semantic": (re.compile(r"_(\d{4})_gt_labelIds\.png$"),) * 2,
}


def index_files(folder: str, kind: str, mvsec: bool) -> Dict[int, str]:
    """One directory scan -> {frame index: path}."""
    pat = _PATTERNS[kind][1 if mvsec else 0]
    out: Dict[int, str] = {}
    if not os.path.isdir(folder):
        return out
    for name in os.listdir(folder):
        m = pat.search(name)
        if m:
            out[int(m.group(1))] = join(folder, name)
    return out


def _read_image(path: str) -> np.ndarray:
    """float32 [H, W, 3] (or [H, W] for grayscale pngs)."""
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.float32)


def _apply_transform(x: np.ndarray, transform, seed: Optional[int]) -> np.ndarray:
    """A fresh RandomState per tensor from the shared seed: every tensor of
    a sequence sees the same crop and flip draws (dataset.py:313-315)."""
    if transform is None:
        return x
    rng = np.random.RandomState(
        seed if seed is not None else np.random.randint(2 ** 31))
    return transform(x, rng, False)


class VoxelGridDataset:
    """Precomputed voxel grids (event_dataset.py:113-160): [H, W, num_bins]
    float32, optionally nonzero mean/std normalized."""

    def __init__(self, base_folder: str, event_folder: str,
                 start_time: float = 0.0, stop_time: float = 0.0,
                 transform=None, normalize: bool = True):
        self.event_folder = join(base_folder, event_folder)
        self.transform = transform
        self.normalize = normalize
        mvsec = is_mvsec_folder(base_folder)
        self.index = TimestampIndex.load(self.event_folder, start_time,
                                         stop_time, mvsec_drop_last=mvsec)
        self.files = index_files(self.event_folder, "voxel", mvsec)

    def __len__(self) -> int:
        return self.index.length

    def get_stamp_at(self, i: int) -> float:
        return self.index.stamp_at(i)

    @property
    def initial_stamp(self) -> float:
        return self.index.initial_stamp

    def __getitem__(self, i: int, seed: Optional[int] = None) -> np.ndarray:
        assert 0 <= i < len(self)
        grid = np.load(self.files[self.index.index_at(i)]).astype(np.float32)
        if self.normalize:
            grid = normalize_voxel_grid_np(grid)
        return _apply_transform(np.moveaxis(grid, 0, -1), self.transform, seed)


class SynchronizedFramesEventsDataset:
    """One datapackage per index: K event voxel steps and one frame, each
    with its log-depth ground truth (dataset.py:144-416, baseline=False)."""

    def __init__(self, base_folder: str, event_folder: str,
                 depth_folder: str = "frames", frame_folder: str = "rgb",
                 start_time: float = 0.0, stop_time: float = 0.0,
                 clip_distance: float = 100.0, every_x_rgb_frame: int = 1,
                 transform=None, normalize: bool = True,
                 reg_factor: float = 5.7, semantic_folder: str = "semantic",
                 load_semantic: bool = False, use_phased_arch: bool = False):
        self.depth_folder = join(base_folder, depth_folder or "frames")
        self.use_phased_arch = use_phased_arch
        self.frame_folder = join(base_folder, frame_folder or "rgb")
        self.load_semantic = load_semantic
        self.transform = transform
        self.clip_distance = clip_distance
        self.every_x_rgb_frame = every_x_rgb_frame
        self.reg_factor = reg_factor
        mvsec = is_mvsec_folder(base_folder)
        self.event_dataset = VoxelGridDataset(base_folder, event_folder,
                                              start_time, stop_time,
                                              transform, normalize)
        stamps = np.loadtxt(join(self.depth_folder, "timestamps.txt"))[:, 1]
        if mvsec:
            stamps = stamps[1:]  # dataset.py:208-209
        self.depth_stamps = stamps - self.event_dataset.initial_stamp
        if not np.all(np.diff(self.depth_stamps) > 0):
            raise ValueError("frame timestamps are not unique and "
                             "monotonically increasing")
        self.depth_files = index_files(self.depth_folder, "depth", mvsec)
        self.frame_files = index_files(self.frame_folder, "image", mvsec)
        self.semantic_files = index_files(
            join(base_folder, semantic_folder or "semantic"), "semantic", mvsec)
        # raw event steps, not packages, as the reference's .length
        self.length = len(self.event_dataset)

    def __len__(self) -> int:
        return self.length

    def num_packages(self) -> int:
        return self.length // self.every_x_rgb_frame

    def _frame_idx_for_stamp(self, stamp: float) -> int:
        idx, f_stamp = first_element_greater_than(self.depth_stamps, stamp)
        assert 0 <= idx < len(self.depth_stamps)
        assert f_stamp - stamp < 1e-5, (f_stamp, stamp)
        return idx

    def _load_depth(self, frame_idx: int) -> np.ndarray:
        d = np.load(self.depth_files[frame_idx]).astype(np.float32)
        d = depth_to_log_np(d, self.clip_distance, self.reg_factor)
        return d[..., None] if d.ndim == 2 else d

    def _load_semantic(self, frame_idx: int, seed: int) -> Optional[np.ndarray]:
        """[H, W, 1] label ids of a frame (its first channel), transformed;
        None without a label file."""
        path = self.semantic_files.get(frame_idx)
        if path is None:
            return None
        img = _read_image(path)
        img = img[..., 0] if img.ndim == 3 else img
        return _apply_transform(img[..., None], self.transform, seed)

    def __getitem__(self, i: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        assert 0 <= i < self.num_packages()
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31))
        K = self.every_x_rgb_frame
        events, depths, semantics, stamps = [], [], [], []
        item: Dict[str, np.ndarray] = {}
        for k in range(K):
            j = i * K + k
            stamps.append(self.event_dataset.get_stamp_at(j))
            frame_idx = self._frame_idx_for_stamp(stamps[-1])
            events.append(self.event_dataset.__getitem__(j, seed))
            depths.append(_apply_transform(self._load_depth(frame_idx),
                                           self.transform, seed))
            sem = (self._load_semantic(frame_idx, seed) if self.load_semantic
                   else None)
            if sem is not None:
                semantics.append(sem)
            if k == K - 1:
                path = self.frame_files.get(frame_idx)
                if path is not None:
                    rgb = _read_image(path)
                    gray = rgb_to_gray_np(rgb) if rgb.ndim == 3 else rgb
                    item["image"] = _apply_transform(
                        (gray / 255.0)[..., None], self.transform, seed)
                item["depth_image"] = depths[-1]
                if sem is not None:
                    item["semantic_image"] = sem
        item["events"] = np.stack(events)            # [K, H, W, C]
        item["depth_events"] = np.stack(depths)
        if semantics:
            item["semantic_events"] = np.stack(semantics)
        if self.use_phased_arch:        # datasets.py:338-349 of the JAX package
            item["times_events"] = np.asarray(stamps, np.float32)
            item["times_image"] = np.float32(stamps[-1])
        return item


class SequenceSynchronizedFramesEventsDataset:
    """Length-L windows of datapackages with a shared augmentation seed and
    optional pause augmentation (dataset.py:23-141): 'events'
    [L, K, H, W, C], 'image' [L, H, W, 1], 'depth_events' [L, K, H, W, 1],
    'depth_image' [L, H, W, 1]."""

    def __init__(self, base_folder: str, event_folder: str,
                 depth_folder: str = "frames", frame_folder: str = "rgb",
                 start_time: float = 0.0, stop_time: float = 0.0,
                 sequence_length: int = 2, transform=None,
                 proba_pause_when_running: float = 0.0,
                 proba_pause_when_paused: float = 0.0,
                 step_size: int = 20, clip_distance: float = 100.0,
                 normalize: bool = True, scale_factor: float = 1.0,
                 every_x_rgb_frame: int = 1, reg_factor: float = 5.7,
                 semantic_folder: str = "semantic/data",
                 load_semantic: bool = False, use_phased_arch: bool = False):
        assert sequence_length > 0 and step_size > 0 and clip_distance > 0
        if scale_factor < 1.0:
            raise NotImplementedError(
                "scale_factor < 1 (cv2 resizing) is not ported yet: ROADMAP "
                "queue 1, item 6")
        self.L = sequence_length
        self.dataset = SynchronizedFramesEventsDataset(
            base_folder, event_folder, depth_folder, frame_folder,
            start_time, stop_time, clip_distance, every_x_rgb_frame,
            transform, normalize=normalize, reg_factor=reg_factor,
            semantic_folder=semantic_folder, load_semantic=load_semantic,
            use_phased_arch=use_phased_arch)
        self.step_size = step_size
        self.proba_pause_when_running = proba_pause_when_running
        self.proba_pause_when_paused = proba_pause_when_paused
        # window count arithmetic of dataset.py:60-64
        if self.L * every_x_rgb_frame >= self.dataset.length:
            self.length = 0
        else:
            self.length = ((self.dataset.length - self.L * every_x_rgb_frame)
                           // step_size // every_x_rgb_frame + 1)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        assert 0 <= i < self.length
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31))
        rng = np.random.RandomState(seed ^ 0x5EED)
        j = i * self.step_size
        k = 0
        packages: List[Dict[str, np.ndarray]] = [
            self.dataset.__getitem__(j, seed)]
        paused = False
        for _ in range(self.L - 1):
            proba = (self.proba_pause_when_paused if paused
                     else self.proba_pause_when_running)
            paused = bool(rng.rand() < proba)
            if paused:
                item = dict(self.dataset.__getitem__(j + k, seed))
                item["events"] = np.zeros_like(item["events"])
                packages.append(item)
            else:
                k += 1
                packages.append(self.dataset.__getitem__(j + k, seed))
        return {key: np.stack([p[key] for p in packages])
                for key in packages[0]}


DATASETS = {"SequenceSynchronizedFramesEventsDataset":
            SequenceSynchronizedFramesEventsDataset}
