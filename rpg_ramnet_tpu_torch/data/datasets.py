"""Host-side dataset layer: on-disk sequence folders -> fixed-shape numpy
datapackages and TBPTT windows of them.

Counterpart of ``rpg_ramnet_tpu/data/datasets.py``: ``VoxelGridDataset``
(precomputed voxel grids, ``.npy``), ``RawEventsDataset`` (raw event
windows), ``FrameDataset`` (grayscale frames),
``SynchronizedFramesEventsDataset`` with the baselines'
packing, ``SynchronizedFramesEventsRawDataset`` (the non-recurrent
baseline's input) and ``SequenceSynchronizedFramesEventsDataset``
(reference RAM_Net/data_loader/event_dataset.py:113-189,
dataset.py:23-141,144-416, dataset_asynchronous.py:21-308).
A datapackage is a dict of stacked NHWC arrays: 'events' [K, H, W, C],
'image' [H, W, C], 'depth_events' [K, H, W, 1], 'depth_image' [H, W, 1];
a window stacks L of them.  For a baseline, 'events' holds the K' event
steps the model runs (``models.event_loop_range``; [0, H, W, 0] when
none) and 'image' its image input: the frame ('rgb'), the last voxel
grid ('e'), or the grid and the frame concatenated ('ergb', 'ergb0';
an 'ergb0' event step is its grid and the previous frame).  File
indices are resolved once at init, and randomness is explicit
(seed-keyed numpy RandomStates).

On-disk format (EventScape, as the reference): <seq>/events/voxels/
*_%04d_voxel.npy, <seq>/depth/data/*_%04d_depth.npy, <seq>/rgb/data/
*_%04d_image.png, each folder with its timestamps.txt; MVSEC names
(event_tensor_%010d.npy, depth_%010d.npy, frame_%010d.png) where the base
folder's name says "mvsec"; with load_semantic, the semantic labels
<seq>/semantic/data/*_%04d_gt_labelIds.png ('semantic_events' [K, H, W, 1],
'semantic_image' [H, W, 1]) that test.py writes out; raw events
<seq>/<event_folder>/*_%04d_events.npy ([N, 4] rows t, x, y, polarity).
scale_factor < 1 down-scales every window's maps as cv2.resize does in
the JAX package (``resize_hw``; numpy, so that no cv2 is needed).  With
use_phased_arch (the irregular-timestamp regime) an item also carries its
steps' timestamps: 'times_events' [K] and 'times_image' (a scalar),
float32 seconds from the sequence's first event stamp.
"""
from __future__ import annotations

import os
import re
from os.path import join
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.registry import DATASETS
from ..ops.depth import depth_to_log_np, rgb_to_gray_np
from ..ops.voxel import events_to_voxel_grid_np, normalize_voxel_grid_np
from .timestamps import TimestampIndex, first_element_greater_than, is_mvsec_folder

_PATTERNS = {
    "voxel": (re.compile(r"_(\d{4})_voxel\.npy$"),
              re.compile(r"^event_tensor_(\d{10})\.npy$")),
    "depth": (re.compile(r"_(\d{4})_depth\.npy$"),
              re.compile(r"^depth_(\d{10})\.npy$")),
    "image": (re.compile(r"_(\d{4})_image\.png$"),
              re.compile(r"^frame_(\d{10})\.png$")),
    "events": (re.compile(r"_(\d{4})_events\.npy$"),) * 2,
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


def _linear_taps(n_in: int, n_out: int, wide: bool):
    """cv2's INTER_LINEAR taps along one axis: pixel centres at (d + 0.5)
    * n_in / n_out - 0.5, the two neighbours and their float32 weights,
    clamped to the border.  cv2 (5.0) forms the weights in float64 for
    1, 3 or 4 channels (wide) and from the centre rounded to float32
    otherwise."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    if not wide:
        f = f.astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w1 = np.where((i0 < 0) | (i0 >= n_in - 1), 0.0, f - i0.astype(f.dtype))
    i0 = np.clip(i0, 0, n_in - 1)
    return (i0, np.minimum(i0 + 1, n_in - 1), (1.0 - w1).astype(np.float32),
            w1.astype(np.float32))


def resize_hw(v: np.ndarray, height: int, width: int,
              nearest: bool = False) -> np.ndarray:
    """v [..., H, W, C] -> [..., height, width, C] as ``cv2.resize(img,
    (width, height), interpolation)`` of each [H, W, C] image: bilinear
    with half-pixel centres and clamped borders, the rows of the width
    pass combined second (INTER_LINEAR), or the source pixel
    floor(d * n_in / n_out) (INTER_NEAREST)."""
    h, w = v.shape[-3], v.shape[-2]
    if nearest:
        rows = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))), h - 1)
        cols = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))), w - 1)
        return v[..., rows.astype(np.int64)[:, None], cols.astype(np.int64), :]
    wide = v.shape[-1] in (1, 3, 4)
    c0, c1, a0, a1 = _linear_taps(w, width, wide)
    x = v[..., c0, :] * a0[:, None] + v[..., c1, :] * a1[:, None]
    r0, r1, b0, b1 = _linear_taps(h, height, wide)
    return (x[..., r0, :, :] * b0[:, None, None]
            + x[..., r1, :, :] * b1[:, None, None])


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


class RawEventsDataset:
    """Raw [t, x, y, pol] event windows, one file per stamp
    (event_dataset.py:162-189)."""

    def __init__(self, base_folder: str, event_folder: str,
                 start_time: float = 0.0, stop_time: float = 0.0):
        self.event_folder = join(base_folder, event_folder)
        mvsec = is_mvsec_folder(base_folder)
        self.index = TimestampIndex.load(self.event_folder, start_time,
                                         stop_time, mvsec_drop_last=mvsec)
        self.files = index_files(self.event_folder, "events", mvsec)

    def __len__(self) -> int:
        return self.index.length

    def get_stamp_at(self, i: int) -> float:
        return self.index.stamp_at(i)

    @property
    def initial_stamp(self) -> float:
        return self.index.initial_stamp

    def __getitem__(self, i: int) -> np.ndarray:
        assert 0 <= i < len(self)
        return np.load(self.files[self.index.index_at(i)])


class FrameDataset:
    """Grayscale-converted RGB frames (event_dataset.py:192-238): [H, W, 1]
    float32, in [0, 1] when normalize."""

    def __init__(self, base_folder: str, frame_folder: str,
                 start_time: float = 0.0, stop_time: float = 0.0,
                 transform=None, normalize: bool = True):
        self.base_folder = base_folder
        self.frame_folder = join(base_folder, frame_folder)
        self.transform = transform
        self.normalize = normalize
        self.use_mvsec = is_mvsec_folder(base_folder)
        self.index = TimestampIndex.load(self.frame_folder, start_time,
                                         stop_time,
                                         mvsec_drop_last=self.use_mvsec)
        self.files = index_files(self.frame_folder, "image", self.use_mvsec)

    def __len__(self) -> int:
        return self.index.length

    def __getitem__(self, i: int, seed: Optional[int] = None) -> np.ndarray:
        assert 0 <= i < len(self)
        rgb = _read_image(self.files[self.index.index_at(i)])
        gray = rgb_to_gray_np(rgb) if rgb.ndim == 3 else rgb
        if self.normalize:
            gray = gray / 255.0
        return _apply_transform(gray[..., None], self.transform, seed)


class SynchronizedFramesEventsDataset:
    """One datapackage per index: K event voxel steps and one frame, each
    with its log-depth ground truth (dataset.py:144-416), packed as the
    baseline asks (JAX datasets.py:285-340)."""

    def __init__(self, base_folder: str, event_folder: str,
                 depth_folder: str = "frames", frame_folder: str = "rgb",
                 start_time: float = 0.0, stop_time: float = 0.0,
                 clip_distance: float = 100.0, every_x_rgb_frame: int = 1,
                 transform=None, normalize: bool = True,
                 reg_factor: float = 5.7, semantic_folder: str = "semantic",
                 load_semantic: bool = False, use_phased_arch: bool = False,
                 baseline: Union[bool, str] = False, loss_composition=False):
        self.depth_folder = join(base_folder, depth_folder or "frames")
        self.use_phased_arch = use_phased_arch
        self.baseline = baseline
        self.loss_composition = loss_composition
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

    def _load_gray(self, frame_idx: int, seed: int) -> Optional[np.ndarray]:
        """[H, W, 1] gray frame in [0, 1], transformed; None without a
        frame file."""
        path = self.frame_files.get(frame_idx)
        if path is None:
            return None
        rgb = _read_image(path)
        gray = rgb_to_gray_np(rgb) if rgb.ndim == 3 else rgb
        return _apply_transform((gray / 255.0)[..., None], self.transform,
                                seed)

    def __getitem__(self, i: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        assert 0 <= i < self.num_packages()
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31))
        K = self.every_x_rgb_frame
        baseline = self.baseline
        events, depths, semantics, stamps = [], [], [], []
        item: Dict[str, np.ndarray] = {}
        prev_gray = None
        for k in range(K):
            j = i * K + k
            stamp = self.event_dataset.get_stamp_at(j)
            frame_idx = self._frame_idx_for_stamp(stamp)
            depth = _apply_transform(self._load_depth(frame_idx),
                                     self.transform, seed)
            # the event slots the model runs as event steps
            event_slot = not baseline or (
                baseline == "e" and self.loss_composition == "image"
                and k < K - 1)
            ergb0_slot = baseline == "ergb0" and k < K - 1
            last = k == K - 1
            voxel = sem = None
            if event_slot or ergb0_slot or (last and baseline in
                                            ("e", "ergb", "ergb0")):
                voxel = self.event_dataset.__getitem__(j, seed)
            if event_slot:
                events.append(voxel)
                depths.append(depth)
                stamps.append(stamp)
                sem = (self._load_semantic(frame_idx, seed)
                       if self.load_semantic else None)
                if sem is not None:
                    semantics.append(sem)
            if ergb0_slot:
                # the voxel grid and the frame before the package's, zeros
                # while there is none (dataset.py:342-375)
                if k == 0:
                    prev_gray = (np.zeros_like(depth) if frame_idx < K
                                 else self._load_gray(frame_idx - 1, seed))
                events.append(np.concatenate([voxel, prev_gray], axis=-1))
                depths.append(depth)
                stamps.append(stamp)
            if last:
                gray = self._load_gray(frame_idx, seed)
                if not baseline or baseline == "rgb":
                    image = gray
                elif baseline == "e":
                    image = voxel
                else:
                    image = np.concatenate([voxel, gray], axis=-1)
                if image is not None:
                    item["image"] = image
                item["depth_image"] = depth
                if self.use_phased_arch:
                    item["times_image"] = np.float32(stamp)
                if self.load_semantic and sem is None:
                    sem = self._load_semantic(frame_idx, seed)
                if sem is not None:
                    item["semantic_image"] = sem
        # the keys in the JAX package's order (datasets.py:285-356)
        if events:
            item["events"] = np.stack(events)            # [K', H, W, C]
            item["depth_events"] = np.stack(depths)
            if self.use_phased_arch:
                item["times_events"] = np.asarray(stamps, np.float32)
            if semantics:
                item["semantic_events"] = np.stack(semantics)
        else:
            h, w, _ = item["depth_image"].shape
            item["events"] = np.zeros((0, h, w, 0), np.float32)
            item["depth_events"] = np.zeros((0, h, w, 1), np.float32)
        return item


class SynchronizedFramesEventsRawDataset:
    """The non-recurrent baseline's packages (dataset_asynchronous.py:
    21-308, JAX datasets.py:359-456): the raw events of a package's K
    windows voxelized in ONE grid at the sensor's resolution (the first
    depth map's), on the host with ``ops.voxel.events_to_voxel_grid_np``
    (normalized as the voxel grids are), then transformed, and the frame
    concatenated: 'image' [H, W, num_bins + 1]; 'events' [0, H, W, 0]."""

    def __init__(self, base_folder: str, event_folder: str,
                 depth_folder: str = "frames", frame_folder: str = "rgb",
                 start_time: float = 0.0, stop_time: float = 0.0,
                 clip_distance: float = 100.0, every_x_rgb_frame: int = 1,
                 transform=None, normalize: bool = True,
                 reg_factor: float = 5.7, use_phased_arch: bool = False,
                 num_bins: int = 5):
        self.depth_folder = join(base_folder, depth_folder or "frames")
        self.frame_folder = join(base_folder, frame_folder or "rgb")
        self.transform = transform
        self.normalize = normalize
        self.clip_distance = clip_distance
        self.every_x_rgb_frame = every_x_rgb_frame
        self.reg_factor = reg_factor
        self.use_phased_arch = use_phased_arch
        self.num_bins = num_bins
        mvsec = is_mvsec_folder(base_folder)
        self.event_dataset = RawEventsDataset(base_folder, event_folder,
                                              start_time, stop_time)
        stamps = np.loadtxt(join(self.depth_folder, "timestamps.txt"))[:, 1]
        if mvsec:
            stamps = stamps[1:]
        self.depth_stamps = stamps - self.event_dataset.initial_stamp
        self.depth_files = index_files(self.depth_folder, "depth", mvsec)
        self.frame_files = index_files(self.frame_folder, "image", mvsec)
        self.length = len(self.event_dataset)

    def __len__(self) -> int:
        return self.length

    def num_packages(self) -> int:
        return self.length // self.every_x_rgb_frame

    def _sensor_size(self) -> Tuple[int, int]:
        """(H, W) of the first depth map: the event files carry none."""
        d = np.load(next(iter(self.depth_files.values())))
        return d.shape[0], d.shape[1]

    def __getitem__(self, i: int, seed: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
        assert 0 <= i < self.num_packages()
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31))
        K = self.every_x_rgb_frame
        js = range(i * K, (i + 1) * K)
        events = np.concatenate([self.event_dataset[j] for j in js], axis=0)
        stamp = self.event_dataset.get_stamp_at(js[-1])
        frame_idx, f_stamp = first_element_greater_than(self.depth_stamps,
                                                        stamp)
        assert f_stamp is not None and f_stamp - stamp < 1e-5
        depth = np.load(self.depth_files[frame_idx]).astype(np.float32)
        depth = _apply_transform(
            depth_to_log_np(depth, self.clip_distance,
                            self.reg_factor)[..., None], self.transform, seed)
        gray = None
        path = self.frame_files.get(frame_idx)
        if path is not None:
            rgb = _read_image(path)
            g = rgb_to_gray_np(rgb) if rgb.ndim == 3 else rgb
            gray = _apply_transform((g / 255.0)[..., None], self.transform,
                                    seed)
        grid = events_to_voxel_grid_np(events.astype(np.float32),
                                       self.num_bins, *self._sensor_size())
        if self.normalize:
            grid = normalize_voxel_grid_np(grid)
        grid = _apply_transform(np.moveaxis(grid, 0, -1), self.transform, seed)
        h, w = depth.shape[:2]
        item = {"image": (grid if gray is None
                          else np.concatenate([grid, gray], axis=-1)),
                "depth_image": depth,
                "events": np.zeros((0, h, w, 0), np.float32),
                "depth_events": np.zeros((0, h, w, 1), np.float32)}
        if self.use_phased_arch:
            item["times_image"] = np.float32(stamp)
        return item


@DATASETS.register("SequenceSynchronizedFramesEventsDataset")
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
                 load_semantic: bool = False, use_phased_arch: bool = False,
                 baseline: Union[bool, str] = False, loss_composition=False,
                 recurrency: bool = True):
        assert sequence_length > 0 and step_size > 0 and clip_distance > 0
        self.L = sequence_length
        self.scale_factor = scale_factor
        # recurrency False: the non-recurrent baseline's raw-event packages
        # (datasets.py:480-500 of the JAX package; no semantic labels)
        if recurrency:
            self.dataset = SynchronizedFramesEventsDataset(
                base_folder, event_folder, depth_folder, frame_folder,
                start_time, stop_time, clip_distance, every_x_rgb_frame,
                transform, normalize=normalize, reg_factor=reg_factor,
                semantic_folder=semantic_folder, load_semantic=load_semantic,
                use_phased_arch=use_phased_arch, baseline=baseline,
                loss_composition=loss_composition)
        else:
            self.dataset = SynchronizedFramesEventsRawDataset(
                base_folder, event_folder, depth_folder, frame_folder,
                start_time, stop_time, clip_distance, every_x_rgb_frame,
                transform, normalize=normalize, reg_factor=reg_factor,
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
        out = {key: np.stack([p[key] for p in packages])
               for key in packages[0]}
        if self.scale_factor < 1.0:
            out = {k: self._downsample(k, v) for k, v in out.items()}
        return out

    def _downsample(self, key: str, v: np.ndarray) -> np.ndarray:
        """Every [H, W, C] map of v to (int(h * s), int(w * s)) (JAX
        datasets.py:550-568): nearest for the semantic labels, linear
        otherwise; timestamps and arrays of fewer than 3 dims unchanged."""
        if key.startswith("times") or v.ndim < 3:
            return v
        s = self.scale_factor
        return resize_hw(v, int(v.shape[-3] * s), int(v.shape[-2] * s),
                         nearest="semantic" in key)
