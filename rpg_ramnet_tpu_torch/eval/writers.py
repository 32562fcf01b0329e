"""Artifact writers for inference outputs.

Counterpart of ``rpg_ramnet_tpu/eval/writers.py`` (reference
RAM_Net/utils/inference_utils.py: make_event_preview:20,
IntensityRescaler:58, the writers :101-149) and the output tree of
RAM_Net/test.py:66-90,259-363, which ``evaluation.py`` reads.  PIL, cv2 and matplotlib are imported where they
are used; without matplotlib the tree has no color maps.
"""
from __future__ import annotations

import os
import warnings
from os.path import join

import numpy as np


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def _imwrite(path: str, img: np.ndarray) -> None:
    """uint8 image write (cv2 if present, else PIL with the same bytes)."""
    arr = np.clip(img, 0, 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        from PIL import Image
        if arr.ndim == 3 and arr.shape[2] == 3:
            arr = arr[..., ::-1]  # cv2 writes BGR; keep bytes identical
        Image.fromarray(arr).save(path)
        return
    if not cv2.imwrite(path, arr):
        raise OSError(f"could not write {path}")


def _inverted(img: np.ndarray) -> np.ndarray:
    inv = np.ones_like(img[0]) * np.amax(img[0]) - img[0]
    inv = np.nan_to_num(inv, nan=1)
    return np.nan_to_num(inv / np.amax(inv))


def make_colormap(img: np.ndarray, color_mapper) -> np.ndarray:
    """Inverted-magma color map image (test.py:36-43).  img: [1, H, W]."""
    rgba = color_mapper.to_rgba(_inverted(img))
    rgba[:, :, 0:3] = rgba[:, :, 0:3][..., ::-1]
    return rgba


def build_color_mapper(sample_depth: np.ndarray):
    """Shared magma mapper from one ground-truth frame (test.py:195-205)."""
    import matplotlib as mpl
    import matplotlib.cm as cm
    inv = _inverted(sample_depth)
    normalizer = mpl.colors.Normalize(vmin=inv.min(),
                                      vmax=np.percentile(inv, 95))
    return cm.ScalarMappable(norm=normalizer, cmap="magma")


def make_event_preview(events: np.ndarray, mode: str = "red-blue",
                       num_bins_to_show: int = -1) -> np.ndarray:
    """Event tensor [H, W, C] -> preview image (inference_utils.py:20-55)."""
    s = (events.sum(axis=-1) if num_bins_to_show < 0
         else events[..., :num_bins_to_show].sum(axis=-1))
    if mode == "red-blue":
        img = np.zeros(s.shape + (3,), np.uint8)
        img[s > 0, 2] = 255   # red channel (BGR layout like cv2)
        img[s < 0, 0] = 255   # blue
        return img
    m = np.median(s[s != 0]) if np.any(s != 0) else 0.0
    return np.clip(((s - m + 0.5) * 255), 0, 255).astype(np.uint8)


class IntensityRescaler:
    """Robust percentile auto-rescale with an EMA of the bounds, the
    --auto_hdr rescaler (inference_utils.py:58-98)."""

    def __init__(self, auto_hdr: bool = True, imin: float = 0.0,
                 imax: float = 1.0, median_filter_size: int = 10,
                 percentile: float = 1.0):
        self.auto_hdr = auto_hdr
        self.imin, self.imax = imin, imax
        self.alpha = 2.0 / (median_filter_size + 1)
        self.pmin = percentile
        self.pmax = 100.0 - percentile
        self._min_ema = None
        self._max_ema = None

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.auto_hdr:
            lo = np.percentile(img, self.pmin)
            hi = np.percentile(img, self.pmax)
            self._min_ema = lo if self._min_ema is None else \
                self.alpha * lo + (1 - self.alpha) * self._min_ema
            self._max_ema = hi if self._max_ema is None else \
                self.alpha * hi + (1 - self.alpha) * self._max_ema
            imin, imax = self._min_ema, self._max_ema
        else:
            imin, imax = self.imin, self.imax
        out = (img - imin) / max(imax - imin, 1e-9)
        return np.clip(out, 0.0, 1.0)


class DepthOutputWriter:
    """Writes the test.py output tree: depth/<key>/frame_*.png,
    npy/<key>/depth_*.npy, color_map/<key>/..., ground_truth/{grey,
    color_map,npy}/<key>/..., semantic_seg/, video frames."""

    def __init__(self, output_folder: str):
        self.root = output_folder
        self.dirs = {
            "depth": join(output_folder, "depth"),
            "npy": join(output_folder, "npy"),
            "color_map": join(output_folder, "color_map"),
            "gt_grey": join(output_folder, "ground_truth/grey"),
            "gt_color_map": join(output_folder, "ground_truth/color_map"),
            "gt_npy": join(output_folder, "ground_truth/npy"),
            "sem_npy": join(output_folder, "semantic_seg/npy"),
            "sem_frames": join(output_folder, "semantic_seg/frames"),
            "video_pred": join(output_folder, "video/predictions"),
            "video_gt": join(output_folder, "video/gt"),
            "video_inputs": join(output_folder, "video/inputs"),
        }
        for d in self.dirs.values():
            ensure_dir(d)
        self.color_mapper = None
        self.video_idx = 0

    def set_color_mapper(self, sample_depth_chw: np.ndarray) -> None:
        """The shared color mapper, from one ground-truth frame.  Without
        matplotlib there is none: no color map or color video frame is
        written, and the grey frames, the arrays and the input video frames
        are, so the tree still serves evaluation."""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            warnings.warn("matplotlib is absent: the output tree gets no "
                          "color maps")
            return
        self.color_mapper = build_color_mapper(sample_depth_chw)

    def _write_frame(self, kind: str, key: str, idx: int,
                     img_chw: np.ndarray) -> None:
        """The grey png and, with a color mapper, the color map png."""
        d = join(self.dirs[kind], key)
        ensure_dir(d)
        _imwrite(join(d, f"frame_{idx:010d}.png"), img_chw[0][:, :, None] * 255.0)
        if self.color_mapper is not None:
            kind_cm = "color_map" if kind == "depth" else "gt_color_map"
            d = join(self.dirs[kind_cm], key)
            ensure_dir(d)
            _imwrite(join(d, f"frame_{idx:010d}.png"),
                     make_colormap(img_chw, self.color_mapper) * 255.0)

    def write_prediction(self, idx: int, key: str, img_chw: np.ndarray) -> None:
        """img_chw: [1, H, W] prediction in log-depth space (test.py:269-286)."""
        self._write_frame("depth", key, idx, img_chw)
        d = join(self.dirs["npy"], key)
        ensure_dir(d)
        np.save(join(d, f"depth_{idx:010d}.npy"), img_chw)

    def write_ground_truth(self, idx: int, key: str, img_chw: np.ndarray) -> None:
        self._write_frame("gt_grey", key, idx, img_chw)
        d = join(self.dirs["gt_npy"], key)
        ensure_dir(d)
        np.save(join(d, f"frame_{idx:010d}.npy"), img_chw)

    def write_semantic(self, idx: int, key: str, img_chw: np.ndarray) -> None:
        d = join(self.dirs["sem_npy"], key)
        ensure_dir(d)
        np.save(join(d, f"frame_{idx:010d}.npy"), img_chw[0])
        d = join(self.dirs["sem_frames"], key)
        ensure_dir(d)
        _imwrite(join(d, f"frame_{idx:010d}.png"), img_chw[0])

    def write_video_frame(self, pred_chw: np.ndarray, gt_chw: np.ndarray,
                          input_hwc: np.ndarray, is_event_key: bool) -> None:
        """Consecutive-input video frames (test.py:317-360)."""
        name = f"frame_{self.video_idx:010d}.png"
        if self.color_mapper is not None:
            _imwrite(join(self.dirs["video_pred"], name),
                     make_colormap(pred_chw, self.color_mapper) * 255.0)
            _imwrite(join(self.dirs["video_gt"], name),
                     make_colormap(gt_chw, self.color_mapper) * 255.0)
        data = input_hwc.sum(axis=-1)
        if is_event_key:
            neg = np.where(data <= -0.5, 1.0, 0.0)
            pos = np.where(data > 0.9, 1.0, 0.0)
            img = np.stack([neg, np.zeros_like(data), pos], axis=-1)
        else:
            img = data[:, :, None]
        _imwrite(join(self.dirs["video_inputs"], name), img * 255.0)
        self.video_idx += 1
