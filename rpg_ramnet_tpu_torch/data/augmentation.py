"""Seed-keyed data augmentation on numpy [H, W, C] arrays.

Counterpart of ``rpg_ramnet_tpu/data/augmentation.py`` (reference
RAM_Net/utils/data_augmentation.py: Compose:24, CenterCrop:52,
RandomCrop:92, RandomRotationFlip:140).  Every transform takes an explicit
numpy RandomState, so the same seed applied to every tensor of a sequence
gives the same crops and flips (the reference's shared-seed trick,
dataset.py:89) without global state.  RandomRotationFlip supports the
flow-aware inverse transform of the reference for [H, W, 2] flow fields.
"""
from __future__ import annotations

import numbers
from math import cos, pi, sin
from typing import Sequence, Tuple

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x, rng: np.random.RandomState, is_flow: bool = False):
        for t in self.transforms:
            x = t(x, rng, is_flow)
        return x

    def __repr__(self):
        return "Compose(" + ", ".join(repr(t) for t in self.transforms) + ")"


def _size_pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


class CenterCrop:
    """Center crop to (th, tw); optional even-offset to preserve mosaicing
    (data_augmentation.py:52-89)."""

    def __init__(self, size, preserve_mosaicing_pattern: bool = False):
        self.size = _size_pair(size)
        self.preserve_mosaicing_pattern = preserve_mosaicing_pattern

    def __call__(self, x, rng=None, is_flow: bool = False):
        h, w = x.shape[0], x.shape[1]
        th, tw = self.size
        assert th <= h and tw <= w
        i = int(round((h - th) / 2.0))
        j = int(round((w - tw) / 2.0))
        if self.preserve_mosaicing_pattern:
            i += i % 2
            j += j % 2
        return x[i:i + th, j:j + tw]

    def __repr__(self):
        return f"CenterCrop(size={self.size})"


class RandomCrop:
    """Random crop; the offset is drawn from the per-sequence rng so all
    tensors of a sequence share it (data_augmentation.py:92-137)."""

    def __init__(self, size, preserve_mosaicing_pattern: bool = False):
        self.size = _size_pair(size)
        self.preserve_mosaicing_pattern = preserve_mosaicing_pattern

    def __call__(self, x, rng: np.random.RandomState, is_flow: bool = False):
        h, w = x.shape[0], x.shape[1]
        th, tw = self.size
        assert th <= h and tw <= w
        if h == th and w == tw:
            i = j = 0
        else:
            i = int(rng.randint(0, h - th + 1))
            j = int(rng.randint(0, w - tw + 1))
        if self.preserve_mosaicing_pattern:
            i += i % 2
            j += j % 2
        return x[i:i + th, j:j + tw]

    def __repr__(self):
        return f"RandomCrop(size={self.size})"


class RandomRotationFlip:
    """Random rotation + horizontal/vertical flip (data_augmentation.py:140-217).

    The shipped training transform is RandomRotationFlip(0.0, 0.5, 0.0)
    (train.py:149) — pure horizontal flips, implemented exactly via np.flip.
    Nonzero rotation uses a bilinear affine warp with zero padding (torch
    grid_sample semantics).  Flow fields get the inverse-transform rotation
    of their vector components.
    """

    def __init__(self, degrees, p_hflip: float = 0.5, p_vflip: float = 0.5):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be positive")
            self.degrees = (-degrees, degrees)
        else:
            if len(degrees) != 2:
                raise ValueError("degrees must have len 2")
            self.degrees = tuple(degrees)
        self.p_hflip = p_hflip
        self.p_vflip = p_vflip

    def __call__(self, x, rng: np.random.RandomState, is_flow: bool = False):
        angle = float(rng.uniform(self.degrees[0], self.degrees[1]))
        hflip = bool(rng.rand() < self.p_hflip)
        vflip = bool(rng.rand() < self.p_vflip)

        out = x
        if abs(angle) < 1e-9:
            if hflip:
                out = np.flip(out, axis=1)
            if vflip:
                out = np.flip(out, axis=0)
            out = np.ascontiguousarray(out)
            if is_flow:
                if hflip:
                    out = out.copy()
                    out[..., 0] = -out[..., 0]
                if vflip:
                    out = out.copy()
                    out[..., 1] = -out[..., 1]
            return out

        # general case: affine warp in normalized coords (grid_sample style)
        import scipy.ndimage as ndi
        a = angle * pi / 180.0
        m = np.array([[cos(a), -sin(a)], [sin(a), cos(a)]], np.float64)
        if hflip:
            m[:, 0] *= -1
        if vflip:
            m[:, 1] *= -1
        h, w = x.shape[0], x.shape[1]
        # map output pixel centers through m in normalized [-1,1] coords
        center = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
        scale = np.array([w / 2.0, h / 2.0])
        inv = np.linalg.inv(m)

        def warp_channel(ch):
            yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            # normalized target coords (align_corners=False)
            tx = (xx + 0.5) / w * 2 - 1
            ty = (yy + 0.5) / h * 2 - 1
            src = m @ np.stack([tx.ravel(), ty.ravel()])
            sx = (src[0] + 1) / 2 * w - 0.5
            sy = (src[1] + 1) / 2 * h - 0.5
            return ndi.map_coordinates(ch, [sy.reshape(h, w), sx.reshape(h, w)],
                                       order=1, mode="constant", cval=0.0)

        out = np.stack([warp_channel(x[..., c]) for c in range(x.shape[-1])], axis=-1)
        out = out.astype(x.dtype)
        if is_flow:
            vx = out[..., 0].copy()
            vy = out[..., 1].copy()
            out[..., 0] = inv[0, 0] * vx + inv[0, 1] * vy
            out[..., 1] = inv[1, 0] * vx + inv[1, 1] * vy
        return out

    def __repr__(self):
        return (f"RandomRotationFlip(degrees={self.degrees}, "
                f"p_flip={self.p_hflip:.2f}, p_vlip={self.p_vflip:.2f})")
