"""Synthetic sequences in the reference's on-disk format (EventScape).

Counterpart of ``rpg_ramnet_tpu/data/synthetic.py``: no real EventScape
data ships with the repo, so tests and the smoke run write small synthetic
sequences in the same file layout, timestamps included, from a seed:

    <seq>/events/voxels/seq_%04d_voxel.npy (+ timestamps.txt)
    <seq>/events/data/seq_%04d_events.npy
    <seq>/depth/data/seq_%04d_depth.npy
    <seq>/rgb/data/seq_%04d_image.png
    <seq>/semantic/data/seq_%04d_gt_labelIds.png

The files equal the JAX package's for the same arguments.
"""
from __future__ import annotations

import os
from os.path import join

import numpy as np

from ..ops.voxel import events_to_voxel_grid_np


def _write_timestamps(folder: str, stamps: np.ndarray) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(join(folder, "timestamps.txt"), "w") as f:
        for i, t in enumerate(stamps):
            f.write(f"{i} {t:.9f}\n")


def _save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(path)


def _scene(idx: int, h: int, w: int, seed: int = 0):
    """A deterministic moving-box scene: (depth in m, gray 0..255); seed
    shifts it so that sequences differ."""
    idx = idx + 37 * seed
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 20.0 + 30.0 * (yy / h) + 5.0 * np.sin(xx / 7.0 + idx * 0.3)
    bx = int((idx * 3) % max(w - 12, 1))
    by = int((idx * 2) % max(h - 12, 1))
    depth[by:by + 10, bx:bx + 10] = 5.0 + (idx % 7)
    gray = (127 + 80 * np.sin(xx / 5.0 - idx * 0.4)
            * np.cos(yy / 9.0)).clip(0, 255)
    gray[by:by + 10, bx:bx + 10] = 230
    return depth.astype(np.float32), gray.astype(np.uint8)


def generate_eventscape_sequence(root: str, n_frames: int = 40,
                                 height: int = 64, width: int = 64,
                                 num_bins: int = 5,
                                 events_per_frame: int = 2000, seed: int = 0,
                                 dt: float = 0.01) -> str:
    """Write one synthetic sequence folder under ``root``."""
    rng = np.random.RandomState(seed)
    stamps = 100.0 + dt * np.arange(n_frames)
    ev_dir, raw_dir = join(root, "events/voxels"), join(root, "events/data")
    depth_dir, rgb_dir = join(root, "depth/data"), join(root, "rgb/data")
    sem_dir = join(root, "semantic/data")
    for d in (ev_dir, raw_dir, depth_dir, rgb_dir, sem_dir):
        _write_timestamps(d, stamps)
    for i in range(n_frames):
        depth, gray = _scene(i, height, width, seed=seed)
        t = np.sort(rng.uniform(stamps[i] - dt, stamps[i], events_per_frame))
        x = rng.randint(0, width, events_per_frame).astype(np.float64)
        y = rng.randint(0, height, events_per_frame).astype(np.float64)
        p = rng.randint(0, 2, events_per_frame).astype(np.float64)
        raw = np.stack([t, x, y, p], axis=1)
        np.save(join(ev_dir, f"seq_{i:04d}_voxel.npy"),
                events_to_voxel_grid_np(raw, num_bins, height, width))
        np.save(join(raw_dir, f"seq_{i:04d}_events.npy"), raw)
        np.save(join(depth_dir, f"seq_{i:04d}_depth.npy"), depth)
        _save_png(join(rgb_dir, f"seq_{i:04d}_image.png"),
                  np.stack([gray, gray, gray], axis=-1))
        _save_png(join(sem_dir, f"seq_{i:04d}_gt_labelIds.png"),
                  (depth < 15).astype(np.uint8) * 10 + 1)
    return root


def generate_split(root: str, n_sequences: int = 2, seed: int = 0,
                   **kw) -> str:
    """A split folder of sequence subfolders seq00, seq01, ... (what
    ``concatenate_subfolders`` reads); sequence s is made from seed+s."""
    for s in range(n_sequences):
        generate_eventscape_sequence(join(root, f"seq{s:02d}"),
                                     seed=seed + s, **kw)
    return root
