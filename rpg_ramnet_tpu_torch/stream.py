"""Live depth from an event log: ``python -m rpg_ramnet_tpu_torch.stream``.

Counterpart of the repo's ``depth_stream.py``, with its flags: raw events
from a .txt or .zip log (rows "t x y p" after one header line) are
windowed (fixed count, or fixed duration with --fixed_duration),
voxelized on the device (``ops.voxel.events_to_voxel_grid``: kernel K6 on
the card), preprocessed (hot pixels, flip, normalization), reflection-
padded to a multiple of 2^num_encoders, run through the recurrent model
one event-modality sweep per window (``StreamingInference.step_modality``),
unsharp-masked and cropped back, bilateral-filtered on the host, shown
in a window with --display (``eval.display.DepthDisplay``, cv2; needs a
screen) and written per window:

    python -m rpg_ramnet_tpu_torch.stream -i events.txt \\
        --path_to_model <ckpt> --height 260 --width 346 \\
        [--fixed_duration --window_duration 50] \\
        [-o out_dir --save_numpy --show_events] [--device cpu] \\
        [--display --display_wait_time 1] \\
        [--voxel_backend auto|sortseg|pallas|scatter|matmul]

``--voxel_backend`` is this entry point's own: 'auto' runs K6 on the
card, 'pallas' K7.  A baseline streams each window through its image
branch (depth_stream.py's ``modality``), so its num_bins_rgb must be the
grid's num_bins_events (baseline 'e'); ERGB2Depth has no modality
branches and is refused (the JAX live path fails on it too).
"""
from __future__ import annotations

import argparse
import json
import os
from os.path import join
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from .options import set_depth_inference_options
    ap = argparse.ArgumentParser(
        description="Streaming depth prediction from events (PyTorch)")
    ap.add_argument("-i", "--input_file", required=True, type=str,
                    help="path to events .txt or .zip (rows: t x y pol)")
    ap.add_argument("--path_to_model", required=True, type=str)
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--width", type=int, default=346)
    ap.add_argument("--fixed_duration", action="store_true")
    ap.add_argument("--window_duration", type=float, default=50.0,
                    help="ms (with --fixed_duration)")
    ap.add_argument("--num_events_per_pixel", type=float, default=0.35)
    ap.add_argument("--skipevents", type=int, default=0)
    ap.add_argument("--no_normalize", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--voxel_backend", default="auto",
                    choices=("auto", "sortseg", "pallas", "scatter", "matmul"),
                    help="ops.voxel backend: 'auto' = K6 on the card")
    set_depth_inference_options(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, on_window=None) -> int:
    """Run the stream; returns the number of windows.  on_window(index,
    depth [H, W] float32 numpy) is called for every window."""
    args = parse_args(argv)
    from .core.config import Config
    from .eval.filters import ImageFilter, UnsharpMaskFilter
    from .eval.inference import CropParameters, StreamingInference
    from .eval.writers import _imwrite, ensure_dir, make_event_preview
    from .models import build_model
    from .ops.event_preprocess import EventPreprocessor
    from .ops.voxel import events_to_voxel_grid
    from .train.checkpoint import load_any
    from .utils import require_cuda
    from .utils.event_readers import (FixedDurationEventReader,
                                      FixedSizeEventReader)

    if args.config is None:
        with open(join(os.path.split(args.path_to_model)[0], "config.json")) as f:
            config_dict = json.load(f)
    else:
        with open(args.config) as f:
            config_dict = json.load(f)
    cfg = Config.from_dict(config_dict)
    mcfg = cfg.model
    if cfg.arch == "ERGB2Depth":
        raise ValueError("the live path streams StateNet's modality "
                         "branches one window at a time; ERGB2Depth has "
                         "none (depth_stream.py fails on it too)")
    # events-only streaming: one modality sweep per window, through the
    # image branch for a baseline (depth_stream.py:112)
    modality = "image" if mcfg.is_baseline else "events"
    bins = mcfg.num_bins_rgb if mcfg.is_baseline else mcfg.num_bins_events
    if bins != mcfg.num_bins_events:
        raise ValueError(f"the {modality} branch takes {bins} channels, a "
                         f"window's grid has num_bins_events = "
                         f"{mcfg.num_bins_events}")
    device = require_cuda() if args.device == "cuda" else torch.device("cpu")
    model = build_model(cfg, device=device)
    load_any(args.path_to_model, model)
    model.eval()

    H, W = args.height, args.width
    crop = CropParameters(W, H, mcfg.num_encoders)
    if args.fixed_duration:
        reader = FixedDurationEventReader(args.input_file,
                                          duration_ms=args.window_duration,
                                          start_index=args.skipevents)
    else:
        reader = FixedSizeEventReader(
            args.input_file, num_events=int(W * H * args.num_events_per_pixel),
            start_index=args.skipevents)
    preprocessor = EventPreprocessor(no_normalize=args.no_normalize,
                                     flip=args.flip,
                                     hot_pixels_file=args.hot_pixels_file)
    unsharp = UnsharpMaskFilter(args.unsharp_mask_amount, args.unsharp_mask_sigma)
    bilateral = ImageFilter(args.bilateral_filter_sigma)
    engine = StreamingInference(model)
    engine.reset(1, crop.height_crop, crop.width_crop)
    display = None
    if args.display:
        from .eval.display import DepthDisplay
        display = DepthDisplay("depth", reg_factor=args.reg_factor)

    out_dir = args.output_folder
    if out_dir:
        for d in (out_dir, join(out_dir, "npy"), join(out_dir, "frames")):
            ensure_dir(d)

    windows = 0
    for idx, events in enumerate(reader):
        ev = torch.from_numpy(events.astype(np.float32)).to(device)
        grid = events_to_voxel_grid(ev, ev.shape[0],
                                    num_bins=mcfg.num_bins_events,
                                    height=H, width=W,
                                    backend=args.voxel_backend)
        grid = crop.pad(preprocessor(grid.permute(1, 2, 0)))
        pred = engine.step_modality(grid, modality)
        depth = bilateral(crop.crop(unsharp(pred))[..., 0].cpu().numpy())
        windows += 1
        if display is not None:
            display.show(depth, args.display_wait_time)
        if on_window is not None:
            on_window(idx, depth)
        if out_dir:
            if args.save_numpy:
                np.save(join(out_dir, "npy", f"depth_{idx:010d}.npy"), depth[None])
            _imwrite(join(out_dir, "frames", f"frame_{idx:010d}.png"),
                     depth * 255.0)
            if args.show_events:
                _imwrite(join(out_dir, "frames", f"events_{idx:010d}.png"),
                         make_event_preview(grid.cpu().numpy(),
                                            mode=args.event_display_mode,
                                            num_bins_to_show=args.num_bins_to_show))
    print(f"processed {windows} windows")
    return windows


if __name__ == "__main__":
    main()
