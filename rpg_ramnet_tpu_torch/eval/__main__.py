"""Depth inference over recorded sequences: ``python -m rpg_ramnet_tpu_torch.eval``.

Counterpart of the repo's ``test.py`` (reference RAM_Net/test.py), with its
flags and output tree (depth/, npy/, color_map/, ground_truth/,
semantic_seg/, video/, which ``evaluation.py`` reads) and its printed
scale and metric lines:

  --path_to_model   a checkpoint directory of the port or a .pth.tar
  --config          the JSON config (default: config.json beside the model)
  --output_path     where to write the tree (nothing written when empty)
  --data_folder     split folder under $PREPROCESSED_DATASETS_FOLDER
  --crop H,W        center crop (reference: 256,512)
  --scan_chunk N    offline chunked inference, N packages per forward call
                    (run_chunked_streaming); 0, the default, runs the
                    per-package engine with batched decode
  --lanes N         lane-batched streaming: the sequences round-robin over
                    N lanes, a reset mask per lane (run_batched_streaming;
                    with --scan_chunk, run_batched_chunked_streaming)
  --precompute_x, --decode_keys, --dataset_reg_factor   as test.py
  --mesh N          a mesh of N devices (cuda:0 .. cuda:N-1; N replicas
                    on the CPU with --device cpu): with --lanes > 1 the
                    lanes over it, a replica and a lane state per device;
                    with --lanes 1 the per-package engine's H split into N
                    row bands (spatial partitioning, parallel/spatial.py:
                    the crop's height over N must be a multiple of
                    2**num_encoders); --scan_chunk without lanes ignores
                    it, as test.py does
  --device          'cuda' (default) or 'cpu'

The model is the config's ``arch``: ERGB2DepthRecurrent (baselines
included, their datasets packed as the baseline asks) or ERGB2Depth,
whose dataset reads raw events (recurrency off, test.py:93).
In the phased regime (the config's top-level use_phased_arch) the
dataset's items carry their timestamps, which go into each package as
test.py passes them.  Behaviour kept from test.py: the state resets at
every sequence boundary,
predictions are saved only from a sequence's third item on, the metric
vector runs over the saved items and the metric-space scale over all.
With lanes the items arrive out of dataset order; each is handled under
its global index and its position in its sequence, so the output tree
and the scale vector are those of one lane, with a mesh or without.
"""
from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="RAM-Net depth inference (PyTorch)")
    ap.add_argument("--path_to_model", type=str, default="")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--output_path", type=str, default="")
    ap.add_argument("--data_folder", type=str, default="")
    ap.add_argument("--crop", type=str, default="256,512",
                    help="center-crop H,W (reference: 256,512)")
    ap.add_argument("--lanes", type=int, default=1,
                    help="lane-batched streaming over N lanes (with "
                         "--scan_chunk: lanes x chunk)")
    ap.add_argument("--scan_chunk", type=int, default=0,
                    help="offline chunked inference, N packages per "
                         "forward call (0: the per-package engine)")
    ap.add_argument("--precompute_x", choices=("auto", "on", "off"),
                    default="auto",
                    help="x-side precompute for --scan_chunk: 'auto' = on "
                         "for bf16 configs")
    ap.add_argument("--decode_keys", type=str, default="",
                    help="comma list restricting decoded predictions")
    ap.add_argument("--dataset_reg_factor", type=float, default=5.7,
                    help="reg_factor for loading depth targets (the "
                         "reference's test.py leaves it at 5.7)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="a mesh of N devices: the lanes over it (--lanes "
                         "> 1), or H split into N row bands (--lanes 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, on_prediction=None):
    """Run test.py's loop; returns the model.  on_prediction(global index,
    {key: [H, W, 1] numpy prediction}) is called for every item."""
    args = parse_args(argv)
    mesh = spatial_mesh = None
    if args.mesh > 0:     # test.py:117-135
        from ..core.config import MeshConfig
        from ..parallel import make_mesh
        if args.device == "cpu":
            devices = [torch.device("cpu")] * args.mesh
        else:
            n = torch.cuda.device_count()
            if n < args.mesh:
                raise SystemExit(f"--mesh {args.mesh}: only {n} "
                                 "devices available")
            devices = [torch.device("cuda", i) for i in range(args.mesh)]
        if args.lanes > 1:
            mesh = make_mesh(MeshConfig(data=args.mesh, model=1), devices)
        else:
            spatial_mesh = make_mesh(MeshConfig(data=1, model=args.mesh),
                                     devices)
    if args.config is None:
        with open(join(os.path.split(args.path_to_model)[0], "config.json")) as f:
            config_dict = json.load(f)
    else:
        with open(args.config) as f:
            config_dict = json.load(f)

    from ..core.config import Config
    from ..data import CenterCrop, concatenate_subfolders
    from ..models import build_model
    from ..models.model import summary
    from ..train.checkpoint import load_any
    from ..utils import require_cuda
    from .inference import (StreamingInference, optimal_scale,
                            run_batched_chunked_streaming,
                            run_batched_streaming, run_chunked_streaming)
    from .metrics import eval_metrics
    from .writers import DepthOutputWriter

    cfg = Config.from_dict(config_dict)
    device = require_cuda() if args.device == "cuda" else torch.device("cpu")
    root = os.environ["PREPROCESSED_DATASETS_FOLDER"]
    data_folder = args.data_folder or "dataset_mathias_23_07/test/"
    crop_hw = [int(v) for v in args.crop.split(",")]
    vd = cfg.val_data
    dataset = concatenate_subfolders(
        join(root, data_folder), vd.type, vd.event_folder, vd.depth_folder,
        vd.frame_folder, sequence_length=1, transform=CenterCrop(crop_hw),
        proba_pause_when_running=vd.proba_pause_when_running,
        proba_pause_when_paused=vd.proba_pause_when_paused, step_size=1,
        clip_distance=vd.clip_distance, every_x_rgb_frame=vd.every_x_rgb_frame,
        normalize=cfg.normalize, scale_factor=vd.scale_factor,
        # test.py's quirk, kept for output parity: its datasets load depth
        # targets with reg_factor 5.7 whatever the config says
        reg_factor=args.dataset_reg_factor, use_phased_arch=cfg.use_phased_arch,
        load_semantic=bool(args.output_path), baseline=vd.baseline,
        loss_composition=cfg.trainer.loss_composition,
        recurrency=cfg.arch != "ERGB2Depth")

    model = build_model(cfg, device=device)
    load_any(args.path_to_model, model)
    print(f"Loading model weights from: {args.path_to_model}")
    summary(model, cfg.arch)
    model.eval()

    decode_keys = tuple(k for k in args.decode_keys.split(",") if k) or None
    writer = DepthOutputWriter(args.output_path) if args.output_path else None
    reg_factor = cfg.train_data.reg_factor
    clip_distance = vd.clip_distance
    n = len(dataset)
    scales, total_metrics = np.empty(n), []
    if writer is not None and n > 0:
        # the reference reads sample 20 (test.py:197); clamped for short sets
        sample, _ = dataset[min(20, n - 1)]
        writer.set_color_mapper(np.moveaxis(sample["depth_image"][0], -1, 0))

    def target(item, key):
        return (item["depth_image"][0] if key == "image"
                else item["depth_events"][0, int(key[len("events"):])])

    def handle(idx, preds, item, sequence_idx):
        """test.py's per-item handling: saving from the third item of a
        sequence on (test.py:259), running metrics, metric-space scale."""
        if on_prediction is not None:
            on_prediction(idx, preds)
        if writer is not None and sequence_idx > 1:
            for key, img in preds.items():
                img_chw = np.moveaxis(img, -1, 0)
                gt_chw = np.moveaxis(target(item, key), -1, 0)
                total_metrics.append(eval_metrics(img_chw[None], gt_chw[None]))
                writer.write_prediction(idx, key, img_chw)
                writer.write_ground_truth(idx, "depth_" + key, gt_chw)
            if "semantic_image" in item:
                writer.write_semantic(idx, "semantic_image", np.moveaxis(
                    item["semantic_image"][0], -1, 0))
            for k in range(item["semantic_events"].shape[1]
                           if "semantic_events" in item else 0):
                writer.write_semantic(idx, f"semantic_events{k}", np.moveaxis(
                    item["semantic_events"][0, k], -1, 0))
            for key in preds:
                inp = (item["image"][0] if key == "image"
                       else item["events"][0, int(key[len("events"):])])
                writer.write_video_frame(np.moveaxis(preds[key], -1, 0),
                                         np.moveaxis(target(item, key), -1, 0),
                                         inp, is_event_key="event" in key)
            if idx % 100 == 0:
                print("saved image ", idx)
        # the last key wins, as in the reference
        for key, img in preds.items():
            scales[idx] = optimal_scale(img[..., 0], target(item, key)[..., 0],
                                        reg_factor, clip_distance)

    precompute_x = {"auto": None, "on": True, "off": False}[args.precompute_x]
    if args.lanes > 1 and args.scan_chunk > 0:     # test.py:188-198
        run_batched_chunked_streaming(dataset, model, n_lanes=args.lanes,
                                      chunk=args.scan_chunk,
                                      on_prediction=handle,
                                      decode_keys=decode_keys,
                                      precompute_x=precompute_x, mesh=mesh)
    elif args.lanes > 1:
        run_batched_streaming(dataset, model, n_lanes=args.lanes,
                              on_prediction=handle, mesh=mesh)
    elif args.scan_chunk > 0:
        run_chunked_streaming(dataset, model, chunk=args.scan_chunk,
                              on_prediction=handle, decode_keys=decode_keys,
                              precompute_x=precompute_x)
    else:
        engine = StreamingInference(model, decode_keys=decode_keys,
                                    batched_decode=True,
                                    spatial_mesh=spatial_mesh)
        prev_dataset_idx, sequence_idx = -1, 0
        with ThreadPoolExecutor(1) as pool:   # one-item host prefetch
            fut = pool.submit(dataset.__getitem__, 0) if n else None
            for idx in range(n):
                item, dataset_idx = fut.result()
                if idx + 1 < n:
                    fut = pool.submit(dataset.__getitem__, idx + 1)
                pkg = {"events": item["events"][0], "image": item["image"][0]}
                if cfg.use_phased_arch:     # test.py:227-231
                    for k in ("times_events", "times_image"):
                        if k in item:
                            pkg[k] = item[k][0]
                if dataset_idx > prev_dataset_idx:
                    engine.reset(1, *pkg["image"].shape[:2])
                    sequence_idx = 0
                handle(idx, engine.step(pkg), item, sequence_idx)
                sequence_idx += 1
                prev_dataset_idx = dataset_idx

    print("total scale: ", np.mean(scales))
    print("min scale: ", np.min(scales))
    print("max scale: ", np.max(scales))
    if total_metrics:
        print("total metrics: ",
              np.sum(np.array(total_metrics), 0) / len(total_metrics))
    return model


if __name__ == "__main__":
    main()
