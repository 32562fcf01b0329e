"""Offline depth evaluation of saved npy predictions against their targets:
``python -m rpg_ramnet_tpu_torch.eval.evaluation``.

Counterpart of ``rpg_ramnet_tpu/eval/evaluation.py`` and of the repo's
``evaluation.py`` (reference RAM_Net/evaluation.py), with the same flags
and printout: log depth to metric depth (``prepare_depth_data``), the
masked metric suite over all pixels and below the depth cutoffs 10, 20,
30, 80, 250 and 500 m (``add_to_metrics``), threshold deltas, median
rescaling (``rescale_by_the_median``) and the event-masked variants.  It
reads what ``python -m rpg_ramnet_tpu_torch.eval`` writes
(npy/image/, ground_truth/npy/depth_image/).

numpy only: cv2 is imported to resize (--down_scale_factor < 1) and, where
it is present, to read the event-mask PNGs (else PIL reads them, with
cv2.imread's BGR channel order); matplotlib only for --output_folder and
--debug.
"""
from __future__ import annotations

import argparse
import glob
import os
from os.path import join
from typing import Dict, List, Optional, Sequence

import numpy as np

from .metrics import (abs_rel_diff, mean_error, rms_linear,
                      scale_invariant_error, squ_rel_diff)

DEPTH_VALUES = [10, 20, 30, 80, 250, 500]

_BASE_KEYWORDS = ["abs_rel_diff", "squ_rel_diff", "RMS_linear", "RMS_log",
                  "SILog", "mean_depth_error", "median_diff",
                  "threshold_delta_1.25", "threshold_delta_1.25^2",
                  "threshold_delta_1.25^3"]


def metrics_keywords(prefix: str = "_") -> List[str]:
    out = [f"{prefix}{k}" for k in _BASE_KEYWORDS]
    for d in DEPTH_VALUES:
        out += [f"{prefix}{d}_{k}" for k in _BASE_KEYWORDS]
    return out


def prepare_depth_data(target: np.ndarray, prediction: np.ndarray,
                       clip_distance: float, down_scale_factor: float = 1.0,
                       reg_factor: float = 0.0):
    """Log depth -> metric depth, the prediction clipped to the range a
    log depth in [0, 1] can express (evaluation.py:74-96); the target
    resized by down_scale_factor < 1 (cv2, bilinear)."""
    prediction = np.exp(reg_factor * (prediction - 1.0)) * clip_distance
    target = np.exp(reg_factor * (target - 1.0)) * clip_distance
    prediction = np.clip(prediction, np.exp(-reg_factor) * clip_distance,
                         clip_distance)
    if down_scale_factor < 1.0:
        import cv2
        h, w = target.shape
        target = cv2.resize(target, (int(w * down_scale_factor),
                                     int(h * down_scale_factor)),
                            interpolation=cv2.INTER_LINEAR)
    return target, prediction


def rescale_by_the_median(target: np.ndarray, prediction: np.ndarray):
    """Median/std alignment for a scale-free comparison
    (evaluation.py:99-154)."""
    target = (target - np.median(target)) / np.std(target)
    target = target + abs(np.min(target))
    prediction = (prediction - np.median(prediction)) / np.std(prediction)
    prediction = prediction + abs(np.min(prediction))
    diff = np.abs(np.median(target) - np.median(prediction))
    if np.median(target) < np.median(prediction):
        target = target + diff
    else:
        prediction = prediction + diff
    return target, prediction


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_high_contrast_colormap(idx: int, target: np.ndarray,
                                prediction: np.ndarray, folder: str,
                                prefix: str = "", colormap: str = "tab20c"):
    """Per-frame target/prediction colormap figure (evaluation.py:156-180),
    written to ``folder`` as frame_%010d.png."""
    plt = _pyplot()
    os.makedirs(folder, exist_ok=True)
    finite = target[~np.isnan(target)]
    uniq = sorted(set(finite.ravel().tolist()))
    second_largest = uniq[-2] if len(uniq) > 1 else (uniq[-1] if uniq else 1.0)
    fig, ax = plt.subplots(ncols=1, nrows=2)
    tgt = np.flip(np.fliplr(np.clip(target, 0, np.nanmax(target))))
    pcm = ax[0].pcolormesh(tgt, cmap=colormap, vmin=np.nanmin(target),
                           vmax=second_largest)
    ax[0].set_xticklabels([])
    ax[0].set_title("Target")
    fig.colorbar(pcm, ax=ax[0], extend="both", orientation="vertical")
    prd = np.flip(np.fliplr(np.clip(prediction, 0, np.nanmax(prediction))))
    pcm = ax[1].pcolormesh(prd, cmap=colormap, vmin=np.nanmin(target),
                           vmax=second_largest)
    ax[1].set_title("Prediction")
    fig.colorbar(pcm, ax=ax[1], extend="both", orientation="vertical")
    fig.savefig(join(folder, f"frame_{idx:010d}.png"))
    plt.close(fig)


def save_debug_panel(idx: int, target_: np.ndarray, prediction_: np.ndarray,
                     mask: np.ndarray, folder: str, prefix: str = "_",
                     event_frame: Optional[np.ndarray] = None) -> str:
    """The reference's --debug 4x3 inspection grid (evaluation.py:246-292):
    target/prediction/masked-target depth, log target/log prediction/max
    ratio, abs log diff/abs diff/event overlay, masked log diff/masked abs
    diff/mask, saved to ``folder`` (the reference shows a window).
    Returns the written path."""
    plt = _pyplot()
    eps = 1e-5
    os.makedirs(folder, exist_ok=True)
    fig, ax = plt.subplots(ncols=3, nrows=4, figsize=(12, 10))
    ax[0, 0].imshow(target_, vmin=0, vmax=200)
    ax[0, 0].set_title("target depth")
    ax[0, 1].imshow(prediction_, vmin=0, vmax=200)
    ax[0, 1].set_title("prediction depth")
    target_debug = target_.copy()
    target_debug[~mask] = 0
    ax[0, 2].imshow(target_debug, vmin=0, vmax=200)
    ax[0, 2].set_title("target depth masked")

    ax[1, 0].imshow(np.log(target_ + eps), vmin=0, vmax=np.log(200))
    ax[1, 0].set_title("log target")
    ax[1, 1].imshow(np.log(prediction_ + eps), vmin=0, vmax=np.log(200))
    ax[1, 1].set_title("log prediction")
    ax[1, 2].imshow(np.max(np.stack([target_ / (prediction_ + eps),
                                     prediction_ / (target_ + eps)]), axis=0))
    ax[1, 2].set_title("max ratio")

    ax[2, 0].imshow(np.abs(np.log(target_ + eps) - np.log(prediction_ + eps)))
    ax[2, 0].set_title("abs log diff")
    ax[2, 1].imshow(np.abs(target_ - prediction_))
    ax[2, 1].set_title("abs diff")
    if event_frame is not None:
        a = np.zeros(event_frame.shape[:2] + (3,))
        a[:, :, 0] = np.sum(event_frame.astype("float32"), axis=-1) > 0
        a[:, :, 1] = np.clip(target_.copy(), 0, 1)
        ax[2, 2].imshow(a)
        ax[2, 2].set_title("event frame")

    log_diff_ = np.abs(np.log(target_ + eps) - np.log(prediction_ + eps))
    log_diff_[~mask] = 0
    ax[3, 0].imshow(log_diff_)
    ax[3, 0].set_title("abs log diff masked")
    abs_diff_ = np.abs(target_ - prediction_)
    abs_diff_[~mask] = 0
    ax[3, 1].imshow(abs_diff_)
    ax[3, 1].set_title("abs diff masked")
    ax[3, 2].imshow(mask)
    ax[3, 2].set_title("mask frame")

    fig.suptitle(f"{prefix}Depth_Evaluation")
    path = join(folder, f"debug{prefix}{max(idx, 0):010d}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def add_to_metrics(metrics: Dict[str, float], target_: np.ndarray,
                   prediction_: np.ndarray, mask: np.ndarray,
                   prefix: str = "_", rescale: bool = False,
                   idx: int = -1, output_folder: Optional[str] = None,
                   debug: bool = False,
                   event_frame: Optional[np.ndarray] = None
                   ) -> Dict[str, float]:
    """Accumulate one frame's metrics over the mask (evaluation.py:
    201-244); an empty dict first gets every key of metrics_keywords()."""
    if len(metrics) == 0:
        metrics.update({k: 0.0 for k in metrics_keywords(prefix="_")})
    eps = 1e-5
    if output_folder is not None and idx >= 0:
        fill = np.nanmax(target_)
        save_high_contrast_colormap(idx, np.where(mask, target_, fill),
                                    np.where(mask, prediction_, fill),
                                    output_folder, prefix=prefix)
    target = target_[mask]
    prediction = prediction_[mask]
    if rescale:
        target, prediction = rescale_by_the_median(target, prediction)

    ratio = np.max(np.stack([target / (prediction + eps),
                             prediction / (target + eps)]), axis=0)
    log_diff = np.log(target + eps) - np.log(prediction + eps)

    new_metrics = {
        f"{prefix}threshold_delta_1.25": np.mean(ratio <= 1.25),
        f"{prefix}threshold_delta_1.25^2": np.mean(ratio <= 1.25 ** 2),
        f"{prefix}threshold_delta_1.25^3": np.mean(ratio <= 1.25 ** 3),
        f"{prefix}abs_rel_diff": abs_rel_diff(prediction, target),
        f"{prefix}squ_rel_diff": squ_rel_diff(prediction, target),
        f"{prefix}RMS_linear": rms_linear(prediction, target),
        f"{prefix}RMS_log": np.sqrt((log_diff ** 2).mean()),
        f"{prefix}SILog": scale_invariant_error(np.log(prediction + eps),
                                                np.log(target + eps)),
        f"{prefix}mean_depth_error": mean_error(prediction, target),
        f"{prefix}median_diff": np.abs(np.median(target)
                                       - np.median(prediction)),
    }
    for k, v in new_metrics.items():
        metrics[k] = metrics.get(k, 0.0) + float(v)
    if debug:
        # reference --debug (evaluation.py:246-292): the frame's metrics
        # and the 4x3 inspection grid, saved to disk
        for k, v in new_metrics.items():
            print("%s : %f" % (k, v))
        if output_folder is not None:
            save_debug_panel(idx, target_, prediction_, mask, output_folder,
                             prefix=prefix, event_frame=event_frame)
    return metrics


def _read_mask(path: str) -> np.ndarray:
    """An event-mask PNG as cv2.imread reads it: [H, W, 3] uint8, BGR;
    through PIL where cv2 is absent."""
    try:
        import cv2
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))[..., ::-1]
    return cv2.imread(path)


def evaluate_directories(target_dataset: str, predictions_dataset: str,
                         clip_distance: float = 80.0, reg_factor: float = 0.0,
                         crop_ymax: int = 260, event_masks: str = "",
                         prediction_offset: int = 0, target_offset: int = 0,
                         down_scale_factor: float = 1.0, rescale: bool = False,
                         output_folder: Optional[str] = None,
                         debug: bool = False, debug_idx: int = -1,
                         ) -> Dict[str, float]:
    """The evaluation.py loop (evaluation.py:295-397): every prediction
    file against the target file of its rank after the offsets; returns
    the metrics averaged over the frames.  With --rescale, the median
    rescaling applies to the all-pixel and event-masked legs, not to
    their depth-cutoff legs, as in the JAX package."""
    prediction_files = sorted(glob.glob(join(predictions_dataset, "*.npy"))
                              )[prediction_offset:]
    target_files = sorted(glob.glob(join(target_dataset, "*.npy"))
                          )[target_offset:]
    assert len(prediction_files) > 0 and len(target_files) > 0

    use_event_masks = bool(event_masks)
    if use_event_masks:
        event_frame_files = sorted(glob.glob(join(event_masks, "*png"))
                                   )[prediction_offset:]
        use_event_masks = len(event_frame_files) > 0

    metrics: Dict[str, float] = {}
    num_it = len(prediction_files)
    for idx in range(num_it):
        target_depth = np.load(target_files[idx])[:crop_ymax]
        predicted_depth = np.load(prediction_files[idx])[:crop_ymax]
        target_depth, predicted_depth = prepare_depth_data(
            target_depth[0], predicted_depth[0], clip_distance,
            down_scale_factor, reg_factor)
        assert predicted_depth.shape == target_depth.shape

        depth_mask = np.ones_like(target_depth) > 0
        # reference --debug gating (evaluation.py:360): the selected frame,
        # every frame when debug_idx < 0
        dbg = debug and (debug_idx < 0 or idx == debug_idx)
        if dbg:
            print(f"frame {idx}:")
        add_to_metrics(metrics, target_depth, predicted_depth, depth_mask,
                       prefix="_", rescale=rescale, idx=idx,
                       output_folder=output_folder, debug=dbg)
        for d in DEPTH_VALUES:
            m = np.nan_to_num(target_depth) < d
            add_to_metrics(metrics, target_depth, predicted_depth,
                           depth_mask & m, prefix=f"_{d}_", idx=idx,
                           output_folder=output_folder if dbg else None,
                           debug=dbg)

        if use_event_masks:
            ev = _read_mask(event_frame_files[idx])[:crop_ymax]
            if down_scale_factor < 1.0:
                import cv2
                w = int(ev.shape[1] * down_scale_factor)
                h = int(ev.shape[0] * down_scale_factor)
                ev = cv2.resize(ev, (w, h), interpolation=cv2.INTER_LINEAR)
            event_mask = ev.astype(np.float32).sum(axis=-1) > 0
            add_to_metrics(metrics, target_depth, predicted_depth, event_mask,
                           prefix="event_masked_", rescale=rescale, idx=idx,
                           output_folder=output_folder if dbg else None,
                           debug=dbg, event_frame=ev)
            for d in DEPTH_VALUES:
                m = np.nan_to_num(target_depth) < d
                add_to_metrics(metrics, target_depth, predicted_depth,
                               event_mask & m, prefix=f"event_masked_{d}_",
                               idx=idx,
                               output_folder=output_folder if dbg else None,
                               debug=dbg, event_frame=ev)

    return {k: v / num_it for k, v in metrics.items()}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags of the repo's evaluation.py (RAM_Net/evaluation.py:16-36)."""
    parser = argparse.ArgumentParser("Event Depth Data estimation.")
    parser.add_argument("--target_dataset", default="", required=True)
    parser.add_argument("--predictions_dataset", default="", required=True)
    parser.add_argument("--event_masks", default="")
    parser.add_argument("--crop_ymax", default=260, type=int)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--idx", type=int, default=-1)
    parser.add_argument("--start_idx", type=int, default=-1)
    parser.add_argument("--prediction_offset", type=int, default=0)
    parser.add_argument("--target_offset", type=int, default=0)
    parser.add_argument("--rescale", action="store_true", default=False)
    parser.add_argument("--clip_distance", type=float, default=80.0)
    parser.add_argument("--output_folder", type=str, default=None)
    parser.add_argument("--down_scale_factor", type=float, default=1.0)
    parser.add_argument("--reg_factor", type=float, default=0.0)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """evaluate_directories on the flags; prints 'name : value' per metric,
    a rule, then the values alone, as evaluation.py does.  Returns the
    metrics."""
    args = parse_args(argv)
    metrics = evaluate_directories(
        target_dataset=args.target_dataset,
        predictions_dataset=args.predictions_dataset,
        clip_distance=args.clip_distance, reg_factor=args.reg_factor,
        crop_ymax=args.crop_ymax, event_masks=args.event_masks,
        prediction_offset=args.prediction_offset,
        target_offset=args.target_offset,
        down_scale_factor=args.down_scale_factor, rescale=args.rescale,
        output_folder=args.output_folder, debug=args.debug,
        debug_idx=args.idx)
    for k, v in metrics.items():
        print("%s : %f" % (k, v))
    print("----------------------------------------------")
    for v in metrics.values():
        print("%f" % v)
    return metrics


if __name__ == "__main__":
    main()
