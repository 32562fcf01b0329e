"""Training visualization helpers.

Counterpart of ``rpg_ramnet_tpu/utils/training_utils.py`` (reference
RAM_Net/utils/training_utils.py: count_parameters:7,
select_evenly_spaced_elements:11, flow2rgb:15, plot_grad_flow_bars:85).
Parameters and gradients come from ``named_parameters()``, under the
upstream names without the arch prefix, which are the JAX package's
param-tree paths, so both trainers write the same TensorBoard tags.
matplotlib, PIL and tensorboard are imported where they are used: a
machine may lack any of them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# the models' top-level submodules (the upstream arch prefixes)
ARCH_PREFIXES = ("statenetphasedrecurrent.", "unet.")


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def select_evenly_spaced_elements(num_elements: int,
                                  sequence_length: int) -> List[int]:
    return [i * sequence_length // num_elements
            + sequence_length // (2 * num_elements)
            for i in range(num_elements)]


def flow2rgb(disp_x: np.ndarray, disp_y: np.ndarray,
             max_magnitude=None) -> np.ndarray:
    """Optic-flow field -> HSV-coded RGB image, [3, H, W] in [0, 1]."""
    import matplotlib.colors
    h, w = disp_x.shape
    mag = np.sqrt(disp_x ** 2 + disp_y ** 2)
    ang = np.arctan2(disp_y, disp_x)
    ang[ang < 0] += 2 * np.pi
    hsv = np.zeros((h, w, 3), np.float32)
    hsv[..., 0] = ang / (2 * np.pi)
    hsv[..., 1] = 1.0
    hsv[..., 2] = mag / max_magnitude if max_magnitude else \
        np.clip(mag / (np.max(mag) + 1e-9), 0, 1)
    return np.moveaxis(matplotlib.colors.hsv_to_rgb(hsv), -1, 0)


def strip_arch_prefix(name: str) -> str:
    for pre in ARCH_PREFIXES:
        if name.startswith(pre):
            return name[len(pre):]
    return name


def named_weights(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter as float32 numpy under its name without the arch
    prefix, in registration order."""
    return {strip_arch_prefix(n): p.detach().float().cpu().numpy()
            for n, p in model.named_parameters()}


def plot_grad_flow_bars(grads: Dict[str, np.ndarray]):
    """Average-gradient-magnitude bar chart per weight and bias (log
    scale), the reference's TensorBoard 'grad_figure'
    (training_utils.py:85-124).  grads: {name: array}.  Returns a
    matplotlib figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names, avgs = [], []
    for name, g in grads.items():
        if name.endswith("weight") or name.endswith("bias"):
            names.append(name)
            avgs.append(float(np.abs(g).mean()))
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.25), 4))
    ax.bar(np.arange(len(avgs)), avgs, lw=1, color="c")
    ax.set_yscale("log")
    ax.set_xticks(np.arange(len(names)))
    ax.set_xticklabels(names, rotation=90, fontsize=4)
    ax.set_xlabel("Layers")
    ax.set_ylabel("average gradient magnitude")
    ax.set_title("Gradient flow")
    fig.tight_layout()
    return fig


def add_video_gif(tb, tag: str, video: np.ndarray, fps: int,
                  global_step: int) -> None:
    """A TensorBoard video summary without moviepy (torch's add_video
    needs it): video [1, T, C, H, W] float in [0, 1] as an endlessly
    looping GIF in an image summary, emitted through the writer's file
    writer.  The reference writes its movies at fps 5
    (lstm_trainer.py:518-523)."""
    import io

    from PIL import Image
    from tensorboard.compat.proto.summary_pb2 import Summary

    v = (np.clip(np.asarray(video), 0, 1) * 255).astype(np.uint8)
    t, c, h, w = v.shape[1:]
    frames = [Image.fromarray(v[0, i, 0] if c == 1
                              else np.moveaxis(v[0, i], 0, -1))
              for i in range(t)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:],
                   duration=max(int(1000 / fps), 1), loop=0)
    image = Summary.Image(height=h, width=w, colorspace=c,
                          encoded_image_string=buf.getvalue())
    tb._get_file_writer().add_summary(
        Summary(value=[Summary.Value(tag=tag, image=image)]), global_step)
