"""Offline chunked inference over recorded sequences (test.py --scan_chunk).

Counterpart of ``rpg_ramnet_tpu/eval/inference.py``: ``_resolve_precompute``,
``SequenceScanInference`` and ``run_chunked_streaming``, on the precomputed
path (``ERGB2DepthRecurrent.forward_sequence_precomputed``).  Behaviour kept
from the JAX engines: the recurrent state is carried across the chunks of a
sequence and re-zeroed at every sequence boundary; the tail chunk is
zero-padded to the chunk length (padding only touches the post-sequence
state, which is discarded); one host thread prepares the next chunk while
the device runs the current one.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import ModelConfig
from ..models.model import ERGB2DepthRecurrent


def _resolve_precompute(cfg: ModelConfig,
                        precompute_x: Optional[bool]) -> bool:
    """Tri-state precompute_x: None = auto (on for bf16 compute, where the
    JAX package measured it faster), True forces, False is off."""
    if precompute_x is None:
        return cfg.compute_dtype == "bfloat16"
    return bool(precompute_x)


def _require_precompute(cfg: ModelConfig, precompute_x: Optional[bool]):
    if not _resolve_precompute(cfg, precompute_x):
        raise NotImplementedError(
            "only the precomputed path is ported: pass precompute_x=True "
            "for a float32 config (the scan without x precompute, "
            "forward_sequence_batched_decode, is ROADMAP queue 1, item 4)")


def _pad_time(x: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad axis 0 to ``length``: the tail chunk of a sequence."""
    if len(x) == length:
        return x
    return np.concatenate(
        [x, np.zeros((length - len(x),) + x.shape[1:], x.dtype)])


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class SequenceScanInference:
    """Whole-sequence inference, ``chunk`` packages per forward call."""

    def __init__(self, model: ERGB2DepthRecurrent, chunk: int = 32,
                 precompute_x: Optional[bool] = None):
        _require_precompute(model.cfg, precompute_x)
        self.model = model
        self.chunk = chunk

    @torch.inference_mode()
    def run_sequence(self, events: np.ndarray, image: np.ndarray
                     ) -> Dict[str, np.ndarray]:
        """events [T, K, H, W, Ce], image [T, H, W, Ci] for ONE sequence
        (fresh zero state) -> {key: [T, H, W, 1]} predictions."""
        t_total = events.shape[0]
        h, w = image.shape[1], image.shape[2]
        dev = self.model.device
        state = self.model.init_state(1, h, w)
        outs: Dict[str, List[np.ndarray]] = {}
        for t0 in range(0, t_total, self.chunk):
            n = min(self.chunk, t_total - t0)
            ev = _pad_time(events[t0:t0 + self.chunk], self.chunk)
            im = _pad_time(image[t0:t0 + self.chunk], self.chunk)
            seq = {"events": _to_device(ev, dev)[None],
                   "image": _to_device(im, dev)[None]}
            state, preds = self.model.forward_sequence_precomputed(state, seq)
            for k, v in preds.items():
                outs.setdefault(k, []).append(v[:n, 0].cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}


@torch.inference_mode()
def run_chunked_streaming(dataset, model: ERGB2DepthRecurrent,
                          chunk: int = 16, on_prediction=None,
                          decode_keys=None,
                          precompute_x: Optional[bool] = None) -> None:
    """Offline chunked streaming over a ConcatSequenceDataset-like
    ``dataset``: ``dataset.datasets`` is the list of sequences, and item i
    of a sequence is {'events': [1, K, H, W, Ce], 'image': [1, H, W, Ci]}.
    Each sequence runs ``chunk`` packages per forward call.
    on_prediction(global_idx, {key: [H, W, 1] numpy}, item, seq_pos) is
    called for every real item, in order."""
    _require_precompute(model.cfg, precompute_x)
    dk = tuple(decode_keys) if decode_keys else None
    dev = model.device
    sizes = [len(d) for d in dataset.datasets]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int)

    def load_chunk(sub, t0, size):
        items = [sub[i] for i in range(t0, min(t0 + chunk, size))]
        ev = _pad_time(np.stack([it["events"][0] for it in items]), chunk)
        im = _pad_time(np.stack([it["image"][0] for it in items]), chunk)
        ev_t, im_t = torch.from_numpy(ev), torch.from_numpy(im)
        if dev.type == "cuda":
            ev_t, im_t = ev_t.pin_memory(), im_t.pin_memory()
        return items, ev_t, im_t

    tasks = [(s, t0) for s in range(len(sizes))
             for t0 in range(0, sizes[s], chunk)]
    if not tasks:
        return
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(load_chunk, dataset.datasets[tasks[0][0]],
                          tasks[0][1], sizes[tasks[0][0]])
        state, cur_seq = None, -1
        for ti, (s, t0) in enumerate(tasks):
            items, ev_t, im_t = fut.result()
            if ti + 1 < len(tasks):
                s2, t02 = tasks[ti + 1]
                fut = pool.submit(load_chunk, dataset.datasets[s2], t02,
                                  sizes[s2])
            if s != cur_seq:
                state = model.init_state(1, im_t.shape[1], im_t.shape[2])
                cur_seq = s
            seq = {"events": ev_t.to(dev, non_blocking=True)[None],
                   "image": im_t.to(dev, non_blocking=True)[None]}
            state, preds = model.forward_sequence_precomputed(
                state, seq, decode_keys=dk)
            if on_prediction is not None:
                preds_np = {k: v.cpu().numpy() for k, v in preds.items()}
                for j, item in enumerate(items):
                    on_prediction(int(starts[s] + t0 + j),
                                  {k: v[j, 0] for k, v in preds_np.items()},
                                  item, t0 + j)
