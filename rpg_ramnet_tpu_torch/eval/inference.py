"""Inference engines: per-package streaming and offline chunked inference.

Counterpart of ``rpg_ramnet_tpu/eval/inference.py``:

- ``StreamingInference``, the per-package engine that ``test.py`` runs by
  default and the live ``depth_stream.py`` path runs one modality at a
  time (``step_modality``), on ``forward_package(_batched_decode)``;
- ``SequenceScanInference`` and ``run_chunked_streaming`` (``test.py
  --scan_chunk``): with batched_decode (``run_chunked_streaming``'s
  default) on the precomputed path
  (``ERGB2DepthRecurrent.forward_sequence_precomputed``) where
  ``_resolve_precompute`` takes it, else on
  ``forward_sequence_batched_decode`` (the phased regime, float32
  configs); without it (``SequenceScanInference``'s default) on
  ``forward_sequence``, bit-identical to per-package streaming;
- ``CropParameters``, ``optimal_crop_size`` and ``optimal_scale``.

Behaviour kept from the JAX engines: the recurrent state is carried
across the packages and chunks of a sequence and re-zeroed at every
sequence boundary; the tail chunk is zero-padded to the chunk length
(padding only touches the post-sequence state, which is discarded); one
host thread prepares the next chunk while the device runs the current
one; in the phased regime the packages' timestamps go with them.  Lanes
and the spatial mesh are not ported (ROADMAP queue 1, items 14 and 15).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..models import statenet
from ..models.model import ERGB2DepthRecurrent
from ..utils.layout import to_nchw, to_nhwc


def optimal_crop_size(max_size: int, max_subsample_factor: int) -> int:
    """Smallest multiple of 2^num_encoders >= max_size
    (inference_utils.py:278-284)."""
    f = 2 ** max_subsample_factor
    return ((max_size + f - 1) // f) * f


@dataclasses.dataclass
class CropParameters:
    """Reflection-pad an input to a multiple of 2^num_encoders, then crop
    the predictions back (inference_utils.py:287-316).  pad and crop take
    numpy arrays or tensors [..., H, W, C]."""
    width: int
    height: int
    num_encoders: int

    def __post_init__(self):
        self.width_crop = optimal_crop_size(self.width, self.num_encoders)
        self.height_crop = optimal_crop_size(self.height, self.num_encoders)
        self.padding_left = (self.width_crop - self.width) // 2
        self.padding_right = self.width_crop - self.width - self.padding_left
        self.padding_top = (self.height_crop - self.height) // 2
        self.padding_bottom = self.height_crop - self.height - self.padding_top

    def pad(self, x):
        """x: [..., H, W, C] -> reflection-padded to the crop size."""
        t, b = self.padding_top, self.padding_bottom
        l, r = self.padding_left, self.padding_right
        if isinstance(x, np.ndarray):
            pads = [(0, 0)] * (x.ndim - 3) + [(t, b), (l, r), (0, 0)]
            return np.pad(x, pads, mode="reflect")
        if not (t or b or l or r):
            return x
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        y = F.pad(to_nchw(x.reshape(-1, h, w, c)), (l, r, t, b),
                  mode="reflect")
        return to_nhwc(y).reshape(*lead, h + t + b, w + l + r, c)

    def crop(self, x):
        h0, w0 = self.padding_top, self.padding_left
        return x[..., h0:h0 + self.height, w0:w0 + self.width, :]


def optimal_scale(prediction: np.ndarray, target: np.ndarray,
                  reg_factor: float, clip_distance: float) -> float:
    """Metric-space optimal scale (test.py:365-378)."""
    pred = np.exp(reg_factor * (prediction - 1.0)) * clip_distance
    targ = np.exp(reg_factor * (target - 1.0)) * clip_distance
    return float(np.sum(pred * targ) / np.sum(pred * pred))


def _as_input(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device`` (float32 numpy stays float32;
    the model casts to its compute dtype)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class StreamingInference:
    """Single-lane per-package streaming (the reference's behaviour).

    decode_keys: decode only these predictions (all when None).
    batched_decode: decode the K+1 predictions of a package as one
    batched decoder pass (``forward_package_batched_decode``; identical
    outputs), unless decode_keys restricts them.  As in the JAX engine,
    only ``cfg.fused_gru == 'on'`` lets ``step`` run the cells as kernel
    K5, ``step`` lets the fused_decoder policy run decoder layers as
    kernel K8 and, for ``cfg.composed_decoder == 'on'`` only, the composed
    layers; ``step_modality`` does none of these.  Runs under
    inference_mode."""

    def __init__(self, model: ERGB2DepthRecurrent, decode_keys=None,
                 batched_decode: bool = False, spatial_mesh=None):
        if spatial_mesh is not None:
            raise NotImplementedError(
                "spatial_mesh (H-sharded single-stream inference) is not "
                "ported yet: ROADMAP queue 1, item 15")
        self.model = model
        self.cfg = model.cfg
        self.decode_keys = tuple(decode_keys) if decode_keys else None
        self.batched_decode = batched_decode and self.decode_keys is None
        self.allow_fused = model.cfg.fused_gru == "on"
        self.allow_composed = model.cfg.composed_decoder == "on"
        self._state = None

    def reset(self, batch: int, height: int, width: int) -> None:
        self._state = self.model.init_state(batch, height, width)

    @torch.inference_mode()
    def step(self, pkg) -> Dict[str, np.ndarray]:
        """pkg: {'events': [K, H, W, C], 'image': [H, W, C], and for the
        phased regime 'times_events' [K] and 'times_image' (a scalar)}
        (unbatched, numpy or tensors) -> {key: [H, W, 1] float32 numpy}."""
        dev = self.model.device
        batched = {k: _as_input(pkg[k], dev)[None] for k in ("events", "image")}
        for k, shape in (("times_events", (1, -1)), ("times_image", (1,))):
            if k in pkg:
                batched[k] = _as_input(np.asarray(pkg[k], np.float32),
                                       dev).reshape(shape)
        if self._state is None:
            self.reset(1, *batched["image"].shape[1:3])
        flags = dict(allow_fused=self.allow_fused, allow_fused_decoder=True,
                     allow_composed=self.allow_composed)
        if self.batched_decode:
            self._state, preds = self.model.forward_package_batched_decode(
                self._state, batched, **flags)
        else:
            self._state, preds = self.model.forward_package(
                self._state, batched, decode_keys=self.decode_keys, **flags)
        return {k: v[0].float().cpu().numpy() for k, v in preds.items()}

    @torch.inference_mode()
    def step_modality(self, x, modality: str = "events"):
        """Single-modality streaming (the events-only live path): one
        encoder sweep and one decode.  x: [H, W, C] unbatched -> [H, W, 1]
        float32, a numpy array for a numpy input, else a tensor on the
        model's device."""
        net = self.model.statenetphasedrecurrent
        as_numpy = isinstance(x, np.ndarray)
        xt = _as_input(x, self.model.device)[None]
        if self._state is None:
            self.reset(1, xt.shape[1], xt.shape[2])
        state = statenet.forward_modality(
            net, self.cfg, to_nchw(xt),
            statenet.map_state(to_nchw, self._state), modality)
        self._state = statenet.map_state(to_nhwc, state)
        pred = to_nhwc(statenet.forward_decoder_supers(
            net, self.cfg, statenet.decoder_view(self.cfg, state)))[0]
        return pred.cpu().numpy() if as_numpy else pred


def _resolve_precompute(cfg: ModelConfig,
                        precompute_x: Optional[bool]) -> bool:
    """Tri-state precompute_x: None = auto (on for bf16 compute on the
    configs whose x side is state-independent, where the JAX package
    measured it faster), True forces (the model raises where the config
    does not support it), False is off."""
    if precompute_x is None:
        return (statenet.supports_x_precompute(cfg)
                and cfg.compute_dtype == "bfloat16")
    return bool(precompute_x)


def _chunk_forward(model: ERGB2DepthRecurrent,
                   precompute_x: Optional[bool], decode_keys=None,
                   batched_decode: bool = True):
    """forward(state, seq) of the chunked engines, routed as JAX
    inference.py:197-212 and :263-274: with batched_decode, the
    precomputed path where ``_resolve_precompute`` takes it, else
    forward_sequence_batched_decode with the cells' kernels allowed only
    for fused_gru='on', the fused_decoder policy (K8) allowed, and the
    composed layers only for composed_decoder='on'; without
    batched_decode, forward_sequence (per-step decodes, no kernels)."""
    cfg = model.cfg
    if batched_decode and _resolve_precompute(cfg, precompute_x):
        return lambda state, seq: model.forward_sequence_precomputed(
            state, seq, decode_keys=decode_keys)
    if batched_decode:
        flags = dict(allow_fused=cfg.fused_gru == "on",
                     allow_fused_decoder=True,
                     allow_composed=cfg.composed_decoder == "on")
        return lambda state, seq: model.forward_sequence_batched_decode(
            state, seq, decode_keys=decode_keys, **flags)
    return lambda state, seq: model.forward_sequence(
        state, seq, decode_keys=decode_keys)


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
    """Whole-sequence inference, ``chunk`` packages per forward call.

    batched_decode: defer the chunk's decodes to one decoder pass over all
    chunk*(K+1) snapshots (the precomputed path or
    forward_sequence_batched_decode, ``_chunk_forward``); off by default,
    as in JAX, which runs forward_sequence: bit-identical to per-package
    streaming (``StreamingInference``)."""

    def __init__(self, model: ERGB2DepthRecurrent, chunk: int = 32,
                 batched_decode: bool = False,
                 precompute_x: Optional[bool] = None):
        self.model = model
        self.chunk = chunk
        self._fwd = _chunk_forward(model, precompute_x,
                                   batched_decode=batched_decode)

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
            state, preds = self._fwd(state, seq)
            for k, v in preds.items():
                outs.setdefault(k, []).append(v[:n, 0].cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}


@torch.inference_mode()
def run_chunked_streaming(dataset, model: ERGB2DepthRecurrent,
                          chunk: int = 16, on_prediction=None,
                          batched_decode: bool = True, decode_keys=None,
                          precompute_x: Optional[bool] = None) -> None:
    """Offline chunked streaming over a ConcatSequenceDataset-like
    ``dataset``: ``dataset.datasets`` is the list of sequences, and item i
    of a sequence is {'events': [1, K, H, W, Ce], 'image': [1, H, W, Ci]},
    and in the phased regime 'times_events' [1, K] and 'times_image' [1].
    Each sequence runs ``chunk`` packages per forward call (see
    ``_chunk_forward`` for which; batched_decode defaults to True, as in
    JAX).  on_prediction(global_idx, {key: [H, W, 1] numpy}, item,
    seq_pos) is called for every real item, in order."""
    dk = tuple(decode_keys) if decode_keys else None
    fwd = _chunk_forward(model, precompute_x, dk, batched_decode)
    dev = model.device
    sizes = [len(d) for d in dataset.datasets]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int)

    def load_chunk(sub, t0, size):
        items = [sub[i] for i in range(t0, min(t0 + chunk, size))]
        arrs = {"events": np.stack([it["events"][0] for it in items]),
                "image": np.stack([it["image"][0] for it in items])}
        # the phased regime: the timestamps go with the chunk
        # (inference.py:295-302 of the JAX package)
        if model.cfg.use_phased_arch and "times_events" in items[0]:
            arrs["times_events"] = np.stack(
                [np.atleast_1d(it["times_events"][0]) for it in items]
            ).astype(np.float32)
            arrs["times_image"] = np.array(
                [np.asarray(it["times_image"][0]).ravel()[0] for it in items],
                np.float32)
        out = {}
        for k, v in arrs.items():
            out[k] = torch.from_numpy(_pad_time(v, chunk))
            if dev.type == "cuda":
                out[k] = out[k].pin_memory()
        return items, out

    tasks = [(s, t0) for s in range(len(sizes))
             for t0 in range(0, sizes[s], chunk)]
    if not tasks:
        return
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(load_chunk, dataset.datasets[tasks[0][0]],
                          tasks[0][1], sizes[tasks[0][0]])
        state, cur_seq = None, -1
        for ti, (s, t0) in enumerate(tasks):
            items, arrs = fut.result()
            if ti + 1 < len(tasks):
                s2, t02 = tasks[ti + 1]
                fut = pool.submit(load_chunk, dataset.datasets[s2], t02,
                                  sizes[s2])
            if s != cur_seq:
                im = arrs["image"]
                state = model.init_state(1, im.shape[1], im.shape[2])
                cur_seq = s
            seq = {k: v.to(dev, non_blocking=True)[None]
                   for k, v in arrs.items()}
            state, preds = fwd(state, seq)
            if on_prediction is not None:
                preds_np = {k: v.cpu().numpy() for k, v in preds.items()}
                for j, item in enumerate(items):
                    on_prediction(int(starts[s] + t0 + j),
                                  {k: v[j, 0] for k, v in preds_np.items()},
                                  item, t0 + j)
