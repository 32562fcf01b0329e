"""Inference engines: per-package streaming, offline chunked inference
and lane-batched streaming.

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
- ``BatchedStreamingInference`` and ``run_batched_streaming`` (``test.py
  --lanes N``): N sequences advance in lockstep, one ``forward_package``
  per step at batch N, a per-lane reset mask zeroing a lane's state at
  its sequence boundary; ``run_batched_chunked_streaming`` (``--lanes N
  --scan_chunk M``): M packages of N lanes per forward call, the reset
  mask per step and lane;
- ``CropParameters``, ``optimal_crop_size`` and ``optimal_scale``.

Every engine takes ERGB2DepthRecurrent (baselines included: they route
as any config without x precompute) and ERGB2Depth, the stateless UNet,
which runs its ``forward_package`` per package and its
``forward_sequence`` per chunk, as JAX's fallback does (resets are moot
without state).  Behaviour kept from the JAX engines: the recurrent state is carried
across the packages and chunks of a sequence and re-zeroed at every
sequence boundary; the tail chunk is zero-padded to the chunk length
(padding only touches the post-sequence state, which is discarded); lanes
that ran dry get zero packages under a standing reset, and their outputs
go to no callback; one host thread prepares the next chunk or lane step
while the device runs the current one; in the phased regime the packages'
timestamps go with them.

The lane engines take a ``mesh`` (``parallel.make_mesh``; JAX
inference.py:345-375, :493-603): the lanes split over the mesh's data
axis, one replica of the weights and one lane state per device, each
device stepping its contiguous block of n_lanes/data lanes (its share of
the packed buffers and of the reset mask), the maps gathered back in lane
order on the first device.  Each replica runs whole tensors of its share,
so the kernels stay on (JAX's ``auto`` turns its Pallas cells off under a
mesh; ROADMAP queue 3).  A mesh whose model axis is above 1 splits one
stream's H into row bands instead (``StreamingInference(spatial_mesh=)``,
``parallel.spatial``, JAX inference.py:72-139); the lane engines take a
model axis of 1 only (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..models import statenet
from ..models.model import ERGB2Depth, ERGB2DepthRecurrent
from ..parallel import spatial
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, Sharding, make_mesh,
                             replicate)
from ..utils.layout import to_nchw, to_nhwc

Model = Union[ERGB2DepthRecurrent, ERGB2Depth]


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
    inference_mode.

    spatial_mesh: a ``parallel.Mesh`` whose model axis splits H into row
    bands (``parallel.spatial.SpatialModel``): a replica of the weights
    per band, the state kept as per-band shards, each band's layers and
    kernels run on the band and its halo; the maps come back whole.  The
    latency mode of one stream over several devices (JAX
    inference.py:72-139); ERGB2Depth runs its UNet over the bands the
    same way (``spatial.unet_forward``)."""

    def __init__(self, model: Model, decode_keys=None,
                 batched_decode: bool = False, spatial_mesh=None):
        self._spatial = (None if spatial_mesh is None
                         else spatial.SpatialModel(model, spatial_mesh))
        self.model = model
        self.cfg = model.cfg
        self.decode_keys = tuple(decode_keys) if decode_keys else None
        self.batched_decode = (batched_decode and self.decode_keys is None
                               and hasattr(model,
                                           "forward_package_batched_decode"))
        self.allow_fused = model.cfg.fused_gru == "on"
        self.allow_composed = model.cfg.composed_decoder == "on"
        self._state = None

    def reset(self, batch: int, height: int, width: int) -> None:
        model = self.model if self._spatial is None else self._spatial
        self._state = model.init_state(batch, height, width)

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
        model = self.model
        if self._spatial is not None:
            model = self._spatial
            batched = spatial.shard_package_spatial(batched,
                                                    self._spatial.mesh)
        if self.batched_decode:
            self._state, preds = model.forward_package_batched_decode(
                self._state, batched, **flags)
        else:
            self._state, preds = model.forward_package(
                self._state, batched, decode_keys=self.decode_keys, **flags)
        return {k: v[0].float().cpu().numpy() for k, v in preds.items()}

    @torch.inference_mode()
    def step_modality(self, x, modality: str = "events"):
        """Single-modality streaming (the events-only live path): one
        encoder sweep and one decode.  x: [H, W, C] unbatched -> [H, W, 1]
        float32, a numpy array for a numpy input, else a tensor on the
        model's device.  StateNet's modalities only: ERGB2Depth has
        none."""
        if not hasattr(self.model, "statenetphasedrecurrent"):
            raise ValueError(f"{type(self.model).__name__} has no modality "
                             "branches to stream one at a time")
        net = self.model.statenetphasedrecurrent
        as_numpy = isinstance(x, np.ndarray)
        xt = _as_input(x, self.model.device)[None]
        if self._state is None:
            self.reset(1, xt.shape[1], xt.shape[2])
        if self._spatial is not None:
            pred = self._spatial_modality(xt, modality)
            return pred.cpu().numpy() if as_numpy else pred
        state = statenet.forward_modality(
            net, self.cfg, to_nchw(xt),
            statenet.map_state(to_nchw, self._state), modality)
        self._state = statenet.map_state(to_nhwc, state)
        pred = to_nhwc(statenet.forward_decoder_supers(
            net, self.cfg, statenet.decoder_view(self.cfg, state)))[0]
        return pred.cpu().numpy() if as_numpy else pred

    def _spatial_modality(self, xt: torch.Tensor, modality: str):
        """step_modality over the bands of a mesh of one data row: the
        [H, W, 1] map on the first band's device."""
        sm = self._spatial
        bands = spatial.shard_package_spatial({"image": xt}, sm.mesh)[0]
        state = spatial.forward_modality(
            sm.rows[0], sm.nets[0], self.cfg,
            [to_nchw(b["image"]) for b in bands],
            [statenet.map_state(to_nchw, s) for s in self._state[0]],
            modality, [None] * len(bands))
        self._state = [[statenet.map_state(to_nhwc, s) for s in state]]
        maps = sm.decode(0, [statenet.decoder_view(self.cfg, s)
                             for s in state])
        return spatial.gather_spatial([[to_nhwc(p) for p in maps]])[0]


def _resolve_precompute(cfg: ModelConfig, precompute_x: Optional[bool],
                        model=None) -> bool:
    """Tri-state precompute_x: None = auto (on for bf16 compute on the
    configs whose x side is state-independent, where the JAX package
    measured it faster), True forces (the model raises where the config
    does not support it), False is off.  Never for a model without the
    precomputed path (ERGB2Depth)."""
    if model is not None and not hasattr(model,
                                         "forward_sequence_precomputed"):
        return False
    if precompute_x is None:
        return (statenet.supports_x_precompute(cfg)
                and cfg.compute_dtype == "bfloat16")
    return bool(precompute_x)


def _chunk_forward(model: Model,
                   precompute_x: Optional[bool], decode_keys=None,
                   batched_decode: bool = True):
    """forward(state, seq) of the chunked engines, routed as JAX
    inference.py:197-212 and :263-274: with batched_decode, the
    precomputed path where ``_resolve_precompute`` takes it, else
    forward_sequence_batched_decode with the cells' kernels allowed only
    for fused_gru='on', the fused_decoder policy (K8) allowed, and the
    composed layers only for composed_decoder='on'; without
    batched_decode, forward_sequence (per-step decodes, no kernels).  A
    model without deferred decode (ERGB2Depth) takes forward_sequence."""
    cfg = model.cfg
    if batched_decode and _resolve_precompute(cfg, precompute_x, model):
        return lambda state, seq: model.forward_sequence_precomputed(
            state, seq, decode_keys=decode_keys)
    if batched_decode and hasattr(model, "forward_sequence_batched_decode"):
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


def _pinned(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """x as a tensor on the host, in pinned memory when ``device`` is a
    card (so that its copy there can be asynchronous)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if device.type == "cuda" else t


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return _pinned(x, device).to(device, non_blocking=True)


def _prefetched(load, args):
    """load(a) for each a of args in order, each the next one's load
    running on one host thread while the caller works on the current
    result."""
    args = list(args)
    if not args:
        return
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(load, args[0])
        for i in range(len(args)):
            res = fut.result()
            if i + 1 < len(args):
                fut = pool.submit(load, args[i + 1])
            yield res


def _lane_replicas(model: Model, n_lanes: int, mesh):
    """(replicas, mesh): without a mesh, [model] on a mesh of its device;
    with one, a replica per device of its data axis, which must divide
    the lanes evenly (JAX's check and message), and whose model axis must
    be 1."""
    if mesh is None:
        return [model], make_mesh(devices=[model.device])
    if mesh.shape[MODEL_AXIS] != 1:
        raise ValueError(
            "the lane engines take a mesh whose model axis is 1: JAX "
            "replicates the lanes' compute over a model axis, which buys "
            "nothing (ROADMAP queue 3); StreamingInference(spatial_mesh=) "
            "splits one stream's H over a model axis")
    n_data = mesh.shape[DATA_AXIS]
    if n_lanes % n_data:
        raise ValueError(
            f"n_lanes={n_lanes} must divide evenly over the mesh data "
            f"axis ({n_data} devices)")
    return replicate(model, mesh), mesh


def _gather_lanes(outs, dim: int = 0):
    """The replicas' {key: maps} joined in lane order on the first
    replica's device."""
    if len(outs) == 1:
        return outs[0]
    dev = outs[0][next(iter(outs[0]))].device
    return {k: torch.cat([o[k].to(dev) for o in outs], dim)
            for k in outs[0]}


class SequenceScanInference:
    """Whole-sequence inference, ``chunk`` packages per forward call.

    batched_decode: defer the chunk's decodes to one decoder pass over all
    chunk*(K+1) snapshots (the precomputed path or
    forward_sequence_batched_decode, ``_chunk_forward``); off by default,
    as in JAX, which runs forward_sequence: bit-identical to per-package
    streaming (``StreamingInference``)."""

    def __init__(self, model: Model, chunk: int = 32,
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
def run_chunked_streaming(dataset, model: Model,
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

    def load_chunk(task):
        s, t0 = task
        sub = dataset.datasets[s]
        items = [sub[i] for i in range(t0, min(t0 + chunk, sizes[s]))]
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
        return task, items, {k: _pinned(_pad_time(v, chunk), dev)
                             for k, v in arrs.items()}

    tasks = [(s, t0) for s in range(len(sizes))
             for t0 in range(0, sizes[s], chunk)]
    state, cur_seq = None, -1
    for (s, t0), items, arrs in _prefetched(load_chunk, tasks):
        if s != cur_seq:
            im = arrs["image"]
            state = model.init_state(1, im.shape[1], im.shape[2])
            cur_seq = s
        seq = {k: v.to(dev, non_blocking=True)[None] for k, v in arrs.items()}
        state, preds = fwd(state, seq)
        if on_prediction is not None:
            preds_np = {k: v.cpu().numpy() for k, v in preds.items()}
            for j, item in enumerate(items):
                on_prediction(int(starts[s] + t0 + j),
                              {k: v[j, 0] for k, v in preds_np.items()},
                              item, t0 + j)


class BatchedStreamingInference:
    """Lane-batched streaming: N independent sequences advance in lockstep,
    one ``forward_package`` at batch N per step, a per-lane reset mask
    zeroing a lane's whole state (encoder states included) at its sequence
    boundary.  Per-item outputs equal single-lane streaming's.  The flags
    as the JAX engine's: the cells' kernels (K5, K3, K4) only for
    ``cfg.fused_gru == 'on'``, the fused_decoder policy (K8) allowed, the
    composed layers only for ``cfg.composed_decoder == 'on'``.  mesh: the
    lanes over its data axis, a replica and a lane state per device
    (``_lane_replicas``); the maps come back in lane order."""

    def __init__(self, model: Model, n_lanes: int, height: int,
                 width: int, mesh=None):
        self.model = model
        self.replicas, self._lanes = _lane_replicas(model, n_lanes, mesh)
        per = n_lanes // len(self.replicas)
        self.states = [m.init_state(per, height, width)
                       for m in self.replicas]
        self._flags = dict(allow_fused=model.cfg.fused_gru == "on",
                           allow_fused_decoder=True,
                           allow_composed=model.cfg.composed_decoder == "on")

    @torch.inference_mode()
    def step(self, pkg, reset_mask) -> Dict[str, torch.Tensor]:
        """pkg: {'events': [N, K, H, W, C], 'image': [N, H, W, C], and for
        the phased regime 'times_events' [N, K] and 'times_image' [N]}
        (numpy or tensors); reset_mask: [N] bool -> {key: [N, H, W, 1]}
        float32 tensors on the model's device (the first replica's)."""
        lanes = Sharding(self._lanes, 0)
        shares = {k: lanes.put(v) for k, v in pkg.items()}
        shares["reset"] = lanes.put(torch.as_tensor(reset_mask,
                                                    dtype=torch.bool))
        outs = []
        for i, m in enumerate(self.replicas):
            self.states[i], preds = m.forward_package(
                self.states[i], {k: v[i] for k, v in shares.items()},
                **self._flags)
            outs.append(preds)
        return _gather_lanes(outs)


def _round_robin_lanes(dataset, n_lanes: int):
    """Distribute the sequences of ``dataset.datasets`` round-robin over
    lanes: lane_items[lane] = [(global_idx, seq_pos), ...], back to back.
    Returns (lane_items, starts, sizes)."""
    sizes = [len(d) for d in dataset.datasets]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int)
    lane_items: List[list] = [[] for _ in range(n_lanes)]
    for s, (start, size) in enumerate(zip(starts, sizes)):
        lane_items[s % n_lanes].extend((int(start + i), i)
                                       for i in range(size))
    return lane_items, starts, sizes


class _Lanes:
    """A dataset's sequences round-robin over n lanes, packed step by step:
    at step t lane l holds item t of its sequences back to back, reset
    where that item starts a sequence; a lane that ran dry holds a zero
    package under a standing reset."""

    def __init__(self, dataset, n_lanes: int, cfg: ModelConfig):
        self.dataset = dataset
        self.lane_items, self.starts, _ = _round_robin_lanes(dataset, n_lanes)
        self.max_len = max(map(len, self.lane_items), default=0)
        self.zero = {}
        if self.max_len:
            item0 = self.item(*next(li[0] for li in self.lane_items if li))
            fields = self.fields(item0)
            # the timestamps go with the packages in the phased regime only
            if not cfg.use_phased_arch:
                fields = {k: fields[k] for k in ("events", "image")}
            self.zero = {k: np.zeros_like(v) for k, v in fields.items()}

    def item(self, gidx: int, seq_pos: int):
        s = int(np.searchsorted(self.starts, gidx, side="right")) - 1
        return self.dataset.datasets[s][seq_pos]

    @staticmethod
    def fields(item):
        """A dataset item's package arrays: events [K, H, W, C], image
        [H, W, C], and where it has them times_events [K] and times_image
        (a float32 scalar)."""
        out = {"events": item["events"][0], "image": item["image"][0]}
        if "times_events" in item:
            out["times_events"] = np.atleast_1d(item["times_events"][0])
            out["times_image"] = np.float32(
                np.asarray(item["times_image"][0]).ravel()[0])
        return out

    def pack(self, t0: int, steps: int):
        """Steps t0 .. t0+steps-1: ({key: [steps, N, ...] numpy}, reset
        [steps, N] bool, [(step, lane, global_idx, seq_pos, item)] of the
        real items in (step, lane) order)."""
        n = len(self.lane_items)
        arrs = {k: np.empty((steps, n) + z.shape, z.dtype)
                for k, z in self.zero.items()}
        reset = np.ones((steps, n), bool)
        metas = []
        for j in range(steps):
            for lane, items in enumerate(self.lane_items):
                if t0 + j < len(items):
                    gidx, pos = items[t0 + j]
                    item = self.item(gidx, pos)
                    metas.append((j, lane, gidx, pos, item))
                    reset[j, lane] = pos == 0
                    fields = self.fields(item)
                    for k in arrs:
                        arrs[k][j, lane] = fields[k]
                else:
                    for k, z in self.zero.items():
                        arrs[k][j, lane] = z
        return arrs, reset, metas


def _hand_out(on_prediction, preds, metas) -> None:
    """on_prediction(global_idx, {key: [H, W, 1] numpy}, item, seq_pos)
    for each real item of a lane step or chunk; preds {key: [steps, N, H,
    W, 1]} tensors."""
    if on_prediction is None:
        return
    preds_np = {k: v.cpu().numpy() for k, v in preds.items()}
    for j, lane, gidx, pos, item in metas:
        on_prediction(gidx, {k: v[j, lane] for k, v in preds_np.items()},
                      item, pos)


@torch.inference_mode()
def run_batched_streaming(dataset, model: Model,
                          n_lanes: int = 4, on_prediction=None,
                          mesh=None) -> None:
    """Lane-batched streaming over a ConcatSequenceDataset-like ``dataset``
    (the contract of ``run_chunked_streaming``): the sequences go
    round-robin over ``n_lanes`` lanes, each lane streams its sequences
    back to back with a reset at every sequence boundary, one
    ``BatchedStreamingInference.step`` per step.  Per-item outputs equal
    single-lane streaming's.  on_prediction(global_idx, {key: [H, W, 1]
    numpy}, item, seq_pos) is called for every real item, steps in order
    and lanes in order within a step: not in dataset order, hence the
    global index.  mesh: the lanes over its data axis
    (``BatchedStreamingInference``)."""
    lanes = _Lanes(dataset, n_lanes, model.cfg)
    if not lanes.max_len:
        return
    engine = BatchedStreamingInference(model, n_lanes,
                                       *lanes.zero["image"].shape[:2],
                                       mesh=mesh)
    for arrs, reset, metas in _prefetched(lambda t: lanes.pack(t, 1),
                                          range(lanes.max_len)):
        preds = engine.step({k: v[0] for k, v in arrs.items()}, reset[0])
        _hand_out(on_prediction, {k: v[None] for k, v in preds.items()},
                  metas)


@torch.inference_mode()
def run_batched_chunked_streaming(dataset, model: Model,
                                  n_lanes: int = 8, chunk: int = 2,
                                  on_prediction=None, decode_keys=None,
                                  precompute_x: Optional[bool] = None,
                                  mesh=None) -> None:
    """Lane-batched and chunked offline streaming: the sequences go
    round-robin over ``n_lanes`` lanes (run_batched_streaming), and
    ``chunk`` steps of all lanes run per forward call, routed as
    run_chunked_streaming's (``_chunk_forward``: the precomputed path
    where ``_resolve_precompute`` takes it, else
    forward_sequence_batched_decode), with one decoder pass over all
    chunk*n_lanes*(K+1) maps.  Sequence boundaries fall mid-chunk, so a
    per-step, per-lane reset mask goes with the chunk ('reset' [N,
    chunk]); padded steps past a lane's last item stay reset.  The chunk
    buffers are [chunk, N, ...], loaded and pinned on one host thread
    while the device runs the previous chunk.  Per-item outputs equal
    single-lane streaming's (within float summation order with the x side
    precomputed).  on_prediction as run_batched_streaming's.  mesh: the
    lanes over its data axis, a replica, a lane state and its share of
    each chunk buffer (axis 1) per device (``_lane_replicas``)."""
    dk = tuple(decode_keys) if decode_keys else None
    replicas, mesh = _lane_replicas(model, n_lanes, mesh)
    lanes = Sharding(mesh, 1)
    fwds = [_chunk_forward(m, precompute_x, dk) for m in replicas]
    dev = model.device
    packed = _Lanes(dataset, n_lanes, model.cfg)
    if not packed.max_len:
        return

    def load_chunk(t0):
        arrs, reset, metas = packed.pack(t0, chunk)
        arrs["reset"] = reset
        return {k: _pinned(v, dev) for k, v in arrs.items()}, metas

    states = [m.init_state(n_lanes // len(replicas),
                           *packed.zero["image"].shape[:2]) for m in replicas]
    for arrs, metas in _prefetched(load_chunk,
                                   range(0, packed.max_len, chunk)):
        shares = {k: lanes.put(v) for k, v in arrs.items()}
        outs = []
        for i, fwd in enumerate(fwds):
            states[i], preds = fwd(states[i], {k: v[i].movedim(0, 1)
                                               for k, v in shares.items()})
            outs.append(preds)
        _hand_out(on_prediction, _gather_lanes(outs, 1), metas)

