"""Spatial partitioning: single-stream inference with H split into row
bands over a mesh's model axis.

Counterpart of ``rpg_ramnet_tpu/parallel/spatial.py``.  JAX shards H of
the inputs and of the recurrent state over the mesh's 'model' axis and
lets GSPMD insert the convolutions' halo exchanges.  The port runs one row
band per device instead: the batch splits over the mesh's data axis, H
over its model axis, and band m of data row d lives on
``mesh.devices[d][m]`` with its own replica of the weights
(``band_replicas``).  The model's modules run in their order, and before
each one every band gets ``rows`` rows from its neighbours (``Bands.halo``):
the module runs unchanged on the band and its halo, so its own zero
padding, bilinear clamp or kernel border handling acts only at the global
top and bottom, and its output is cropped back to the band.  ``HALO`` is
the one table of those widths.  The kernels run per band on a band with
its halo: K5, K3 and K4 where the fused_gru policy takes them, K8 where
the fused_decoder policy does (JAX under fused_gru='on' runs its Pallas
kernel on the gathered array, with the same result: ROADMAP queue 3).

Two places are not pixel-local and take more than a halo:

- the phased encoders' time gates hold tau and phase per pixel: each band
  replica keeps its own rows of them, its halo rows included;
- the residual blocks' instance norm (norm 'IN') takes each instance's
  statistics over all of H x W: the bands add up their sums and sums of
  squares (one exchange per norm), then each normalizes its rows.  The
  Norm layers act pixel by pixel in inference (eval mode, on the running
  stats), as do BN, the skips and the 'sum' combination.

The band height H/M must be a multiple of 2**num_encoders, so that every
scale's band is whole and starts on an even row (``check_height``); JAX's
GSPMD pads uneven shards instead (ROADMAP queue 3).  Inference only: no
NormCtx and no autograd pass through the bands.

    shard_package_spatial(pkg, mesh)   a package's bands, [d][m] dicts
    shard_state_spatial(state, mesh)   a state's bands, [d][m] states
    gather_spatial(shards)             the bands joined on the first device
    SpatialModel(model, mesh)          init_state,
                                       forward_package(_batched_decode),
                                       decode
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..models import statenet
from ..models.layers import (NORM_EPS, PhasedConvLSTM, activate, conv,
                             upsample_conv_layer_fast)
from ..models.model import (ERGB2Depth, ERGB2DepthRecurrent, _apply_reset,
                            _package_steps, prediction_keys)
from ..utils.layout import to_nchw, to_nhwc
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, _share, replicate

# The halo of each kind of module: (rows taken from the neighbours on each
# side of a band, (up, down): output rows per input row), so the crop of an
# output is the rows taken times up / down.  A band at the global top or
# bottom takes nothing on that side; a band of fewer rows than asked takes
# them from further neighbours, down to the global edge.
HALO = {
    # the heads, ConvLayer 5x5 pad 2
    "head": (2, (1, 1)),
    # the strided encoders, 5x5 stride 2 pad 2 (the ConvLSTM and phased
    # encoders' convs too): an even halo keeps the stride-2 grid, and one
    # output row comes off each side
    "strided": (2, (1, 2)),
    # ConvGRU, plain or K5: z and r from one 3x3 conv, then a second 3x3
    # conv reads r*h
    "convgru": (2, (1, 1)),
    # ConvLSTM (combination or encoder cell), plain or K3: one 3x3 conv
    "convlstm": (1, (1, 1)),
    # PhasedConvLSTM, plain or K4: one 3x3 conv, then the per-pixel gate
    "phased_cell": (1, (1, 1)),
    # the 'conv' state combination, ConvLayer 5x5 pad 2 on cat(x, h)
    "conv_comb": (2, (1, 1)),
    # ResidualBlock, two 3x3 convs
    "resblock": (2, (1, 1)),
    # bilinear x2 then 5x5 conv (two-stage, composed, fast or K8): 2
    # low-res rows of x and of the skip, 4 high-res rows cropped
    "upsample_conv": (2, (2, 1)),
    # ConvTranspose 5x5 stride 2 pad 2 output_padding 1: high-res row y
    # reads low-res rows (y-2)/2 .. (y+2)/2, so 1 row, 2 high-res rows
    "transposed_conv": (1, (2, 1)),
    # the 'sum' combination, the skips, the 1x1 pred conv
    "pointwise": (0, (1, 1)),
}


def check_height(cfg: ModelConfig, bands: int, height: int) -> int:
    """The band height height / bands; ValueError unless it is a multiple
    of 2**num_encoders."""
    f = 2 ** cfg.num_encoders
    if height % bands or (height // bands) % f:
        raise ValueError(
            f"H={height} over {bands} bands: the band height H/M must be a "
            f"multiple of 2**num_encoders = {f}, so that every scale's band "
            "is whole and starts on an even row")
    return height // bands


def _taken(bands: int, height: int, rows: int) -> List[Tuple[int, int]]:
    return [(min(rows, m * height), min(rows, (bands - 1 - m) * height))
            for m in range(bands)]


def _crop(t: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    if not (top or bottom):
        return t
    return t[:, :, top:t.shape[2] - bottom].contiguous(
        memory_format=torch.channels_last)


class Bands:
    """The row bands of one data row of a mesh: band m on devices[m], each
    an NCHW-shaped tensor (or a tuple of them) of equal height."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)

    def __len__(self) -> int:
        return len(self.devices)

    def taken(self, height: int, rows: int) -> List[Tuple[int, int]]:
        """(rows above, rows below) each band takes for a halo of ``rows``
        on bands of ``height`` rows."""
        return _taken(len(self.devices), height, rows)

    def halo(self, bands: Sequence[torch.Tensor], rows: int
             ) -> List[torch.Tensor]:
        """Each band with ``rows`` rows of its neighbours above and below
        (``taken``), copied to its device."""
        h = bands[0].shape[2]
        out = []
        for m, ((top, bottom), dev) in enumerate(zip(self.taken(h, rows),
                                                     self.devices)):
            parts = []
            for k in range(m - 1, -1, -1):          # rows above, nearest last
                if top <= 0:
                    break
                take = min(top, h)
                parts.insert(0, bands[k][:, :, h - take:])
                top -= take
            parts.append(bands[m])
            for k in range(m + 1, len(bands)):
                if bottom <= 0:
                    break
                take = min(bottom, h)
                parts.append(bands[k][:, :, :take])
                bottom -= take
            if len(parts) == 1:
                out.append(bands[m])
                continue
            out.append(torch.cat([p.to(dev, non_blocking=True)
                                  for p in parts], dim=2).contiguous(
                memory_format=torch.channels_last))
        return out

    def run(self, kind: str, fn, *inputs):
        """fn(m, *band m's inputs with their halo) for each band m (inputs:
        per-band lists of tensors or of tuples of them), each output (a
        tensor or nested tuples) cropped back to the band: the module of
        ``kind`` (``HALO``) over the bands."""
        rows, (up, down) = HALO[kind]
        leaf = inputs[0][0]
        while not isinstance(leaf, torch.Tensor):
            leaf = leaf[0]
        taken = self.taken(leaf.shape[2], rows)
        haloed = [self._halo_tree(x, rows) for x in inputs]
        outs = []
        for m, (top, bottom) in enumerate(taken):
            if (top * up) % down or (bottom * up) % down:
                raise ValueError(f"{kind}: a halo of {top}, {bottom} rows "
                                 f"is off the stride-{down} grid")
            y = fn(m, *(h[m] for h in haloed))
            outs.append(statenet.map_state(
                lambda t: _crop(t, top * up // down, bottom * up // down), y))
        return outs

    def _halo_tree(self, bands, rows: int):
        if rows == 0:
            return list(bands)
        if isinstance(bands[0], torch.Tensor):
            return self.halo(bands, rows)
        parts = [self._halo_tree([b[i] for b in bands], rows)
                 for i in range(len(bands[0]))]
        return [type(bands[0])(p[m] for p in parts) for m in range(len(bands))]

    def instance_norm(self, ys: Sequence[torch.Tensor],
                      taken: Sequence[Tuple[int, int]], height: int
                      ) -> List[torch.Tensor]:
        """``layers.instance_norm_plain`` of the column of bands: each
        instance's statistics over every band's own ``height`` rows (band
        m's start after taken[m][0] halo rows), from one exchange of the
        float64 sums and sums of squares added up on the first device;
        then each band, halo rows included, normalized by them."""
        dev0 = self.devices[0]
        own = [y[:, :, t:t + height].double()
               for y, (t, _) in zip(ys, taken)]
        s = sum(o.sum((2, 3)).to(dev0) for o in own)
        q = sum(o.square().sum((2, 3)).to(dev0) for o in own)
        n = height * len(ys) * ys[0].shape[3]
        mean = s / n
        var = (q / n - mean.square()).clamp_min(0.0)
        out = []
        for y, dev in zip(ys, self.devices):
            m = mean.to(dev).float()[..., None, None]
            v = var.to(dev).float()[..., None, None]
            out.append(((y.float() - m) * torch.rsqrt(v + NORM_EPS))
                       .to(y.dtype))
        return out


def _narrow_phased_gates(net: nn.Module, band: int, bands: int) -> None:
    """Cut the phased encoders' per-pixel tau and phase of ``net`` to band
    ``band``'s rows of each scale with the halo rows its cell takes
    (``HALO['phased_cell']``), and set each cell's height to match."""
    rows = HALO["phased_cell"][0]
    for enc in net.modules():
        if not isinstance(enc, PhasedConvLSTM):
            continue
        c = enc.lstm.hidden_size
        h = enc.height // bands
        top, bottom = _taken(bands, h, rows)[band]
        r0, r1 = band * h - top, (band + 1) * h + bottom
        gate = enc.phased_cell
        with torch.no_grad():
            for name in ("tau", "phase"):
                v = getattr(gate, name).view(c, enc.height, enc.width)
                setattr(gate, name, nn.Parameter(
                    v[:, r0:r1].reshape(-1).clone()))
        gate._cache = None
        enc.height = r1 - r0


def band_replicas(model, mesh: Mesh) -> List[List]:
    """One replica of ``model`` per device of ``mesh``, [data][model]
    (``mesh.replicate``), the phased encoders' gates of each cut to its
    band's rows (the model's spatial_resolution split over the model
    axis)."""
    if not isinstance(model, (ERGB2DepthRecurrent, ERGB2Depth)):
        raise ValueError(f"spatial partitioning runs ERGB2DepthRecurrent "
                         f"and ERGB2Depth, not {type(model).__name__}")
    reps = replicate(model, mesh)
    if mesh.shape[MODEL_AXIS] == 1:
        reps = [[r] for r in reps]
    if statenet.is_phased(model.cfg):
        check_height(model.cfg, mesh.shape[MODEL_AXIS],
                     model.cfg.spatial_resolution[0])
        for row in reps:
            for m, r in enumerate(row):
                _narrow_phased_gates(r.statenetphasedrecurrent, m, len(row))
    return reps


# the H dim of a package's NHWC entries; the others split on the batch only
_PKG_H_DIM = {"events": 2, "image": 1}


def _band(x, mesh: Mesh, d: int, m: int, h_dim: Optional[int]
          ) -> torch.Tensor:
    """Data row d's share of x's batch, its band m on h_dim (the whole
    share when None), on mesh.devices[d][m]."""
    x = _share(torch.as_tensor(x), d, mesh.shape[DATA_AXIS], 0)
    if h_dim is not None:
        x = _share(x, m, mesh.shape[MODEL_AXIS], h_dim)
    return x.to(mesh.devices[d][m], non_blocking=True)


def shard_package_spatial(pkg, mesh: Mesh) -> List[List[Dict]]:
    """A package {'events': [B, K, H, W, C], 'image': [B, H, W, C], and
    optionally 'times_events' [B, K], 'times_image' [B], 'reset' [B]}
    (numpy or tensors) as [d][m] band dicts: the batch over the data
    axis, H over the model axis, the rest whole on each band."""
    return [[{k: _band(v, mesh, d, m, _PKG_H_DIM.get(k))
              for k, v in pkg.items()} for m in range(len(row))]
            for d, row in enumerate(mesh.devices)]


def shard_state_spatial(state, mesh: Mesh) -> List[List]:
    """A recurrent state (NHWC [B, h, w, c] leaves) as [d][m] band states:
    the batch over the data axis, h over the model axis."""
    return [[statenet.map_state(lambda x: _band(x, mesh, d, m, 1), state)
             for m in range(len(row))]
            for d, row in enumerate(mesh.devices)]


def gather_spatial(shards):
    """[d][m] bands (NHWC tensors, or dicts or states of them) joined: the
    bands of a data row on H (dim 1), the rows on the batch, on the first
    band's device."""
    first = shards[0][0]
    if isinstance(first, dict):
        return {k: gather_spatial([[b[k] for b in row] for row in shards])
                for k in first}
    if isinstance(first, torch.Tensor):
        dev = first.device
        rows = [torch.cat([b.to(dev) for b in row], dim=1) for row in shards]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]
    parts = [gather_spatial([[b[i] for b in row] for row in shards])
             for i in range(len(first))]
    return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)


def _transpose(per_band: Sequence[Sequence]) -> List[List]:
    """[m][i] -> [i][m]."""
    return [list(col) for col in zip(*per_band)]


def forward_modality(bands: Bands, nets: Sequence[statenet.StateNet],
                     cfg: ModelConfig, x: Sequence[torch.Tensor],
                     states: Sequence[statenet.StateNetState], modality: str,
                     times: Sequence[Optional[torch.Tensor]],
                     allow_fused: bool = False
                     ) -> List[statenet.StateNetState]:
    """``statenet.forward_modality`` over the bands: NCHW-shaped per-band
    inputs and states (times: per band, [B] or None) -> the new per-band
    states, the modules in that function's order and routing."""
    branch = [n.branch(modality) for n in nets]
    dt = statenet.compute_dtype(cfg)
    x = bands.run("head", lambda m, xb: branch[m][0](xb.to(dt)), x)
    enc_states = [(s.events if modality == "events" else s.image).encoders
                  for s in states]
    comb_kind = {"conv": "conv_comb", "sum": "pointwise",
                 "convlstm": "convlstm", "convgru": "convgru"}[
        cfg.state_combination]
    recurrent = cfg.recurrent_block_type == "convlstm"
    supers, enc_new = [], []
    for i in range(cfg.num_encoders):
        encs = [b[1][i] for b in branch]
        if recurrent:
            x = bands.run("strided", lambda m, xb: encs[m].conv(xb), x)
            st = [e[i] for e in enc_states]
            if statenet.is_phased(cfg):
                t = [tm if tm is not None else torch.zeros(
                    xb.shape[0], device=xb.device) for tm, xb in zip(times, x)]

                def cell(m, xb, sb):
                    fuse = allow_fused and statenet.use_fused_cell(
                        cfg, sb[0], "lstm")
                    return encs[m].recurrent_block(xb, t[m], sb, fused=fuse)

                out = bands.run("phased_cell", cell, x, st)
                x, new = [o[0] for o in out], [o[1] for o in out]
            else:
                new = bands.run("convlstm", lambda m, xb, sb:
                                encs[m].recurrent_block(xb, sb), x, st)
                x = [s[0] for s in new]
            enc_new.append(new)
        else:
            x = bands.run("strided", lambda m, xb: encs[m](xb), x)
        prev = [s.super_states[i] for s in states]
        combs = [b[2][i] if len(b[2]) else None for b in branch]
        sup = bands.run(comb_kind, lambda m, xb, pb: statenet._combine(
            cfg, combs[m], xb, pb, allow_fused, None), x, prev)
        supers.append(sup)
        if cfg.is_baseline:
            x = sup
    out = []
    for m, s in enumerate(states):
        s = s._replace(super_states=tuple(sc[m] for sc in supers))
        if recurrent:
            s = s._replace(**{modality: statenet.ModalityState(
                tuple(e[m] for e in enc_new))})
        out.append(s)
    return out


def _resblock(bands: Bands, blocks, x: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """``ResidualBlock`` over the bands (``HALO['resblock']``); under IN
    its two instance norms take the column's statistics
    (``Bands.instance_norm``)."""
    if blocks[0].norm != "IN":
        return bands.run("resblock", lambda m, xb: blocks[m](xb), x)
    rows = HALO["resblock"][0]
    h = x[0].shape[2]
    taken = bands.taken(h, rows)
    xh = bands.halo(x, rows)
    y = [conv(b.conv1, t) for b, t in zip(blocks, xh)]
    y = [torch.relu(t) for t in bands.instance_norm(y, taken, h)]
    y = [_crop(conv(b.conv2, t), *tk) for b, t, tk in zip(blocks, y, taken)]
    y = bands.instance_norm(y, [(0, 0)] * len(y), h)
    return [torch.relu(t + xb) for t, xb in zip(y, x)]


def decode(bands: Bands, nets: Sequence[statenet.StateNet],
           cfg: ModelConfig, supers: Sequence[Sequence[torch.Tensor]],
           allow_fused: bool = False, allow_composed: bool = False
           ) -> List[torch.Tensor]:
    """``statenet.forward_decoder_supers`` over the bands: per band the
    per-scale hidden states (NCHW-shaped) -> per band the float32 maps
    [N, 1, h, W], each decoder layer routed by
    ``statenet.decode_layer``."""
    scales = _transpose(supers)
    x = scales[-1]
    for r in range(len(nets[0].resblocks)):
        x = _resblock(bands, [net.resblocks[r] for net in nets], x)
    n = cfg.num_encoders
    kind = "upsample_conv" if cfg.use_upsample_conv else "transposed_conv"
    for i in range(len(nets[0].decoders)):
        decs = [net.decoders[i] for net in nets]
        if i == 0:
            x = bands.run(kind, lambda m, xb: statenet.decode_layer(
                cfg, decs[m], xb, None, allow_fused, allow_composed), x)
        else:
            x = bands.run(kind, lambda m, xb, sb: statenet.decode_layer(
                cfg, decs[m], xb, sb, allow_fused, allow_composed),
                x, scales[n - i - 1])
    return [activate(net.pred(xb).float(), cfg.activation)
            for net, xb in zip(nets, x)]


def unet_forward(bands: Bands, nets: Sequence[nn.Module], cfg: ModelConfig,
                 x: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``unet.forward`` (ERGB2Depth) over the bands: per-band NCHW-shaped
    inputs -> per-band float32 maps [N, 1, h, W]."""
    dt = statenet.compute_dtype(cfg)
    x = bands.run("head", lambda m, xb: nets[m].head(xb.to(dt)), x)
    head, blocks = x, []
    for i in range(len(nets[0].encoders)):
        x = bands.run("strided", lambda m, xb: nets[m].encoders[i](xb), x)
        blocks.append(x)
    for r in range(len(nets[0].resblocks)):
        x = _resblock(bands, [net.resblocks[r] for net in nets], x)
    kind = "upsample_conv" if cfg.use_upsample_conv else "transposed_conv"
    fast = cfg.use_upsample_conv and cfg.fast_upsample
    for i in range(len(nets[0].decoders)):
        def layer(m, xb, sb):
            dec = nets[m].decoders[i]
            xb = statenet.apply_skip(cfg, xb, sb)
            return upsample_conv_layer_fast(dec, xb) if fast else dec(xb)
        x = bands.run(kind, layer, x, blocks[-1 - i])
    return [activate(net.pred(statenet.apply_skip(cfg, xb, hb)).float(),
                     cfg.activation) for net, xb, hb in zip(nets, x, head)]


class SpatialModel:
    """An ERGB2DepthRecurrent (or the stateless ERGB2Depth) over a mesh
    with H split into row bands: the batch over the data axis, H over the
    model axis, one replica of the weights per band (``band_replicas``).
    States and packages are [d][m] bands (``shard_state_spatial``,
    ``shard_package_spatial``); the predictions come back joined
    (``gather_spatial``).  Inference only: call under no_grad or
    inference_mode."""

    def __init__(self, model, mesh: Mesh):
        self.model = model
        self.cfg = model.cfg
        self.mesh = mesh
        self.stateless = isinstance(model, ERGB2Depth)
        self.rows = [Bands(row) for row in mesh.devices]
        self.nets = [[r.unet if self.stateless else r.statenetphasedrecurrent
                      for r in row] for row in band_replicas(model, mesh)]

    def init_state(self, batch: int, height: int, width: int) -> List[List]:
        """The zero state's [d][m] bands (empty tuples for ERGB2Depth)."""
        check_height(self.cfg, self.mesh.shape[MODEL_AXIS], height)
        return shard_state_spatial(
            self.model.init_state(batch, height, width), self.mesh)

    def _steps(self, d: int, states, pkgs, allow_fused: bool, on_step):
        """One package's K+1 modality steps on data row d: (new per-band
        NCHW states); on_step(key, states) after each step."""
        bands, nets = self.rows[d], self.nets[d]
        check_height(self.cfg, len(bands),
                     pkgs[0]["image"].shape[1] * len(bands))
        st = [statenet.map_state(to_nchw, _apply_reset(p.get("reset"), s))
              for s, p in zip(states, pkgs)]
        steps = [_package_steps(self.cfg, p) for p in pkgs]
        for j, (key, _, modality, _) in enumerate(steps[0]):
            st = forward_modality(bands, nets, self.cfg,
                                  [s[j][1] for s in steps], st, modality,
                                  [s[j][3] for s in steps], allow_fused)
            on_step(key, st)
        return st

    def forward_package(self, states, pkgs,
                        decode_keys: Optional[Sequence[str]] = None,
                        allow_fused: bool = False,
                        allow_fused_decoder: bool = False,
                        allow_composed: bool = False):
        """``ERGB2DepthRecurrent.forward_package`` (``ERGB2Depth``'s: the
        'image' map alone, the flags moot) over the bands: (new [d][m]
        NHWC states, {key: [B, H, W, 1]} joined on the first device)."""
        if self.stateless:
            return states, gather_spatial([
                [{"image": to_nhwc(p)} for p in unet_forward(
                    self.rows[d], self.nets[d], self.cfg,
                    [to_nchw(b["image"]) for b in pkgs[d]])]
                for d in range(len(self.rows))])
        new, preds = [], []
        for d in range(len(self.rows)):
            out: Dict[str, List[torch.Tensor]] = {}

            def on_step(key, st, d=d, out=out):
                if decode_keys is None or key in decode_keys:
                    out[key] = [to_nhwc(p) for p in self.decode(
                        d, [statenet.decoder_view(self.cfg, s) for s in st],
                        allow_fused_decoder, allow_composed)]

            st = self._steps(d, states[d], pkgs[d], allow_fused, on_step)
            new.append([statenet.map_state(to_nhwc, s) for s in st])
            preds.append([{k: v[m] for k, v in out.items()}
                          for m in range(len(st))])
        return new, gather_spatial(preds)

    def forward_package_batched_decode(self, states, pkgs,
                                       allow_fused: bool = False,
                                       allow_fused_decoder: bool = False,
                                       allow_composed: bool = False):
        """``ERGB2DepthRecurrent.forward_package_batched_decode`` over the
        bands: the K+1 decodes of the package as one banded decoder pass
        over the stacked per-step states."""
        keys = prediction_keys(self.cfg)
        new, preds = [], []
        for d in range(len(self.rows)):
            snaps = []
            st = self._steps(d, states[d], pkgs[d], allow_fused,
                             lambda key, st: snaps.append(
                                 [statenet.decoder_view(self.cfg, s)
                                  for s in st]))
            stacked = [tuple(torch.cat(scale, dim=0) for scale in
                             zip(*(snap[m] for snap in snaps)))
                       for m in range(len(st))]
            maps = self.decode(d, stacked, allow_fused_decoder,
                               allow_composed)
            b = maps[0].shape[0] // len(keys)
            new.append([statenet.map_state(to_nhwc, s) for s in st])
            preds.append([{k: to_nhwc(p[i * b:(i + 1) * b])
                           for i, k in enumerate(keys)} for p in maps])
        return new, gather_spatial(preds)

    def decode(self, d: int, supers, allow_fused: bool = False,
               allow_composed: bool = False) -> List[torch.Tensor]:
        """The decoder on data row d's per-band per-scale states ->
        per-band float32 maps [N, 1, h, W]."""
        return decode(self.rows[d], self.nets[d], self.cfg, supers,
                      allow_fused, allow_composed)
