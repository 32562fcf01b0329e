"""ERGB2DepthRecurrent, the RAM-Net model (RAM_Net/model/model.py:114-219).

Counterpart of ``rpg_ramnet_tpu/models/model.py`` for the flagship recipe.
A datapackage is {'events': [B, K, H, W, Ce], 'image': [B, H, W, Ci]}: K
event voxel grids, then one frame.  The recurrent state is a tuple of
per-scale NHWC super states.  All public tensors are NHWC.

    forward_package                  one package, per-step decodes, full
                                     cells (K5 with allow_fused)
    forward_package_batched_decode   one package, full cells, its K+1
                                     decodes as one batched pass (the
                                     per-package streaming engine)
    forward_sequence_precomputed     a chunk of packages (inference):
                                     batched x side, sequential h side, one
                                     batched decode
    forward_sequence_batched_decode  a TBPTT window (training): per-package
                                     state updates, optionally checkpointed
                                     and with the package's x side batched,
                                     then one batched decode
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..core.config import ModelConfig
from ..utils.layout import to_nchw, to_nhwc
from . import statenet


def event_loop_range(cfg: ModelConfig) -> int:
    """Number of event sub-steps per datapackage (model/model.py:161-175);
    baselines are not ported, so it is every_x_rgb_frame."""
    return cfg.every_x_rgb_frame


def prediction_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    return (tuple(f"events{k}" for k in range(event_loop_range(cfg)))
            + ("image",))


def _hside_package(net, cfg: ModelConfig, supers, gev, gim,
                   sel_keys: Sequence[str], loop: int,
                   allow_fused: bool = False):
    """The sequential h-side completions of one package from precomputed
    x-side gates (gev: per-scale [B, K, 3C, h, w]; gim: per-scale
    [B, 3C, h, w]).  Returns the new supers and the per-scale supers after
    each step named in sel_keys."""
    snaps = []
    for k in range(loop):
        supers = statenet.combine_hside(net, cfg, supers,
                                        [g[:, k] for g in gev], "events",
                                        allow_fused=allow_fused)
        if f"events{k}" in sel_keys:
            snaps.append(supers)
    supers = statenet.combine_hside(net, cfg, supers, gim, "image",
                                    allow_fused=allow_fused)
    if "image" in sel_keys:
        snaps.append(supers)
    return supers, snaps


def _check_no_reset(pkg) -> None:
    if "reset" in pkg:
        raise NotImplementedError(
            "per-lane reset masks are not ported yet: ROADMAP queue 1, item "
            "14 (lane-batched streaming)")


def _package_snapshot_step(net, cfg: ModelConfig, supers, pkg,
                           sel_keys: Sequence[str], allow_fused: bool = False):
    """One package of state updates with the full ConvGRU cell per step
    (K event steps, then the image step; no decodes), returning the new
    supers and the supers after each step in sel_keys, concatenated over
    the batch.  pkg: {'events': [B, K, H, W, Ce], 'image': [B, H, W, Ci]}
    NHWC; supers NCHW-shaped.  allow_fused: let the fused_gru policy run
    the cells as kernel K5."""
    _check_no_reset(pkg)
    snaps = []
    for k in range(event_loop_range(cfg)):
        supers = statenet.forward_modality(net, cfg, to_nchw(pkg["events"][:, k]),
                                           supers, "events", allow_fused)
        if f"events{k}" in sel_keys:
            snaps.append(supers)
    supers = statenet.forward_modality(net, cfg, to_nchw(pkg["image"]), supers,
                                       "image", allow_fused)
    if "image" in sel_keys:
        snaps.append(supers)
    return supers, _stack(snaps)


def _package_snapshot_step_pre(net, cfg: ModelConfig, supers, pkg,
                               sel_keys: Sequence[str],
                               allow_fused: bool = False):
    """_package_snapshot_step with the package's x side batched: the K
    event encoder sweeps and x-side gate convs run as one (B*K)-deep pass
    (state-independent for recurrent_block_type='conv'), leaving only the
    K+1 h-side cells sequential; gx memory stays bounded to one package.
    allow_fused: let the fused_gru policy pick the h-side kernels, which
    are differentiable (ops/gru_hside.py::ConvGRUHside)."""
    loop = event_loop_range(cfg)
    ev = pkg["events"]                       # [B, K, H, W, Ce]
    b = ev.shape[0]
    ev_flat = to_nchw(ev.reshape((b * loop,) + ev.shape[2:]))
    gx_ev = [g.view((b, loop) + g.shape[1:])
             for g in statenet.gru_x_gates(
                 net, "events",
                 statenet.encoder_features(net, cfg, ev_flat, "events"))]
    gx_im = statenet.gru_x_gates(
        net, "image",
        statenet.encoder_features(net, cfg, to_nchw(pkg["image"]), "image"))
    supers, snaps = _hside_package(net, cfg, supers, gx_ev, gx_im, sel_keys,
                                   loop, allow_fused=allow_fused)
    return supers, _stack(snaps)


def _stack(snaps):
    """Per-scale concatenation over the batch of a list of snapshots."""
    return tuple(torch.cat(scale, dim=0) for scale in zip(*snaps))


def _decode_snapshots(net, cfg: ModelConfig, snaps, sel_keys: Sequence[str],
                      l: int, b: int) -> Dict[str, torch.Tensor]:
    """One decoder pass over all snapshots, ordered (package, key, batch),
    regrouped into per-key [L, B, H, W, 1] predictions."""
    if not snaps:
        return {}
    flat = _stack(snaps)
    pred = to_nhwc(statenet.forward_decoder_supers(net, cfg, flat))
    grouped = pred.reshape((l, len(sel_keys), b) + pred.shape[1:])
    return {key: grouped[:, i] for i, key in enumerate(sel_keys)}


class ERGB2DepthRecurrent(nn.Module):
    """RAM-Net.  Parameters live under ``statenetphasedrecurrent.`` with
    the upstream names, in float32 (the masters an optimizer updates) and
    channels_last memory, on ``device``; the layers compute in the
    config's compute dtype, casting the weights at use.  Random init
    (upstream's scheme) draws from ``generator``, or from a generator
    seeded 0."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            self.statenetphasedrecurrent = statenet.StateNet(cfg)
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.statenetphasedrecurrent.reset_parameters_(generator)
        self.to(device=device, memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_state(self, batch: int, height: int, width: int
                   ) -> Tuple[torch.Tensor, ...]:
        return statenet.init_state(self.cfg, batch, height, width,
                                   statenet.compute_dtype(self.cfg),
                                   self.device)

    def forward_package(self, state, pkg,
                        decode_keys: Optional[Sequence[str]] = None,
                        allow_fused: bool = False):
        """One datapackage: K event steps then the image step, decoding
        after every step (model.py:176-217), with the full ConvGRU cell on
        cat(x, h): the reference semantics.  decode_keys: decode only
        these keys (all when None); the recurrence is unchanged.
        allow_fused: let the fused_gru policy run the cells as kernel K5
        (inference only).  Returns (state, {key: [B, H, W, 1]})."""
        _check_no_reset(pkg)
        net, cfg = self.statenetphasedrecurrent, self.cfg
        supers = tuple(to_nchw(s) for s in state)
        preds = {}
        steps = [(f"events{k}", pkg["events"][:, k], "events")
                 for k in range(event_loop_range(cfg))]
        steps.append(("image", pkg["image"], "image"))
        for key, x, modality in steps:
            supers = statenet.forward_modality(net, cfg, to_nchw(x), supers,
                                               modality, allow_fused)
            if decode_keys is None or key in decode_keys:
                preds[key] = to_nhwc(
                    statenet.forward_decoder_supers(net, cfg, supers))
        return tuple(to_nhwc(s) for s in supers), preds

    def forward_package_batched_decode(self, state, pkg,
                                       allow_fused: bool = False):
        """forward_package with the K+1 decodes of the package run as ONE
        decoder pass over the stacked per-step super states (model.py:
        291-314).  Decodes never feed the state, so the predictions equal
        forward_package's.  Returns (state, {key: [B, H, W, 1]})."""
        net, cfg = self.statenetphasedrecurrent, self.cfg
        keys = prediction_keys(cfg)
        b = pkg["image"].shape[0]
        supers, snaps = _package_snapshot_step(
            net, cfg, tuple(to_nchw(s) for s in state), pkg, keys,
            allow_fused)
        pred = to_nhwc(statenet.forward_decoder_supers(net, cfg, snaps))
        preds = {key: pred[i * b:(i + 1) * b] for i, key in enumerate(keys)}
        return tuple(to_nhwc(s) for s in supers), preds

    @torch.inference_mode()
    def forward_sequence_precomputed(self, state, seq,
                                     decode_keys: Optional[Sequence[str]] = None,
                                     chunk_cells: bool = False,
                                     stream_cells: bool = False):
        """L packages with the x side hoisted out of the recurrence
        (model.py:396-594, its scan branch):

          1. one batched pass of head, encoders and ConvGRU x-side gate
             convs over all L*K event steps and L frames;
          2. the per-scale h-side completions, step by step, through the
             fused_gru policy (ops/gru_hside.py);
          3. one decoder pass over the snapshots of the selected keys.

        seq: {'events': [B, L, K, H, W, Ce], 'image': [B, L, H, W, Ci]}.
        decode_keys: decode only these of prediction_keys (all when None).
        Returns (state, {key: [L, B, H, W, 1]}).  Equals forward_package up
        to float summation order.
        """
        if chunk_cells:
            raise NotImplementedError(
                "chunk_cells (the whole-chunk resident-state kernel K11) is "
                "not ported yet: ROADMAP queue 2, K11")
        if stream_cells:
            raise NotImplementedError(
                "stream_cells (the gx-streaming cells K10) are not ported "
                "yet: ROADMAP queue 2, K10")
        net, cfg = self.statenetphasedrecurrent, self.cfg
        sel_keys = [k for k in prediction_keys(cfg)
                    if decode_keys is None or k in decode_keys]
        loop = event_loop_range(cfg)
        ev = seq["events"].movedim(1, 0)     # [L, B, K, H, W, Ce]
        im = seq["image"].movedim(1, 0)      # [L, B, H, W, Ci]
        l, b, kk = ev.shape[:3]
        if kk != loop:
            raise ValueError(f"events carry {kk} steps per package, the "
                             f"config {loop}")
        ev_flat = to_nchw(ev.reshape((l * b * loop,) + ev.shape[3:]))
        im_flat = to_nchw(im.reshape((l * b,) + im.shape[2:]))
        gx_ev = [g.view((l, b, loop) + g.shape[1:])
                 for g in statenet.gru_x_gates(
                     net, "events",
                     statenet.encoder_features(net, cfg, ev_flat, "events"))]
        gx_im = [g.view((l, b) + g.shape[1:])
                 for g in statenet.gru_x_gates(
                     net, "image",
                     statenet.encoder_features(net, cfg, im_flat, "image"))]
        supers = tuple(to_nchw(s) for s in state)
        snaps: List[Tuple[torch.Tensor, ...]] = []
        for t in range(l):
            supers, pkg_snaps = _hside_package(
                net, cfg, supers, [g[t] for g in gx_ev],
                [g[t] for g in gx_im], sel_keys, loop, allow_fused=True)
            snaps.extend(pkg_snaps)
        preds = _decode_snapshots(net, cfg, snaps, sel_keys, l, b)
        return tuple(to_nhwc(s) for s in supers), preds

    def forward_sequence_batched_decode(
            self, state, seq, decode_keys: Optional[Sequence[str]] = None,
            remat: bool = False, squeeze_preds: bool = False,
            package_precompute: bool = False, allow_fused: bool = False):
        """A window of L packages with every decode deferred
        (model.py:317-393): a loop over the packages runs only the state
        updates and keeps the snapshots of the selected keys, then ONE
        decoder pass runs over all L*S*B snapshots.  Predictions equal
        forward_package's: decodes never feed the state.  The training
        path (trainer.deferred_decode).

        remat: checkpoint each package (torch.utils.checkpoint,
        non-reentrant): its activations are recomputed in the backward, so
        each package's forward runs twice per step.
        package_precompute: batch each package's x side
        (_package_snapshot_step_pre; trainer.precompute_x).
        allow_fused: let the fused_gru policy pick the kernels: the h-side
        cells with package_precompute, else the whole cell K5, which has
        no gradient (it raises under autograd, as the JAX kernel has no
        VJP).

        seq: {'events': [B, L, K, H, W, Ce], 'image': [B, L, H, W, Ci]}.
        Returns (state, {key: [L, B, H, W, 1]}, or [L, B, H, W] when
        squeeze_preds)."""
        net, cfg = self.statenetphasedrecurrent, self.cfg
        sel_keys = [k for k in prediction_keys(cfg)
                    if decode_keys is None or k in decode_keys]
        if package_precompute:
            def step(supers, pkg):
                return _package_snapshot_step_pre(net, cfg, supers, pkg,
                                                  sel_keys, allow_fused)
        else:
            def step(supers, pkg):
                return _package_snapshot_step(net, cfg, supers, pkg, sel_keys,
                                              allow_fused)

        l, b = seq["image"].shape[1], seq["image"].shape[0]
        supers = tuple(to_nchw(s) for s in state)
        snaps = []
        for t in range(l):
            pkg = {"events": seq["events"][:, t], "image": seq["image"][:, t]}
            if remat:
                supers, stacked = checkpoint(step, supers, pkg,
                                             use_reentrant=False,
                                             preserve_rng_state=False)
            else:
                supers, stacked = step(supers, pkg)
            snaps.append(stacked)
        preds = _decode_snapshots(net, cfg, snaps if sel_keys else [],
                                  sel_keys, l, b)
        if squeeze_preds:
            preds = {k: v[..., 0] for k, v in preds.items()}
        return tuple(to_nhwc(s) for s in supers), preds
