"""ERGB2DepthRecurrent, the RAM-Net model (RAM_Net/model/model.py:114-219).

Counterpart of ``rpg_ramnet_tpu/models/model.py`` for the recipes that
``statenet`` ports.
A datapackage is {'events': [B, K, H, W, Ce], 'image': [B, H, W, Ci]}: K
event voxel grids, then one frame; in the phased regime also
'times_events' [B, K] and 'times_image' [B], the steps' timestamps.  The
recurrent state is a ``statenet.StateNetState`` of NHWC tensors.  All
public tensors are NHWC.

    forward_package                  one package, per-step decodes, full
                                     cells (K5 with allow_fused)
    forward_package_batched_decode   one package, full cells, its K+1
                                     decodes as one batched pass (the
                                     per-package streaming engine)
    forward_sequence_precomputed     a chunk of packages (inference):
                                     batched x side, sequential h side, one
                                     batched decode
    forward_sequence_batched_decode  a TBPTT window (training), or a chunk
                                     (inference, configs without x
                                     precompute): per-package state
                                     updates, optionally checkpointed and
                                     with the package's x side batched,
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
    x-side gates (gev: per-scale [B, K, gC, h, w]; gim: per-scale
    [B, gC, h, w]).  Returns the new supers and the decoder views of the
    supers after each step named in sel_keys."""
    snaps = []
    for k in range(loop):
        supers = statenet.combine_hside(net, cfg, supers,
                                        [g[:, k] for g in gev], "events",
                                        allow_fused=allow_fused)
        if f"events{k}" in sel_keys:
            snaps.append(statenet.supers_decoder_view(cfg, supers))
    supers = statenet.combine_hside(net, cfg, supers, gim, "image",
                                    allow_fused=allow_fused)
    if "image" in sel_keys:
        snaps.append(statenet.supers_decoder_view(cfg, supers))
    return supers, snaps


def _check_no_reset(pkg) -> None:
    if "reset" in pkg:
        raise NotImplementedError(
            "per-lane reset masks are not ported yet: ROADMAP queue 1, item "
            "14 (lane-batched streaming)")


def _package_steps(cfg: ModelConfig, pkg):
    """(key, NCHW input, modality, timestamps [B] or None) of a package's
    K event steps and its image step (model.py:99-118)."""
    times_ev = pkg.get("times_events") if cfg.use_phased_arch else None
    times_im = pkg.get("times_image") if cfg.use_phased_arch else None
    steps = [(f"events{k}", to_nchw(pkg["events"][:, k]), "events",
              None if times_ev is None else times_ev[:, k])
             for k in range(event_loop_range(cfg))]
    steps.append(("image", to_nchw(pkg["image"]), "image", times_im))
    return steps


def _package_snapshot_step(net, cfg: ModelConfig, state, pkg,
                           sel_keys: Sequence[str], allow_fused: bool = False):
    """One package of state updates with the whole cells per step (K event
    steps, then the image step; no decodes), returning the new state and
    the decoder views after each step in sel_keys, concatenated over the
    batch.  pkg: NHWC (timestamps for the phased regime); state
    NCHW-shaped.  allow_fused: let the fused_gru policy run the cells as
    kernels (K4, K3, K5)."""
    _check_no_reset(pkg)
    snaps = []
    for key, x, modality, t in _package_steps(cfg, pkg):
        state = statenet.forward_modality(net, cfg, x, state, modality,
                                          times=t, allow_fused=allow_fused)
        if key in sel_keys:
            snaps.append(statenet.decoder_view(cfg, state))
    return state, _stack(snaps)


def _package_snapshot_step_pre(net, cfg: ModelConfig, state, pkg,
                               sel_keys: Sequence[str],
                               allow_fused: bool = False):
    """_package_snapshot_step with the package's x side batched: the K
    event encoder sweeps and x-side gate convs run as one (B*K)-deep pass
    (state-independent for recurrent_block_type='conv'), leaving only the
    K+1 h-side cells sequential; gx memory stays bounded to one package.
    allow_fused: let the fused_gru policy pick the h-side kernels, which
    are differentiable for the ConvGRU (ops/gru_hside.py::ConvGRUHside)."""
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
    supers, snaps = _hside_package(net, cfg, state.super_states, gx_ev,
                                   gx_im, sel_keys, loop,
                                   allow_fused=allow_fused)
    return state._replace(super_states=supers), _stack(snaps)


# the per-package entries of a sequence dict, [B, L, ...] each
_SEQ_KEYS = ("events", "image", "times_events", "times_image")


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
                   ) -> statenet.StateNetState:
        return statenet.init_state(self.cfg, batch, height, width,
                                   statenet.compute_dtype(self.cfg),
                                   self.device)

    def forward_package(self, state, pkg,
                        decode_keys: Optional[Sequence[str]] = None,
                        allow_fused: bool = False):
        """One datapackage: K event steps then the image step, decoding
        after every step (model.py:176-217), with the whole cells: the
        reference semantics.  decode_keys: decode only these keys (all
        when None); the recurrence is unchanged.  allow_fused: let the
        fused_gru policy run the cells as kernels K4, K3 and K5 (inference
        only).  Returns (state, {key: [B, H, W, 1]})."""
        _check_no_reset(pkg)
        net, cfg = self.statenetphasedrecurrent, self.cfg
        state = statenet.map_state(to_nchw, state)
        preds = {}
        for key, x, modality, t in _package_steps(cfg, pkg):
            state = statenet.forward_modality(net, cfg, x, state, modality,
                                              times=t, allow_fused=allow_fused)
            if decode_keys is None or key in decode_keys:
                preds[key] = to_nhwc(statenet.forward_decoder_supers(
                    net, cfg, statenet.decoder_view(cfg, state)))
        return statenet.map_state(to_nhwc, state), preds

    def forward_package_batched_decode(self, state, pkg,
                                       allow_fused: bool = False):
        """forward_package with the K+1 decodes of the package run as ONE
        decoder pass over the stacked per-step super states (model.py:
        291-314).  Decodes never feed the state, so the predictions equal
        forward_package's.  Returns (state, {key: [B, H, W, 1]})."""
        net, cfg = self.statenetphasedrecurrent, self.cfg
        keys = prediction_keys(cfg)
        b = pkg["image"].shape[0]
        state, snaps = _package_snapshot_step(
            net, cfg, statenet.map_state(to_nchw, state), pkg, keys,
            allow_fused)
        pred = to_nhwc(statenet.forward_decoder_supers(net, cfg, snaps))
        preds = {key: pred[i * b:(i + 1) * b] for i, key in enumerate(keys)}
        return statenet.map_state(to_nhwc, state), preds

    @torch.inference_mode()
    def forward_sequence_precomputed(self, state, seq,
                                     decode_keys: Optional[Sequence[str]] = None,
                                     chunk_cells: bool = False,
                                     stream_cells: bool = False):
        """L packages with the x side hoisted out of the recurrence
        (model.py:396-594, its scan branch), for the configs of
        statenet.supports_x_precompute:

          1. one batched pass of head, encoders and the state
             combination's x-side gate convs over all L*K event steps and
             L frames;
          2. the per-scale h-side completions (ConvGRU, or ConvLSTM with
             (hidden, cell) supers), step by step, through the fused_gru
             policy (ops/gru_hside.py: K1 or K3);
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
        if not statenet.supports_x_precompute(cfg):
            raise ValueError(
                "forward_sequence_precomputed requires recurrent_block_type="
                "'conv' and a convgru/convlstm state combination; got "
                f"{cfg.recurrent_block_type}/{cfg.state_combination}")
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
        state = statenet.map_state(to_nchw, state)
        supers = state.super_states
        snaps: List[Tuple[torch.Tensor, ...]] = []
        for t in range(l):
            supers, pkg_snaps = _hside_package(
                net, cfg, supers, [g[t] for g in gx_ev],
                [g[t] for g in gx_im], sel_keys, loop, allow_fused=True)
            snaps.extend(pkg_snaps)
        preds = _decode_snapshots(net, cfg, snaps, sel_keys, l, b)
        return statenet.map_state(
            to_nhwc, state._replace(super_states=supers)), preds

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
        cells with package_precompute, else the whole cells (K5, and the
        phased and ConvLSTM cells K4 and K3), which have no gradient (they
        raise under autograd).

        seq: {'events': [B, L, K, H, W, Ce], 'image': [B, L, H, W, Ci]},
        and in the phased regime 'times_events' [B, L, K] and
        'times_image' [B, L].  Returns (state, {key: [L, B, H, W, 1]}, or
        [L, B, H, W] when squeeze_preds)."""
        net, cfg = self.statenetphasedrecurrent, self.cfg
        sel_keys = [k for k in prediction_keys(cfg)
                    if decode_keys is None or k in decode_keys]
        if package_precompute and not statenet.supports_x_precompute(cfg):
            raise ValueError(
                "package_precompute requires recurrent_block_type='conv' and "
                "a convgru/convlstm state combination")
        if package_precompute:
            def step(state, pkg):
                return _package_snapshot_step_pre(net, cfg, state, pkg,
                                                  sel_keys, allow_fused)
        else:
            def step(state, pkg):
                return _package_snapshot_step(net, cfg, state, pkg, sel_keys,
                                              allow_fused)

        l, b = seq["image"].shape[1], seq["image"].shape[0]
        state = statenet.map_state(to_nchw, state)
        snaps = []
        for t in range(l):
            pkg = {k: seq[k][:, t] for k in _SEQ_KEYS if k in seq}
            if remat:
                state, stacked = checkpoint(step, state, pkg,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                state, stacked = step(state, pkg)
            snaps.append(stacked)
        preds = _decode_snapshots(net, cfg, snaps if sel_keys else [],
                                  sel_keys, l, b)
        if squeeze_preds:
            preds = {k: v[..., 0] for k, v in preds.items()}
        return statenet.map_state(to_nhwc, state), preds
