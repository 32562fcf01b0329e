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
    forward_sequence                 L packages of forward_package: the
                                     chunked engines' in-scan route
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
from ..ops import gru_chunk, gru_hside, gru_stream
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
    are differentiable (ops/gru_hside.py::ConvGRUHside, ConvLSTMHside)."""
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


def _decode_flat(net, cfg: ModelConfig, flat, sel_keys: Sequence[str],
                 l: int, b: int, allow_fused_decoder: bool = False,
                 allow_composed: bool = False) -> Dict[str, torch.Tensor]:
    """One decoder pass over per-scale stacks of snapshots, ordered
    (package, key, batch), regrouped into per-key [L, B, H, W, 1]
    predictions.  allow_fused_decoder, allow_composed: let the
    fused_decoder and composed_decoder policies pick the decoder layers
    (statenet.forward_decoder_supers)."""
    pred = to_nhwc(statenet.forward_decoder_supers(
        net, cfg, flat, allow_fused=allow_fused_decoder,
        allow_composed=allow_composed))
    grouped = pred.reshape((l, len(sel_keys), b) + pred.shape[1:])
    return {key: grouped[:, i] for i, key in enumerate(sel_keys)}


def _decode_snapshots(net, cfg: ModelConfig, snaps, sel_keys: Sequence[str],
                      l: int, b: int, allow_fused_decoder: bool = False,
                      allow_composed: bool = False) -> Dict[str, torch.Tensor]:
    """_decode_flat of a list of per-step snapshots."""
    if not snaps:
        return {}
    return _decode_flat(net, cfg, _stack(snaps), sel_keys, l, b,
                        allow_fused_decoder, allow_composed)


def _steps_nhwc(g: torch.Tensor) -> torch.Tensor:
    """x-side gates [..., gC, h, w] (NCHW-shaped views) -> [..., h, w, gC]."""
    return g.movedim(-3, -1)


def _chunk_cells(net, cfg: ModelConfig, supers, gx_ev, gx_im,
                 sel_keys: Sequence[str], l: int, b: int, loop: int,
                 reset: bool):
    """forward_sequence_precomputed's chunk_cells branch (model.py:469-507):
    per scale, all l*(K+1) h-side steps in one launch of K11
    (ops/gru_chunk.py); the snapshots of sel_keys are gathered from the
    trajectory.  supers: NHWC.  Returns the new supers and the
    predictions."""
    if (cfg.state_combination != "convgru" or b != 1 or reset
            or not all(gru_chunk.supports(s) for s in supers)):
        raise ValueError(
            "chunk_cells requires convgru state combination, batch 1, no "
            "reset mask, and bf16 super states within the kernel's shared "
            "memory")
    sel_pos = [loop if k == "image" else int(k[len("events"):])
               for k in sel_keys]
    combs_ev, combs_im = (net.branch(m)[2] for m in ("events", "image"))
    new_supers, flat = [], []
    for i, h0 in enumerate(supers):
        gev = _steps_nhwc(gx_ev[i])[:, 0]            # [l, K, h, w, 3C]
        gim = _steps_nhwc(gx_im[i])[:, 0]            # [l, h, w, 3C]
        gseq = torch.cat([gev, gim[:, None]], dim=1).reshape(
            (l * (loop + 1),) + gev.shape[2:])
        snaps = gru_chunk.conv_gru_hside_chunk(
            combs_ev[i].recurrent_block.hside_weights(h0.dtype),
            combs_im[i].recurrent_block.hside_weights(h0.dtype), gseq,
            h0.contiguous(), K=loop)
        new_supers.append(snaps[-1:].clone())
        per_pkg = snaps.view((l, loop + 1) + snaps.shape[1:])
        if sel_pos != list(range(loop + 1)):
            per_pkg = per_pkg[:, sel_pos]
        flat.append(to_nchw(per_pkg.reshape((-1,) + snaps.shape[1:])))
    preds = (_decode_flat(net, cfg, tuple(flat), sel_keys, l, b, True, True)
             if sel_keys else {})
    return tuple(new_supers), preds


def _stream_cells(net, cfg: ModelConfig, supers, gx_ev, gx_im,
                  sel_keys: Sequence[str], l: int, b: int, loop: int,
                  reset: bool):
    """forward_sequence_precomputed's stream_cells branch (model.py:
    509-570): the per-step h-side cells read their gx blocks from the
    chunk's buffers by step index (K10a, ops/gru_stream.py), scales 0 and 1
    in one launch with fused_pair='on' (K10b); fused_gru is not read.
    supers: NHWC.  Returns the new supers and the predictions."""
    if (cfg.state_combination != "convgru" or b != 1 or reset
            or not all(gru_hside.supports(s) for s in supers)):
        raise ValueError(
            "stream_cells requires convgru state combination, batch 1, no "
            "reset mask, and fused-cell-supported (bf16, aligned) super "
            "states")
    combs_ev, combs_im = (net.branch(m)[2] for m in ("events", "image"))
    supers = tuple(s.contiguous() for s in supers)
    plans = [gru_stream.StreamPlan(
                 combs_ev[i].recurrent_block.hside_weights(h.dtype),
                 combs_im[i].recurrent_block.hside_weights(h.dtype),
                 _steps_nhwc(gx_ev[i]), _steps_nhwc(gx_im[i]), h)
             for i, h in enumerate(supers)]
    pair = cfg.fused_pair == "on" and len(plans) >= 2

    def one_step(supers, t, k):
        if pair:
            h0, h1 = gru_stream.stream_pair_step(plans[0], plans[1],
                                                 supers[0], supers[1], t, k)
            return (h0, h1) + tuple(p.step(h, t, k) for p, h in
                                    zip(plans[2:], supers[2:]))
        return tuple(p.step(h, t, k) for p, h in zip(plans, supers))

    snaps = []
    for t in range(l):
        for k in range(loop):
            supers = one_step(supers, t, k)
            if f"events{k}" in sel_keys:
                snaps.append(tuple(to_nchw(s) for s in supers))
        supers = one_step(supers, t, None)
        if "image" in sel_keys:
            snaps.append(tuple(to_nchw(s) for s in supers))
    return supers, _decode_snapshots(net, cfg, snaps, sel_keys, l, b, True,
                                     True)


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
                        allow_fused: bool = False,
                        allow_fused_decoder: bool = False,
                        allow_composed: bool = False):
        """One datapackage: K event steps then the image step, decoding
        after every step (model.py:176-217), with the whole cells: the
        reference semantics.  decode_keys: decode only these keys (all
        when None); the recurrence is unchanged.  allow_fused: let the
        fused_gru policy run the cells as kernels K4, K3 and K5 (K4 and K3
        differentiable through their Functions, K5 inference only).
        allow_fused_decoder, allow_composed: let the fused_decoder
        policy run decoder layers as kernel K8 (inference only) and the
        composed_decoder policy as the composed layers.  Returns (state,
        {key: [B, H, W, 1]})."""
        _check_no_reset(pkg)
        net, cfg = self.statenetphasedrecurrent, self.cfg
        state = statenet.map_state(to_nchw, state)
        preds = {}
        for key, x, modality, t in _package_steps(cfg, pkg):
            state = statenet.forward_modality(net, cfg, x, state, modality,
                                              times=t, allow_fused=allow_fused)
            if decode_keys is None or key in decode_keys:
                preds[key] = to_nhwc(statenet.forward_decoder_supers(
                    net, cfg, statenet.decoder_view(cfg, state),
                    allow_fused=allow_fused_decoder,
                    allow_composed=allow_composed))
        return statenet.map_state(to_nhwc, state), preds

    def forward_package_batched_decode(self, state, pkg,
                                       allow_fused: bool = False,
                                       allow_fused_decoder: bool = False,
                                       allow_composed: bool = False):
        """forward_package with the K+1 decodes of the package run as ONE
        decoder pass over the stacked per-step super states (model.py:
        291-314).  Decodes never feed the state, so the predictions equal
        forward_package's.  The flags as forward_package's.  Returns
        (state, {key: [B, H, W, 1]})."""
        net, cfg = self.statenetphasedrecurrent, self.cfg
        keys = prediction_keys(cfg)
        b = pkg["image"].shape[0]
        state, snaps = _package_snapshot_step(
            net, cfg, statenet.map_state(to_nchw, state), pkg, keys,
            allow_fused)
        pred = to_nhwc(statenet.forward_decoder_supers(
            net, cfg, snaps, allow_fused=allow_fused_decoder,
            allow_composed=allow_composed))
        preds = {key: pred[i * b:(i + 1) * b] for i, key in enumerate(keys)}
        return statenet.map_state(to_nhwc, state), preds

    def forward_sequence(self, state, seq,
                         decode_keys: Optional[Sequence[str]] = None):
        """L packages of forward_package in order, decoding after every
        step (model.py:597-636 for inference: no remat, no norm stats):
        the reference semantics, bit-identical to per-package streaming.
        seq: {'events': [B, L, K, H, W, Ce], 'image': [B, L, H, W, Ci]},
        and in the phased regime 'times_events' [B, L, K] and
        'times_image' [B, L].  Returns (state, {key: [L, B, H, W, 1]})."""
        _check_no_reset(seq)
        per_key: Dict[str, List[torch.Tensor]] = {}
        for t in range(seq["image"].shape[1]):
            pkg = {k: seq[k][:, t] for k in _SEQ_KEYS if k in seq}
            state, preds = self.forward_package(state, pkg, decode_keys)
            for k, v in preds.items():
                per_key.setdefault(k, []).append(v)
        return state, {k: torch.stack(v) for k, v in per_key.items()}

    @torch.inference_mode()
    def forward_sequence_precomputed(self, state, seq,
                                     decode_keys: Optional[Sequence[str]] = None,
                                     chunk_cells: bool = False,
                                     stream_cells: Optional[bool] = None):
        """L packages with the x side hoisted out of the recurrence
        (model.py:396-594), for the configs of
        statenet.supports_x_precompute:

          1. one batched pass of head, encoders and the state
             combination's x-side gate convs over all L*K event steps and
             L frames;
          2. the per-scale h-side completions (ConvGRU, or ConvLSTM with
             (hidden, cell) supers), in one of three launch structures:
             - chunk_cells: all L*(K+1) steps of a scale in one launch of
               the resident-state kernel K11 (ops/gru_chunk.py);
             - stream_cells (None: cfg.fused_stream == 'on'): per step,
               cells reading their gx blocks from the chunk's buffers by
               step index, K10a, or K10b for scales 0 and 1 with
               fused_pair='on' (ops/gru_stream.py);
             - else step by step through the fused_gru policy
               (statenet.combine_hside: K1, K9 with fused_pair='on', or
               K3);
             the first two raise ValueError unless the state combination
             is ConvGRU, the batch 1, no reset mask is given and the
             kernels take the super states;
          3. one decoder pass over the snapshots of the selected keys,
             K8 and the composed layers allowed (their policies decide),
             as JAX's three branches allow them.

        seq: {'events': [B, L, K, H, W, Ce], 'image': [B, L, H, W, Ci]}.
        decode_keys: decode only these of prediction_keys (all when None).
        Returns (state, {key: [L, B, H, W, 1]}).  Equals forward_package up
        to float summation order.
        """
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
        if stream_cells is None:
            stream_cells = cfg.fused_stream == "on"
        if chunk_cells or stream_cells:
            branch = _chunk_cells if chunk_cells else _stream_cells
            supers, preds = branch(net, cfg, state.super_states, gx_ev, gx_im,
                                   sel_keys, l, b, loop, "reset" in seq)
            return state._replace(super_states=supers), preds
        _check_no_reset(seq)
        state = statenet.map_state(to_nchw, state)
        supers = state.super_states
        snaps: List[Tuple[torch.Tensor, ...]] = []
        for t in range(l):
            supers, pkg_snaps = _hside_package(
                net, cfg, supers, [g[t] for g in gx_ev],
                [g[t] for g in gx_im], sel_keys, loop, allow_fused=True)
            snaps.extend(pkg_snaps)
        preds = _decode_snapshots(net, cfg, snaps, sel_keys, l, b, True, True)
        return statenet.map_state(
            to_nhwc, state._replace(super_states=supers)), preds

    def forward_sequence_batched_decode(
            self, state, seq, decode_keys: Optional[Sequence[str]] = None,
            remat: bool = False, squeeze_preds: bool = False,
            package_precompute: bool = False, allow_fused: bool = False,
            allow_fused_decoder: bool = False, allow_composed: bool = False):
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
        phased and ConvLSTM cells K4 and K3).  Under autograd the h-side
        and ConvLSTM cells run their Functions (K1-res, K3-res, K4-res);
        K5 has no gradient and raises, as the JAX kernel.
        allow_fused_decoder, allow_composed: the decode's flags, as
        forward_package's (K8 has no gradient; the composed layers do).

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
                                  sel_keys, l, b, allow_fused_decoder,
                                  allow_composed)
        if squeeze_preds:
            preds = {k: v[..., 0] for k, v in preds.items()}
        return statenet.map_state(to_nhwc, state), preds
