"""Analytic FLOP and byte accounting for MFU and roofline numbers.

Counterpart of ``rpg_ramnet_tpu/utils/costs.py``, with the same arithmetic
in the same order.  Walks the model config (every conv shape is static)
and counts MAC-based FLOPs (2 per multiply-add) plus a *minimum* HBM byte
estimate for one datapackage (K event sweeps + 1 image sweep, each
followed by a decoder pass, reference model/model.py:176-217) and for one
TBPTT training window.

Conventions, kept from the JAX package so that both count the same work:
the head is counted at max(num_bins_events, num_bins_rgb) input channels;
a convgru state combination is three 3x3 gate convs on 2*C inputs; the
bilinear 2x upsample costs 8 FLOPs a pixel; a conv's backward is 2x its
forward, and remat adds one more forward.  The byte model is a lower
bound: each conv reads its input once and writes its output once
(elementwise work, norms and activations fused into the producing conv);
parameters are counted once per program invocation, recurrent state reads
and writes explicitly.

Peaks are the card's (``device_peaks``); MFU is reported against the dense
bf16 peak with the compute dtype noted.  ``counted_costs`` counts a
callable's FLOPs with torch's own counter instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# (dense bf16 peak FLOP/s, HBM B/s, HBM GiB) per device-name substring:
# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column (its bf16 figure,
# 1979 TFLOP/s, is with sparsity; dense is half)
_DEVICE_PEAKS = {
    "h100 80gb hbm3": (989e12, 3.35e12, 80),
}


def device_peaks(kind: str) -> Tuple[float, float, float]:
    """(dense bf16 FLOP/s, HBM bytes/s, HBM GiB) of the card whose name
    (``torch.cuda.get_device_name()``) holds ``kind``'s key; ValueError for
    a card not in the table."""
    k = kind.lower()
    for sub, peaks in _DEVICE_PEAKS.items():
        if sub in k:
            return peaks
    raise ValueError(f"no peaks known for device {kind!r}; known: "
                     f"{sorted(_DEVICE_PEAKS)}")


@dataclass
class Costs:
    flops: float = 0.0        # multiply-adds x2
    bytes_min: float = 0.0    # lower-bound HBM traffic (activations + state)
    param_bytes: float = 0.0  # parameter reads, once per program invocation

    def __iadd__(self, o: "Costs"):
        self.flops += o.flops
        self.bytes_min += o.bytes_min
        self.param_bytes += o.param_bytes
        return self


def _conv(b, h, w, cin, cout, k, act_bytes=4):
    """One conv application: FLOPs and min bytes (read in + write out)."""
    return Costs(
        flops=2.0 * b * h * w * cin * cout * k * k,
        bytes_min=float(b * h * w * (cin + cout)) * act_bytes,
        param_bytes=float(cin * cout * k * k) * 4,
    )


def modality_sweep_costs(cfg, H: int, W: int, batch: int = 1,
                         act_bytes: int = 4) -> Costs:
    """One encoder sweep (head + strided encoders + per-scale state
    combination), reference statenet.py:204-288."""
    c = Costs()
    nb = cfg.base_num_channels
    # head 5x5 (num_bins -> nb), at the larger of the two inputs
    c += _conv(batch, H, W, max(cfg.num_bins_events, cfg.num_bins_rgb), nb, 5,
               act_bytes)
    for i, (cin, cout) in enumerate(zip(cfg.encoder_input_sizes,
                                        cfg.encoder_output_sizes)):
        h, w = H // (2 ** (i + 1)), W // (2 ** (i + 1))
        # stride-2 5x5 encoder conv
        c += _conv(batch, h, w, cin, cout, 5, act_bytes)
        if cfg.state_combination == "convgru":
            # 3 gate convs 3x3 on cat(x, state): cin = 2*cout
            for _ in range(3):
                c += _conv(batch, h, w, 2 * cout, cout, 3, act_bytes)
            # state read + write per scale
            c.bytes_min += 2.0 * batch * h * w * cout * act_bytes
        elif cfg.state_combination == "convlstm":
            c += _conv(batch, h, w, 2 * cout, 4 * cout, 3, act_bytes)
            c.bytes_min += 4.0 * batch * h * w * cout * act_bytes  # (h, c) rw
        elif cfg.state_combination == "conv":
            c += _conv(batch, h, w, 2 * cout, cout, 5, act_bytes)
            c.bytes_min += 2.0 * batch * h * w * cout * act_bytes
    return c


def decoder_costs(cfg, H: int, W: int, batch: int = 1,
                  act_bytes: int = 4) -> Costs:
    """One decoder pass (resblocks + upsample convs + 1x1 pred), reference
    statenet.py:290-315."""
    c = Costs()
    top = cfg.max_num_channels
    h, w = H // (2 ** cfg.num_encoders), W // (2 ** cfg.num_encoders)
    for _ in range(cfg.num_residual_blocks):
        c += _conv(batch, h, w, top, top, 3, act_bytes)
        c += _conv(batch, h, w, top, top, 3, act_bytes)
    cin = top
    for i in range(cfg.num_encoders):
        h, w = h * 2, w * 2
        cout = cin // 2
        # bilinear 2x (8 flops/px, reads cin at h/2 writes cin at h) + 5x5 conv
        c.bytes_min += batch * h * w * cin * act_bytes
        c.flops += 8.0 * batch * h * w * cin
        eff_cin = 2 * cin if (cfg.skip_type == "concat" and i > 0) else cin
        c += _conv(batch, h, w, eff_cin, cout, 5, act_bytes)
        cin = cout
    c += _conv(batch, H, W, cfg.base_num_channels, cfg.num_output_channels, 1,
               act_bytes)
    return c


def package_costs(cfg, H: int, W: int, batch: int = 1,
                  act_bytes: int = 4, decodes: Optional[int] = None) -> Costs:
    """One datapackage: K event sweeps + 1 image sweep, a decoder pass
    after every modality update (model/model.py:176-217), or ``decodes``
    passes."""
    K = cfg.every_x_rgb_frame
    n_sweeps = K + 1
    n_decodes = n_sweeps if decodes is None else decodes
    c = Costs()
    for _ in range(n_sweeps):
        c += modality_sweep_costs(cfg, H, W, batch, act_bytes)
    for _ in range(n_decodes):
        c += decoder_costs(cfg, H, W, batch, act_bytes)
    return c


def train_window_costs(cfg, H: int, W: int, batch: int, L: int,
                       act_bytes: int = 4, supervised_decodes: int = 2,
                       remat: bool = True) -> Costs:
    """One TBPTT window forward+backward.  A conv's backward is ~2x its
    forward FLOPs (grad-input + grad-weight); remat adds one extra
    forward."""
    fwd = package_costs(cfg, H, W, batch, act_bytes,
                        decodes=supervised_decodes)
    factor = L * (3.0 + (1.0 if remat else 0.0))
    return Costs(flops=fwd.flops * factor,
                 bytes_min=fwd.bytes_min * factor,
                 param_bytes=fwd.param_bytes * 2)


def counted_costs(fn, *args) -> Dict[str, float]:
    """{'flops': ...} of ``fn(*args)`` as torch's
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (2 per
    multiply-add of the matmuls and convolutions it knows; no bytes: torch
    has no byte model).  The counter sees only aten operators: a
    hand-written kernel's launch through ctypes counts nothing, so count
    on the plain path (fused_gru='off', no K8).  Exceptions of ``fn``
    propagate."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}
