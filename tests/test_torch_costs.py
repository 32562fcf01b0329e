"""The port's FLOP and byte accounting (rpg_ramnet_tpu_torch/utils/costs.py)
against the JAX package's rpg_ramnet_tpu/utils/costs.py, on the CPU.

Every shipped config and the zoo's state combinations and skips, at both
activation widths and several H, W, batch, L and remat values: the four
cost functions give JAX's flops, bytes_min and param_bytes to rel 1e-12.
The card's peaks hold no TPU number and refuse a card they do not know;
counted_costs is torch's FlopCounterMode, 2 per multiply-add.
"""
import dataclasses
import glob
import math
import os

import pytest
import torch
import torch.nn.functional as F

from rpg_ramnet_tpu.core.config import Config as JaxConfig
from rpg_ramnet_tpu.utils import costs as jcosts

from rpg_ramnet_tpu_torch.core.config import Config
from rpg_ramnet_tpu_torch.utils import costs
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
FLAGSHIP = os.path.join(
    REPO, "configs", "train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json")
REL = 1e-12

# (config file, model overrides, H, W, batch, L, act_bytes, remat)
SHIPPED = [(path, {}, h, w, b, l, ab, remat)
           for path, (h, w, b, l, remat) in zip(
               CONFIGS, [(256, 512, 1, 10, True), (224, 224, 16, 10, True),
                         (260, 346, 2, 4, False), (128, 256, 8, 1, True),
                         (96, 64, 3, 7, False), (64, 96, 4, 2, True)])
           for ab in (2, 4)]
ZOO = [(FLAGSHIP, {"state_combination": sc, "skip_type": skip},
        h, w, b, l, ab, remat)
       for (sc, skip), (h, w, b, l, ab, remat) in zip(
           [(sc, skip) for sc in ("convgru", "convlstm", "conv", "sum")
            for skip in ("sum", "concat")],
           [(256, 352, 1, 10, 2, True), (224, 224, 16, 10, 4, False),
            (128, 128, 2, 3, 2, False), (256, 512, 4, 5, 4, True),
            (64, 64, 1, 1, 4, True), (192, 160, 8, 2, 2, True),
            (256, 512, 1, 10, 2, False), (32, 48, 5, 4, 4, True)])]


def _case_id(case):
    path, over, h, w, b, l, ab, remat = case
    name = os.path.basename(path)[len("train_e2depth_si_grad_loss_statenet_"):-5]
    extra = "-".join(f"{v}" for v in over.values())
    return f"{name}{'-' + extra if extra else ''}-{h}x{w}-b{b}-L{l}-a{ab}-r{int(remat)}"


def _same(a, b):
    for key in ("flops", "bytes_min", "param_bytes"):
        x, y = getattr(a, key), getattr(b, key)
        assert math.isclose(x, y, rel_tol=REL), (key, x, y)
    assert a.flops > 0 and a.bytes_min > 0 and a.param_bytes > 0


def test_shipped_configs_are_six():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("case", SHIPPED + ZOO, ids=_case_id)
def test_costs_match_jax(case):
    path, over, h, w, b, l, ab, remat = case
    cfg = dataclasses.replace(Config.load(path).model, **over)
    jcfg = dataclasses.replace(JaxConfig.load(path).model, **over)
    _same(costs.modality_sweep_costs(cfg, h, w, b, ab),
          jcosts.modality_sweep_costs(jcfg, h, w, b, ab))
    _same(costs.decoder_costs(cfg, h, w, b, ab),
          jcosts.decoder_costs(jcfg, h, w, b, ab))
    for decodes in (None, 1, 2):
        _same(costs.package_costs(cfg, h, w, b, ab, decodes=decodes),
              jcosts.package_costs(jcfg, h, w, b, ab, decodes=decodes))
    for sup in (1, 2):
        _same(costs.train_window_costs(cfg, h, w, b, l, ab,
                                       supervised_decodes=sup, remat=remat),
              jcosts.train_window_costs(jcfg, h, w, b, l, ab,
                                        supervised_decodes=sup, remat=remat))


def test_device_peaks_h100():
    assert costs.device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12, 80)
    assert costs.device_peaks("nvidia h100 80gb hbm3") == (989e12, 3.35e12, 80)


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v5e", "TPU v4", "cpu",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_device_peaks_refuse_other_devices(kind):
    with pytest.raises(ValueError, match="no peaks known"):
        costs.device_peaks(kind)


def test_device_peaks_hold_no_tpu_number():
    tpu = {v for peaks in jcosts._DEVICE_PEAKS.values() for v in peaks}
    port = {v for peaks in costs._DEVICE_PEAKS.values() for v in peaks}
    assert not tpu & port


def test_counted_costs_conv_is_two_macs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 10, generator=g)
    w = torch.randn(4, 3, 5, 5, generator=g)
    got = costs.counted_costs(lambda a, b: F.conv2d(a, b, padding=2), x, w)
    macs = 2 * 8 * 10 * 4 * 3 * 5 * 5
    assert got == {"flops": 2.0 * macs}
    assert got["flops"] == costs._conv(2, 8, 10, 3, 4, 5).flops


def test_counted_costs_matmul_and_errors():
    a, b = torch.ones(3, 7), torch.ones(7, 5)
    assert costs.counted_costs(torch.mm, a, b) == {"flops": 2.0 * 3 * 7 * 5}
    with pytest.raises(RuntimeError):
        costs.counted_costs(torch.mm, a, a)
