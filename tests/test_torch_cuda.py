"""Card-only tests of the port: the h-side kernel (K1) against its plain
version, and the precomputed path with the kernel against the plain layer.

They skip without a CUDA device.  This file imports nothing of JAX, so it
also runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, statenet
from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 128, 256, 64), (2, 30, 45, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(device, shape):
    """bf16, one cell: at most a few bf16 roundings apart (2e-2); the
    ragged shape has B > 1 and gx as a strided view."""
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(0)
    cell = ConvGRU(C, C)
    cell.reset_parameters_(gen)
    cell.to(device, torch.bfloat16)
    w_ur, w_o = cell.hside_weights()
    h = (torch.rand(B, H, W, C, generator=gen) * 2 - 1).to(device, torch.bfloat16)
    gx = torch.randn(B, 2, H, W, 3 * C, generator=gen).to(device, torch.bfloat16)[:, 1]
    n0 = gru_hside.conv_gru_hside.launches
    got = gru_hside.conv_gru_hside(h, gx, w_ur, w_o)
    want = gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)
    torch.cuda.synchronize()
    assert gru_hside.conv_gru_hside.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_precomputed_path_kernel_vs_plain_layer(device):
    """A small flagship-shaped model: 'auto' takes the kernel on every
    cell, and its predictions stay within 5e-2 of fused_gru='off'."""
    cfg = ModelConfig(num_encoders=3, base_num_channels=16,
                      recurrent_block_type="conv", state_combination="convgru",
                      num_residual_blocks=1, every_x_rgb_frame=2,
                      compute_dtype="bfloat16")
    model = ERGB2DepthRecurrent(cfg, device=device)
    off = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="off"),
                              device=device)
    off.load_state_dict(model.state_dict())
    assert statenet.use_fused_cell(cfg, torch.zeros(
        1, 32, 8, 8, dtype=torch.bfloat16, device=device))
    gen = torch.Generator().manual_seed(0)
    seq = {"events": torch.randn(1, 3, 2, 64, 96, 5, generator=gen).to(device),
           "image": torch.rand(1, 3, 64, 96, 1, generator=gen).to(device)}
    n0 = gru_hside.conv_gru_hside.launches
    _, p_on = model.forward_sequence_precomputed(model.init_state(1, 64, 96), seq)
    assert gru_hside.conv_gru_hside.launches - n0 == 3 * 3 * 3
    _, p_off = off.forward_sequence_precomputed(off.init_state(1, 64, 96), seq)
    for k in p_on:
        assert torch.isfinite(p_on[k]).all()
        assert (p_on[k] - p_off[k]).abs().max().item() <= 5e-2
