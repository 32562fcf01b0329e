"""Card-only tests of the port: the h-side kernels (K1, K1-res, K2) and
the ConvGRUHside Function against their plain versions, the precomputed
path with the kernel against the plain layer, one training step with
the kernels against fused_gru='off', the whole-cell kernel K5 and the
voxelizers K6 and K7 against their plain versions, the per-package
engine with K5 against fused_gru='off', the ConvLSTM cells K3 and K4
against their plain versions, and the phased per-package engine with the
kernels against fused_gru='off'.

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
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights()
    h = (torch.rand(B, H, W, C, generator=gen) * 2 - 1).to(device, torch.bfloat16)
    gx = torch.randn(B, 2, H, W, 3 * C, generator=gen).to(device, torch.bfloat16)[:, 1]
    n0 = gru_hside.conv_gru_hside.launches
    got = gru_hside.conv_gru_hside(h, gx, w_ur, w_o)
    want = gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)
    torch.cuda.synchronize()
    assert gru_hside.conv_gru_hside.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def _cell_inputs(shape, device, seed=0):
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(seed)
    cell = ConvGRU(C, C)
    cell.reset_parameters_(gen)
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights(torch.bfloat16)
    h = (torch.rand(B, H, W, C, generator=gen) * 2 - 1).to(device, torch.bfloat16)
    gx = torch.randn(B, 2, H, W, 3 * C, generator=gen).to(device, torch.bfloat16)[:, 1]
    g = torch.randn(B, H, W, C, generator=gen).to(device, torch.bfloat16)
    return h, gx, g, w_ur.to(device), w_o.to(device)


def _rel_err(got, want):
    """Max abs error over the plain version's max magnitude."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


TRAIN_CELLS = [(16, 28, 28, 256), (3, 30, 45, 96)]


@pytest.mark.parametrize("shape", TRAIN_CELLS, ids=lambda s: "x".join(map(str, s)))
def test_res_and_bwd_kernels_match_plain(device, shape):
    """K1-res: h' and acts within 2e-2 of the plain version (values in
    [-1, 1]; a few bf16 roundings).  K2: dh and dgx within 2e-2 of the
    plain version's largest magnitude."""
    h, gx, g, w_ur, w_o = _cell_inputs(shape, device)
    n_res, n_bwd = gru_hside.conv_gru_hside_res.launches, gru_hside.conv_gru_hside_bwd.launches
    got_h, got_acts = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o)
    want_h, want_acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    dh, dgx = gru_hside.conv_gru_hside_bwd(g, h, want_acts, w_ur, w_o)
    want_dh, want_dgx = gru_hside.conv_gru_hside_bwd_plain(g, h, want_acts, w_ur, w_o)
    torch.cuda.synchronize()
    assert gru_hside.conv_gru_hside_res.launches == n_res + 1
    assert gru_hside.conv_gru_hside_bwd.launches == n_bwd + 1
    assert (got_h.float() - want_h.float()).abs().max().item() <= 2e-2
    assert (got_acts.float() - want_acts.float()).abs().max().item() <= 2e-2
    assert _rel_err(dh, want_dh) <= 2e-2
    assert _rel_err(dgx, want_dgx) <= 2e-2


def test_function_kernels_match_plain(device):
    """The ConvGRUHside Function on the card (K1-res, K2, library weight
    gradients) against the plain versions composed: every gradient within
    2e-2 of the plain one's largest magnitude."""
    h, gx, g, w_ur, w_o = _cell_inputs((2, 56, 56, 128), device)
    w_ur, w_o = w_ur.float(), w_o.float()
    args = [t.clone().requires_grad_() for t in (h, gx, w_ur, w_o)]
    out = gru_hside.ConvGRUHside.apply(*args)
    got = torch.autograd.grad(out, args, g)
    want_h, acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    dh, dgx = gru_hside.conv_gru_hside_bwd_plain(
        g, h, acts, w_ur.to(h.dtype), w_o.to(h.dtype))
    want = (dh, dgx) + gru_hside.hside_weight_grads(h, acts, dgx)
    assert (out.float() - want_h.float()).abs().max().item() <= 2e-2
    for a, b in zip(got, want):
        assert a.dtype == (torch.float32 if a.dim() == 3 else torch.bfloat16)
        assert _rel_err(a, b) <= 2e-2


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


def test_training_step_kernels_vs_off(device):
    """One TBPTT loss and backward of a small flagship-shaped bf16 model
    (precompute_x, checkpointed packages) with the kernels and with
    fused_gru='off', from the same weights: K1-res runs twice per cell
    (the recompute) and K2 once; the loss within 2e-2 relative and every
    parameter gradient at cosine >= 0.95 of the plain layer's."""
    from rpg_ramnet_tpu_torch.core.config import Config, TrainerConfig
    from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
    mcfg = ModelConfig(num_encoders=3, base_num_channels=16,
                       recurrent_block_type="conv", state_combination="convgru",
                       num_residual_blocks=1, every_x_rgb_frame=2,
                       compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    B, L, K, H, W = 2, 3, 2, 64, 96
    batch = {"events": torch.randn(B, L, K, H, W, 5, generator=gen),
             "image": torch.rand(B, L, H, W, 1, generator=gen),
             "depth_events": torch.rand(B, L, K, H, W, 1, generator=gen),
             "depth_image": torch.rand(B, L, H, W, 1, generator=gen)}
    batch = {k: v.to(device) for k, v in batch.items()}
    out = {}
    for mode in ("auto", "off"):
        cfg = Config(model=dataclasses.replace(mcfg, fused_gru=mode),
                     grad_loss_weight=0.25,
                     trainer=TrainerConfig(deferred_decode=True,
                                           precompute_x=True,
                                           sequence_length=L))
        model = ERGB2DepthRecurrent(cfg.model, device=device)
        n = (gru_hside.conv_gru_hside_res.launches,
             gru_hside.conv_gru_hside_bwd.launches)
        loss, _ = make_sequence_loss(cfg, remat=True)(
            model, model.init_state(B, H, W), batch)
        loss.backward()
        torch.cuda.synchronize()
        launched = (gru_hside.conv_gru_hside_res.launches - n[0],
                    gru_hside.conv_gru_hside_bwd.launches - n[1])
        cells = 3 * (K + 1) * L
        assert launched == ((2 * cells, cells) if mode == "auto" else (0, 0))
        out[mode] = (loss.item(), {k: p.grad.float().flatten()
                                   for k, p in model.named_parameters()})
    assert abs(out["auto"][0] - out["off"][0]) <= 2e-2 * abs(out["off"][0])
    for k, g in out["off"][1].items():
        cos = torch.nn.functional.cosine_similarity(out["auto"][1][k], g, dim=0)
        assert cos.item() >= 0.95, k


@pytest.mark.parametrize("shape", [(1, 128, 256, 64), (1, 32, 64, 256),
                                   (2, 30, 45, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_full_cell_kernel_matches_plain(device, shape):
    """K5, bf16, one cell with nonzero biases: within 2e-2 of its plain
    version (a few bf16 roundings)."""
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(1)
    cell = ConvGRU(C, C)
    cell.reset_parameters_(gen)
    with torch.no_grad():
        for g in cell.gates():
            g.bias.uniform_(-0.5, 0.5, generator=gen)
        w = [t.to(device) for t in cell.full_weights(torch.bfloat16)]
        x = torch.randn(B, H, W, C, generator=gen).to(device, torch.bfloat16)
        h = (torch.rand(B, H, W, C, generator=gen) * 2 - 1).to(device, torch.bfloat16)
        n0 = gru_hside.conv_gru_full.launches
        got = gru_hside.conv_gru_full(x, h, *w)
        want = gru_hside.conv_gru_full_plain(x, h, *w)
    torch.cuda.synchronize()
    assert gru_hside.conv_gru_full.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def _events(n, n_valid, height, width, seed):
    gen = torch.Generator().manual_seed(seed)
    ev = torch.stack([torch.rand(n, generator=gen).sort().values * 0.05,
                      torch.randint(0, width, (n,), generator=gen).float(),
                      torch.randint(0, height, (n,), generator=gen).float(),
                      torch.randint(0, 2, (n,), generator=gen).float()], 1)
    ev[n_valid:] = 0
    return ev


@pytest.mark.parametrize("n,n_valid", [(200_000, 200_000), (4096, 64)])
def test_voxel_kernels_match_plain(device, n, n_valid):
    """K6 (with and without stats) and K7 (float32 factors) within 1e-4 of
    the index_add_ scatter; K7 with bfloat16 factors within 0.05."""
    from rpg_ramnet_tpu_torch.ops import voxel
    ev = _events(n, n_valid, 260, 346, seed=n).to(device)
    kw = dict(num_bins=5, height=260, width=346)
    want = voxel.events_to_voxel_grid_scatter(ev, n_valid, **kw)
    n6, n7 = (voxel.events_to_voxel_grid_sortseg.launches,
              voxel.events_to_voxel_grid_pallas.launches)
    k6 = voxel.events_to_voxel_grid(ev, n_valid, **kw)           # 'auto'
    k6s, stats = voxel.events_to_voxel_grid_sortseg(ev, n_valid, with_stats=True, **kw)
    k7 = voxel.events_to_voxel_grid_pallas(ev, n_valid, **kw)
    k7b = voxel.events_to_voxel_grid_pallas(ev, n_valid,
                                            factor_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert (voxel.events_to_voxel_grid_sortseg.launches - n6,
            voxel.events_to_voxel_grid_pallas.launches - n7) == (2, 2)
    for got in (k6, k6s, k7):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert (k7b - want).abs().max().item() <= 0.05
    for got, ref in zip(stats, voxel.voxel_stats(want)):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_per_package_engine_kernel_vs_off(device):
    """A small flagship-shaped bf16 model: fused_gru='on' runs K5 on every
    cell of the per-package engine (3 scales x (K+1) per package), and its
    predictions stay within 5e-2 of fused_gru='off'."""
    import numpy as np
    from rpg_ramnet_tpu_torch.eval import StreamingInference
    cfg = ModelConfig(num_encoders=3, base_num_channels=16,
                      recurrent_block_type="conv", state_combination="convgru",
                      num_residual_blocks=1, every_x_rgb_frame=2,
                      compute_dtype="bfloat16", fused_gru="on")
    model = ERGB2DepthRecurrent(cfg, device=device)
    off = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="off"),
                              device=device)
    off.load_state_dict(model.state_dict())
    rng = np.random.RandomState(0)
    on_e, off_e = (StreamingInference(m, batched_decode=True) for m in (model, off))
    n0 = gru_hside.conv_gru_full.launches
    for _ in range(3):
        pkg = {"events": rng.randn(2, 64, 96, 5).astype(np.float32),
               "image": rng.rand(64, 96, 1).astype(np.float32)}
        p_on, p_off = on_e.step(pkg), off_e.step(pkg)
        for k in p_on:
            assert np.isfinite(p_on[k]).all()
            assert np.abs(p_on[k] - p_off[k]).max() <= 5e-2
    assert gru_hside.conv_gru_full.launches - n0 == 3 * 3 * 3


def _lstm_inputs(shape, device, seed):
    """bf16 NHWC (h, c), a strided gx, a ConvLSTM's folded weight and a
    phased gate's [H, W, C] tau and phase on ``device``."""
    from rpg_ramnet_tpu_torch.models.layers import ConvLSTM, PhasedLSTMGate
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(seed)
    cell = ConvLSTM(C, C)
    torch.nn.init.uniform_(cell.Gates.weight, -0.05, 0.05, generator=gen)
    gate = PhasedLSTMGate(C * H * W)
    gate.reset_parameters_(gen)
    with torch.no_grad():
        w4 = cell.hside_weights(torch.bfloat16).to(device)
        tau, phase = (v.to(device) for v in gate.nhwc(C, H, W))
    h = (torch.rand(B, H, W, C, generator=gen) * 2 - 1).to(device, torch.bfloat16)
    c = (torch.rand(B, H, W, C, generator=gen) * 4 - 2).to(device, torch.bfloat16)
    gx = torch.randn(B, 2, H, W, 4 * C, generator=gen).to(device, torch.bfloat16)[:, 1]
    t = (torch.rand(B, generator=gen) * 3).to(device)
    return h, c, gx, w4, tau, phase, t


@pytest.mark.parametrize("shape", [(1, 128, 176, 64), (1, 64, 88, 128),
                                   (1, 32, 44, 256), (3, 30, 45, 96),
                                   (1, 32, 64, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_kernels_match_plain(device, shape):
    """K3 (h', c') and K4 (h_t, h_new, c_new), bf16, one cell: within 2e-2
    of their plain versions; the phased shapes (W=44 included), a ragged
    one with B > 1 and a flagship one; gx a strided view."""
    from rpg_ramnet_tpu_torch.ops import phased_cell
    h, c, gx, w4, tau, phase, t = _lstm_inputs(shape, device, seed=shape[2])
    n3, n4 = gru_hside.conv_lstm_hside.launches, phased_cell.conv_lstm_phased.launches
    with torch.no_grad():
        got3 = gru_hside.conv_lstm_hside(h, c, gx, w4)
        want3 = gru_hside.conv_lstm_hside_plain(h, c, gx, w4)
        got4 = phased_cell.conv_lstm_phased(h, c, gx, w4, tau, phase, t)
        want4 = phased_cell.conv_lstm_phased_plain(h, c, gx, w4, tau, phase, t)
    torch.cuda.synchronize()
    assert (gru_hside.conv_lstm_hside.launches - n3,
            phased_cell.conv_lstm_phased.launches - n4) == (1, 1)
    for a, b in zip(got3 + got4, want3 + want4):
        assert a.shape == shape
        assert (a.float() - b.float()).abs().max().item() <= 2e-2


def test_phased_engine_kernels_vs_off(device):
    """A small phased bf16 model with the ConvLSTM state combination:
    fused_gru='on' runs K4 and K3 on every cell of the per-package engine
    (3 scales x (K+1) per package each), and its predictions stay within
    5e-2 of fused_gru='off'."""
    import numpy as np
    from rpg_ramnet_tpu_torch.eval import StreamingInference
    from rpg_ramnet_tpu_torch.ops import phased_cell
    cfg = ModelConfig(num_encoders=3, base_num_channels=16,
                      recurrent_block_type="convlstm",
                      state_combination="convlstm", use_phased_arch=True,
                      spatial_resolution=(64, 96), num_residual_blocks=1,
                      every_x_rgb_frame=2, compute_dtype="bfloat16",
                      fused_gru="on")
    model = ERGB2DepthRecurrent(cfg, device=device)
    off = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="off"),
                              device=device)
    off.load_state_dict(model.state_dict())
    rng = np.random.RandomState(0)
    on_e, off_e = (StreamingInference(m, batched_decode=True) for m in (model, off))
    n = (gru_hside.conv_lstm_hside.launches, phased_cell.conv_lstm_phased.launches)
    for p in range(3):
        pkg = {"events": rng.randn(2, 64, 96, 5).astype(np.float32),
               "image": rng.rand(64, 96, 1).astype(np.float32),
               "times_events": np.float32([0.1 * p, 0.1 * p + 0.03]),
               "times_image": np.float32(0.1 * p + 0.05)}
        p_on, p_off = on_e.step(pkg), off_e.step(pkg)
        for k in p_on:
            assert np.isfinite(p_on[k]).all()
            assert np.abs(p_on[k] - p_off[k]).max() <= 5e-2
    assert (gru_hside.conv_lstm_hside.launches - n[0],
            phased_cell.conv_lstm_phased.launches - n[1]) == (3 * 3 * 3, 3 * 3 * 3)
