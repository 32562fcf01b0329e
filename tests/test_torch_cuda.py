"""Card-only tests of the port: the h-side kernels (K1, K1-res, K2) and
the ConvGRUHside Function against their plain versions, the precomputed
path with the kernel against the plain layer, one training step with
the kernels against fused_gru='off', the whole-cell kernel K5 and the
voxelizers K6 and K7 against their plain versions (single windows and
window batches in one launch sequence, unsorted, skewed and outside
events, ragged and wide grids), the per-package
engine with K5 against fused_gru='off', the ConvLSTM cells K3 and K4
and their residual variants K3-res and K4-res against their plain
versions, the ConvLSTMHside and PhasedCell Functions against the plain
layers' autograd, one training step of the phased recipe and of the
ConvLSTM state combination with the kernels against fused_gru='off', the
phased per-package engine with the kernels against fused_gru='off', the chunked path's launch variants (the
pair cell K9, the gx-streaming cells K10a and K10b, the resident-state
cell K11) against their plain versions, K9 and K10b under every kind of
pair launch, K10a and K11 under every plan kind
their planners can pick at the flagship, ragged and edge shapes and K10a's
refusals, K11 on many steps and tiles with a grid smaller than the tiles
and with cluster-split plans (a stale or raced read of h shows at its
step), an oversized cooperative grid raising, and the precomputed path
under each variant against fused_gru='off', the fused decoder kernel K8
against its plain version at the flagship layers and ragged shapes, its
refusals, the composed layer against the two-stage one, and both decoder
options through the chunked and per-package engines (K8's launch counts).

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


# K2 at the training shapes, the ragged one and K1's edge shapes (H or W
# below the tile, H = W = 1, C = 16, 48 and 96, B > 1), under every combo
# its planner can pick there (gru_hside.k2_plan_kinds, its own pick first)
# and the forced plans below: ragged tiles, a tile beyond the image,
# narrow slabs
TRAIN_CELLS = [(16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256),
               (3, 30, 45, 96), (1, 5, 40, 64), (2, 9, 3, 128), (1, 3, 37, 256),
               (1, 1, 1, 64), (2, 1, 1, 256), (1, 20, 24, 16), (2, 17, 19, 48),
               (3, 33, 21, 96)]
K2_EXTRA_PLANS = {
    (16, 28, 28, 256): [gru_hside.K2Plan(4, 4, 0, 16),
                        gru_hside.K2Plan(3, 8, 1, 32),
                        gru_hside.K2Plan(5, 5, 0, 16)],
    (3, 30, 45, 96): [gru_hside.K2Plan(5, 7, 1, 32),
                      gru_hside.K2Plan(4, 8, 2, 16)],
    (1, 1, 1, 64): [gru_hside.K2Plan(4, 4, 0, 64)],
    (2, 17, 19, 48): [gru_hside.K2Plan(8, 8, 1, 16)],
}


@pytest.mark.parametrize("shape", TRAIN_CELLS, ids=lambda s: "x".join(map(str, s)))
def test_res_and_bwd_kernels_match_plain(device, shape):
    """K1-res: h' and acts within 2e-2 of the plain version (values in
    [-1, 1]; a few bf16 roundings).  K2, under every plan kind: dh and dgx
    within 2e-2 of the plain version's largest magnitude."""
    h, gx, g, w_ur, w_o = _cell_inputs(shape, device)
    n_res = gru_hside.conv_gru_hside_res.launches
    got_h, got_acts = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o)
    want_h, want_acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    want_dh, want_dgx = gru_hside.conv_gru_hside_bwd_plain(g, h, want_acts, w_ur, w_o)
    torch.cuda.synchronize()
    assert gru_hside.conv_gru_hside_res.launches == n_res + 1
    assert (got_h.float() - want_h.float()).abs().max().item() <= 2e-2
    assert (got_acts.float() - want_acts.float()).abs().max().item() <= 2e-2
    for i, plan in enumerate(gru_hside.k2_plan_kinds(*shape)
                             + K2_EXTRA_PLANS.get(shape, [])):
        kw = {"_plan": plan} if i else {}   # the planner's own through the default
        n_bwd = gru_hside.conv_gru_hside_bwd.launches
        dh, dgx = gru_hside.conv_gru_hside_bwd(g, h, want_acts, w_ur, w_o, **kw)
        torch.cuda.synchronize()
        assert gru_hside.conv_gru_hside_bwd.launches == n_bwd + 1
        errs = (_rel_err(dh, want_dh), _rel_err(dgx, want_dgx))
        assert max(errs) <= 2e-2, (plan, errs)


def test_function_kernels_match_plain(device):
    """The ConvGRUHside Function on the card (K1-res, K2, library weight
    gradients) against the plain versions composed, at a training-like
    shape and at two edge shapes: every gradient
    within 2e-2 of the plain one's largest magnitude."""
    for shape in ((2, 56, 56, 128), (1, 5, 40, 64), (2, 9, 3, 256)):
        h, gx, g, w_ur, w_o = _cell_inputs(shape, device)
        w_ur, w_o = w_ur.float(), w_o.float()
        args = [t.clone().requires_grad_() for t in (h, gx, w_ur, w_o)]
        n_bwd = gru_hside.conv_gru_hside_bwd.launches
        out = gru_hside.ConvGRUHside.apply(*args)
        got = torch.autograd.grad(out, args, g)
        assert gru_hside.conv_gru_hside_bwd.launches == n_bwd + 1
        want_h, acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
        dh, dgx = gru_hside.conv_gru_hside_bwd_plain(
            g, h, acts, w_ur.to(h.dtype), w_o.to(h.dtype))
        want = (dh, dgx) + gru_hside.hside_weight_grads(h, acts, dgx)
        assert (out.float() - want_h.float()).abs().max().item() <= 2e-2
        for a, b in zip(got, want):
            assert a.dtype == (torch.float32 if a.dim() == 3 else torch.bfloat16)
            assert _rel_err(a, b) <= 2e-2, shape


def test_k2_refuses_bad_plans(device):
    """A plan K2 cannot run raises before the launch; one the C entry
    refuses (a combo it has not, a 48-wide slab, shared memory over a
    block's) comes back as the launch's CUDA error text."""
    h, _, g, w_ur, w_o = _cell_inputs((1, 16, 16, 96), device)
    acts = torch.rand(1, 16, 16, 288).to(device, torch.bfloat16)
    for bad in (gru_hside.K2Plan(8, 8, 3, 32), gru_hside.K2Plan(8, 8, 0, 64),
                gru_hside.K2Plan(8, 8, 0, 48), gru_hside.K2Plan(64, 64, 0, 32)):
        with pytest.raises(ValueError):
            gru_hside.conv_gru_hside_bwd(g, h, acts, w_ur, w_o, _plan=bad)
    lib = gru_hside.library_bwd()
    dh, dgx = torch.empty_like(h), torch.empty_like(acts)
    for th, combo, ks in ((8, 3, 32), (8, 0, 48), (64, 0, 32)):
        err = lib.ramnet_gru_hside_backward(
            g.data_ptr(), h.data_ptr(), acts.data_ptr(), w_ur.data_ptr(),
            w_o.data_ptr(), dh.data_ptr(), dgx.data_ptr(), 1, 16, 16, 96, th, th,
            combo, ks, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="invalid argument"):
            gru_hside._raise_on(err, lib, "gru_hside_bwd")


# K1 and K1-res under every (split, combo) the planner can pick for each
# at each shape (gru_hside.k1_plan_kinds, its own pick first): the flagship,
# training and ragged cells, H or W below the tile, H = W = 1, C = 16, 48
# and 96, B = 3; gx is a strided view throughout.  Some shapes also force
# the split the planner does not pick and the narrower weight slabs.
K1_CELLS = [(1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256),
            (16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256),
            (2, 30, 45, 96), (3, 30, 45, 96), (1, 5, 40, 64),
            (2, 9, 3, 128), (1, 3, 37, 256), (1, 1, 1, 64), (2, 1, 1, 256),
            (1, 20, 24, 16), (2, 17, 19, 48), (1, 33, 21, 96)]
K1_EXTRA_PLANS = {
    (1, 32, 64, 256): [gru_hside.K1Plan(8, 8, 2, 2, 32),
                       gru_hside.K1Plan(4, 14, 2, 0, 32),
                       gru_hside.K1Plan(4, 4, 1, 1, 16)],
    (2, 1, 1, 256): [gru_hside.K1Plan(1, 1, 2, 1, 64),
                     gru_hside.K1Plan(1, 1, 1, 2, 64)],
    (2, 17, 19, 48): [gru_hside.K1Plan(4, 8, 1, 1, 16)],
    (1, 20, 24, 16): [gru_hside.K1Plan(8, 8, 1, 0, 16)],
    (1, 64, 128, 128): [gru_hside.K1Plan(8, 16, 2, 0, 32),
                        gru_hside.K1Plan(8, 8, 2, 2, 16),
                        gru_hside.K1Plan(7, 12, 2, 1, 64)],
}


@pytest.mark.parametrize("shape", K1_CELLS, ids=lambda s: "x".join(map(str, s)))
def test_k1_plans_match_plain(device, shape):
    """K1's h' and K1-res's h' and acts within 8e-3 of the plain versions
    (values in [-1, 1]: two bf16 steps near 1) under each plan."""
    h, gx, _, w_ur, w_o = _cell_inputs(shape, device)
    want = gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)
    want_h, want_acts = gru_hside.conv_gru_hside_res_plain(h, gx, w_ur, w_o)
    extra = K1_EXTRA_PLANS.get(shape, [])
    for plan in gru_hside.k1_plan_kinds(*shape) + extra:
        n0 = gru_hside.conv_gru_hside.launches
        got = gru_hside.conv_gru_hside(h, gx, w_ur, w_o, _plan=plan)
        torch.cuda.synchronize()
        assert gru_hside.conv_gru_hside.launches == n0 + 1
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 8e-3, (plan, err)
    for plan in gru_hside.k1_plan_kinds(*shape, residuals=True) + extra:
        n0 = gru_hside.conv_gru_hside_res.launches
        got_h, got_acts = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o,
                                                       _plan=plan)
        torch.cuda.synchronize()
        assert gru_hside.conv_gru_hside_res.launches == n0 + 1
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in ((got_h, want_h), (got_acts, want_acts))]
        assert max(errs) <= 8e-3, (plan, errs)


def test_k1_refuses_bad_plans(device):
    """A plan K1 cannot run raises before the launch; an argument the C
    entry refuses comes back as the launch's CUDA error text."""
    h, gx, _, w_ur, w_o = _cell_inputs((1, 16, 16, 96), device)
    for bad in (gru_hside.K1Plan(8, 8, 4, 0, 32),     # no clusters of 4
                gru_hside.K1Plan(8, 8, 1, 3, 32),     # no such combo
                gru_hside.K1Plan(8, 8, 1, 0, 64),     # 64 does not divide 96
                gru_hside.K1Plan(8, 8, 1, 0, 48),     # no 48-wide slab
                gru_hside.K1Plan(64, 64, 1, 0, 32)):  # shared memory
        with pytest.raises(ValueError):
            gru_hside.conv_gru_hside(h, gx, w_ur, w_o, _plan=bad)
    lib = gru_hside.library()
    out = torch.empty_like(h)
    for split, ks in ((4, 32), (1, 48)):   # the C entry's own check
        err = lib.ramnet_gru_hside_forward(
            h.data_ptr(), gx.data_ptr(), w_ur.data_ptr(), w_o.data_ptr(),
            out.data_ptr(), 1, 16, 16, 96, gx.stride(0), 8, 8, split, 0, ks,
            torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="invalid argument"):
            gru_hside._raise_on(err, lib, "gru_hside")


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


def _full_inputs(shape, device, seed=1):
    """x, h and a ConvGRU's whole-cell weights with biases in (-0.5, 0.5),
    bf16 (biases float32) on the card."""
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(seed)
    cell = ConvGRU(C, C)
    cell.reset_parameters_(gen)
    with torch.no_grad():
        for g in cell.gates():
            g.bias.uniform_(-0.5, 0.5, generator=gen)
        w = [t.to(device) for t in cell.full_weights(torch.bfloat16)]
    x = torch.randn(B, H, W, C, generator=gen).to(device, torch.bfloat16)
    h = (torch.rand(B, H, W, C, generator=gen) * 2 - 1).to(device, torch.bfloat16)
    return x, h, w


# K5 under every (split, combo) its planner can pick at each shape
# (gru_hside.k5_plan_kinds, its own pick first): the per-package cells, the
# ragged one and K1's edge shapes (H or W below the tile, H = W = 1, C =
# 16, 48 and 96, B > 1); some shapes also force the split the planner does
# not pick, ragged tiles and the narrower weight slabs.
K5_CELLS = [(1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256),
            (2, 30, 45, 96), (1, 5, 40, 64), (2, 9, 3, 128), (1, 3, 37, 256),
            (1, 1, 1, 64), (2, 1, 1, 256), (1, 20, 24, 16), (2, 17, 19, 48),
            (3, 33, 21, 96)]
K5_EXTRA_PLANS = {
    (1, 32, 64, 256): [gru_hside.K5Plan(4, 4, 1, 3, 16),
                       gru_hside.K5Plan(2, 14, 2, 0, 32)],
    (1, 64, 128, 128): [gru_hside.K5Plan(8, 8, 2, 2, 16),
                        gru_hside.K5Plan(7, 12, 1, 1, 16)],
    (2, 1, 1, 256): [gru_hside.K5Plan(1, 1, 2, 1, 64),
                     gru_hside.K5Plan(1, 1, 1, 2, 64)],
    (2, 17, 19, 48): [gru_hside.K5Plan(4, 8, 1, 1, 16)],
    (1, 20, 24, 16): [gru_hside.K5Plan(8, 8, 1, 0, 16)],
}


@pytest.mark.parametrize("shape", K5_CELLS, ids=lambda s: "x".join(map(str, s)))
def test_k5_plans_match_plain(device, shape):
    """K5's h' within 2e-2 of its plain version (a few bf16 roundings)
    under each plan."""
    x, h, w = _full_inputs(shape, device)
    with torch.no_grad():
        want = gru_hside.conv_gru_full_plain(x, h, *w)
        for plan in gru_hside.k5_plan_kinds(*shape) + K5_EXTRA_PLANS.get(shape, []):
            n0 = gru_hside.conv_gru_full.launches
            got = gru_hside.conv_gru_full(x, h, *w, _plan=plan)
            torch.cuda.synchronize()
            assert gru_hside.conv_gru_full.launches == n0 + 1
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2e-2, (plan, err)


def test_k5_refuses_bad_plans(device):
    """A plan K5 cannot run raises before the launch; an argument the C
    entry refuses comes back as the launch's CUDA error text."""
    x, h, w = _full_inputs((1, 16, 16, 96), device)
    for bad in (gru_hside.K5Plan(8, 8, 4, 0, 32),     # no clusters of 4
                gru_hside.K5Plan(8, 8, 1, 4, 32),     # no such combo
                gru_hside.K5Plan(8, 8, 1, 0, 64),     # 64 does not divide 96
                gru_hside.K5Plan(8, 8, 1, 0, 48),     # no 48-wide slab
                gru_hside.K5Plan(64, 64, 1, 0, 32)):  # shared memory
        with torch.no_grad(), pytest.raises(ValueError):
            gru_hside.conv_gru_full(x, h, *w, _plan=bad)
    lib = gru_hside.library_full()
    out = torch.empty_like(h)
    for split, combo, ks, tile in ((4, 0, 32, 8), (1, 0, 48, 8), (1, 4, 32, 8),
                                   (1, 0, 32, 64)):   # the C entry's own check
        err = lib.ramnet_gru_full_forward(
            x.data_ptr(), h.data_ptr(), w[0].data_ptr(), w[1].data_ptr(),
            w[2].data_ptr(), w[3].data_ptr(), out.data_ptr(), 1, 16, 16, 96,
            tile, tile, split, combo, ks, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="invalid argument"):
            gru_hside._raise_on(err, lib, "gru_full")


def _events(n, n_valid, height, width, seed):
    gen = torch.Generator().manual_seed(seed)
    ev = torch.stack([torch.rand(n, generator=gen).sort().values * 0.05,
                      torch.randint(0, width, (n,), generator=gen).float(),
                      torch.randint(0, height, (n,), generator=gen).float(),
                      torch.randint(0, 2, (n,), generator=gen).float()], 1)
    ev[n_valid:] = 0
    return ev


def _check_voxelizers(ev, n_valid, matmul=True, **kw):
    """K6 (with and without stats) and K7 (float32 and bf16 factors) on
    events [N, 4] or a batch [B, N, 4], one launch sequence each, on the
    path the launch's size picks (K6 through the 'auto' entry point) and
    on each path by name: the grids and the stats within atol/rtol 1e-4
    of the plain scatter's (the atomics' order), the grids also within
    1e-4 of the plain grid's magnitude and the stats within 1e-4 of their
    own (the sum against the sum of |values|); K7 bf16 within 1e-4 of its
    plain version's magnitude (the same rounding) and 0.05 of the float32
    grid.  matmul=False skips K7 bf16's plain version (the one-hot
    product), too slow on a wide grid."""
    from rpg_ramnet_tpu_torch.ops import voxel
    want = voxel.events_to_voxel_grid_scatter(ev, n_valid, **kw)
    want_b = voxel.events_to_voxel_grid_matmul(
        ev, n_valid, factor_dtype=torch.bfloat16, **kw) if matmul else None
    ref = voxel.voxel_stats(want)
    scales = (ref[0], want.abs().sum((-3, -2, -1)), ref[2])
    tol = 1e-4 * max(want.abs().max().item(), 1.0)
    wrappers = (voxel.events_to_voxel_grid_sortseg, voxel.events_to_voxel_grid_pallas)
    for path in (None,) + tuple(voxel.PATHS):
        before = [(f.launches, dict(f.path_launches)) for f in wrappers]
        k6 = (voxel.events_to_voxel_grid(ev, n_valid, **kw) if path is None     # 'auto'
              else voxel.events_to_voxel_grid_sortseg(ev, n_valid, path=path, **kw))
        k6s, stats = voxel.events_to_voxel_grid_sortseg(ev, n_valid, with_stats=True,
                                                        path=path, **kw)
        k7 = voxel.events_to_voxel_grid_pallas(ev, n_valid, path=path, **kw)
        k7b = voxel.events_to_voxel_grid_pallas(ev, n_valid, factor_dtype=torch.bfloat16,
                                                path=path, **kw)
        torch.cuda.synchronize()
        for f, (n, by_path) in zip(wrappers, before):
            assert f.launches - n == 2
            if path is not None:
                assert f.path_launches[path] - by_path[path] == 2
        for got in (k6, k6s, k7):
            assert got.shape == want.shape and got.dtype == torch.float32
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            assert (got - want).abs().max().item() <= tol
        if matmul:
            assert (k7b - want_b).abs().max().item() <= tol
        assert (k7b - want).abs().max().item() <= 0.05
        for got, r, sc in zip(stats, ref, scales):
            assert got.shape == r.shape
            torch.testing.assert_close(got, r, atol=1e-4, rtol=1e-4)
            assert ((got - r).abs() / sc.clamp(min=1.0)).max().item() <= 1e-4


@pytest.mark.parametrize("n,n_valid", [(200_000, 200_000), (4096, 64)])
def test_voxel_kernels_match_plain(device, n, n_valid):
    """One window on 5x260x346 (a width that is not a multiple of 4, so
    the tiles' 16-byte stores start unaligned): dense, and sparse with
    padding; n_valid = 0 launches nothing and gives zeros."""
    from rpg_ramnet_tpu_torch.ops import voxel
    ev = _events(n, n_valid, 260, 346, seed=n).to(device)
    kw = dict(num_bins=5, height=260, width=346)
    _check_voxelizers(ev, n_valid, **kw)
    n6 = voxel.events_to_voxel_grid_sortseg.launches
    grid, stats = voxel.events_to_voxel_grid_sortseg(ev, 0, with_stats=True, **kw)
    assert voxel.events_to_voxel_grid_sortseg.launches == n6
    assert grid.shape == (5, 260, 346) and not grid.any()
    assert not torch.stack(stats).any()


def test_voxel_path_by_size(device):
    """The kernel's size rule: one window of 5x260x346 (its grid in L2)
    takes the one-pass path, a training batch's 800 windows the tiled
    path; a launch beyond the kernels (too many windows, a band wider
    than a block's shared memory) raises before anything runs."""
    from rpg_ramnet_tpu_torch.ops import voxel
    assert voxel._launch_plan(1, 1 << 20, 5, 260, 346)[0] == "one_pass"
    assert voxel._launch_plan(800, 32_768, 5, 260, 346)[0] == "tiled"
    assert voxel._launch_plan(1, 1 << 20, 5, 260, 346, "tiled")[0] == "tiled"
    with pytest.raises(ValueError):
        voxel._launch_plan(70_000, 64, 1, 8, 8)
    with pytest.raises(ValueError):
        voxel._launch_plan(1, 64, 1, 1, 60_000, "tiled")


def _voxel_case(name, device):
    """(events, n_valid, grid kwargs) of the batched and irregular cases."""
    gen = torch.Generator().manual_seed(len(name))
    if name == "ragged_batch":      # a window with no events, one with one
        counts = torch.tensor([40_000, 12_345, 0, 1, 39_999])
        ev = torch.stack([_events(40_000, int(c), 260, 346, seed=i)
                          for i, c in enumerate(counts)])
        return ev.to(device), counts.to(device), dict(num_bins=5, height=260, width=346)
    if name == "unsorted":          # first and last stay the extremes
        ev = _events(300_000, 300_000, 260, 346, seed=5)
        mid = torch.randperm(299_998, generator=gen) + 1
        ev[1:-1] = ev[mid]
        return ev.to(device), 300_000, dict(num_bins=5, height=260, width=346)
    if name == "skewed":            # every event in one band of rows
        ev = _events(300_000, 300_000, 260, 346, seed=6)
        ev[:, 2] = torch.randint(16, 24, (300_000,), generator=gen).float()
        return ev.to(device), 300_000, dict(num_bins=5, height=260, width=346)
    if name == "skewed_unsorted_batch":
        ev = torch.stack([_events(50_000, 50_000, 260, 346, seed=i) for i in range(3)])
        ev[1, :, 2] = 259.0                       # the last, shorter band
        ev[2, 1:-1] = ev[2, 1 + torch.randperm(49_998, generator=gen)]
        return ev.to(device), None, dict(num_bins=5, height=260, width=346)
    if name == "outside":           # x or y outside the image: dropped
        ev = _events(100_000, 100_000, 260, 346, seed=7)
        ev[1:50_000:7, 1] = 346.0
        ev[2:50_000:11, 2] = -1.0
        return ev.to(device), 100_000, dict(num_bins=5, height=260, width=346)
    if name == "odd_grid_batch":    # width 45, a shorter last band
        ev = torch.stack([_events(9_000, 9_000 - 1000 * i, 370, 45, seed=i)
                          for i in range(3)])
        return ev.to(device), torch.tensor([9_000, 8_000, 7_000]), dict(
            num_bins=3, height=370, width=45)
    if name == "one_row":
        ev = _events(5_000, 5_000, 1, 346, seed=8)
        return ev.to(device), 5_000, dict(num_bins=5, height=1, width=346)
    if name == "wide_grid_batch":   # rows of 12.8 KB: 4500 tiles per window,
        ev = torch.stack([_events(100_000, 100_000, 1500, 3200, seed=i)
                          for i in range(2)])             # > 48 KB of smem
        return ev.to(device), None, dict(num_bins=3, height=1500, width=3200)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ragged_batch", "unsorted", "skewed",
                                  "skewed_unsorted_batch", "outside",
                                  "odd_grid_batch", "one_row", "wide_grid_batch"])
def test_voxel_kernels_batched_and_irregular(device, name):
    """K6 and K7 against their plain versions on window batches (one launch
    sequence per batch, n_valid = 0 inside one), unsorted and skewed
    events, events outside the image, ragged and wide grids."""
    ev, n_valid, kw = _voxel_case(name, device)
    _check_voxelizers(ev, n_valid, matmul=name != "wide_grid_batch", **kw)


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


# forced K3/K4 plans beyond the planner's kinds: splits of 4, a split of
# 2 at C = 96, a tile larger than the image, 1x1 tiles, 16-channel slabs
K3_K4_EXTRA_PLANS = {(1, 64, 88, 128): (gru_hside.LstmPlan(16, 12, 4, 1, 64),),
                     (1, 32, 44, 256): (gru_hside.LstmPlan(4, 12, 4, 2, 64),
                                        gru_hside.LstmPlan(8, 8, 4, 0, 16)),
                     (3, 30, 45, 96): (gru_hside.LstmPlan(7, 12, 2, 0, 32),),
                     (2, 5, 3, 48): (gru_hside.LstmPlan(1, 1, 1, 2, 16),
                                     gru_hside.LstmPlan(8, 8, 1, 1, 16))}


@pytest.mark.parametrize("shape", [(1, 128, 176, 64), (1, 64, 88, 128),
                                   (1, 32, 44, 256), (3, 30, 45, 96),
                                   (1, 128, 256, 64), (1, 64, 128, 128),
                                   (1, 32, 64, 256), (2, 5, 3, 48)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_kernels_match_plain(device, shape):
    """K3 (h', c') and K4 (h_t, h_new, c_new), bf16, one cell, gx a strided
    view: within 2e-2 of their plain versions under every plan kind the
    planner can pick at the shape (its own through the default path) and
    the forced plans of K3_K4_EXTRA_PLANS, one launch each; the phased
    shapes (W=44 included), the flagship ones, a ragged one with B > 1 and
    an edge one.  The IEEE-gate build (LSTM_EXACT_GATES) under the
    planner's plan too."""
    from rpg_ramnet_tpu_torch.ops import phased_cell
    h, c, gx, w4, tau, phase, t = _lstm_inputs(shape, device, seed=shape[2])
    with torch.no_grad():
        want3 = gru_hside.conv_lstm_hside_plain(h, c, gx, w4)
        want4 = phased_cell.conv_lstm_phased_plain(h, c, gx, w4, tau, phase, t)
    built = gru_hside.library_lstm
    exact = built(gru_hside.LSTM_EXACT_GATES)
    for phased, fn, want, counter in (
            (False, lambda **kw: gru_hside.conv_lstm_hside(h, c, gx, w4, **kw),
             want3, gru_hside.conv_lstm_hside),
            (True, lambda **kw: phased_cell.conv_lstm_phased(
                h, c, gx, w4, tau, phase, t, **kw), want4,
             phased_cell.conv_lstm_phased)):
        kinds = gru_hside.lstm_plan_kinds(*shape, phased=phased)
        runs = ([(p, False) for p in kinds + list(K3_K4_EXTRA_PLANS.get(shape, ()))]
                + [(kinds[0], True)])
        for i, (plan, ieee) in enumerate(runs):
            n = counter.launches
            try:
                if ieee:
                    gru_hside.library_lstm = lambda defines=(): exact
                with torch.no_grad():
                    got = fn(**({"_plan": plan} if i else {}))
                torch.cuda.synchronize()
            finally:
                gru_hside.library_lstm = built
            assert counter.launches - n == 1
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.shape == shape
                err = (a.float() - b.float()).abs().max().item()
                assert err <= 2e-2, (plan, ieee, err)


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


# forced K3-res/K4-res plans beyond the planner's kinds: a split of 2 at
# C = 96 (48 channels a block), ragged tiles, 1x1 tiles, a tile larger
# than the image, 16-channel slabs
LSTM_EXTRA_PLANS = {(3, 30, 45, 96): (gru_hside.LstmPlan(7, 12, 2, 0, 32),
                                      gru_hside.LstmPlan(4, 16, 1, 2, 16)),
                    (2, 5, 3, 48): (gru_hside.LstmPlan(1, 1, 1, 2, 16),
                                    gru_hside.LstmPlan(8, 8, 1, 1, 16))}


@pytest.mark.parametrize("shape", [(8, 112, 112, 64), (8, 56, 56, 128),
                                   (8, 28, 28, 256), (3, 30, 45, 96),
                                   (2, 5, 3, 48)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_res_kernels_match_plain(device, shape):
    """K3-res (h', c', acts) and K4-res (h_t, h_new, c_new, acts), bf16,
    one cell, gx a strided view: within 2e-2 of their plain versions under
    every plan kind the planner can pick at the shape (split 1 and 2) and
    the forced plans of LSTM_EXTRA_PLANS, one launch each; their outputs
    within 2e-2 of K3's and K4's."""
    from rpg_ramnet_tpu_torch.ops import phased_cell
    h, c, gx, w4, tau, phase, t = _lstm_inputs(shape, device, seed=shape[2])
    with torch.no_grad():
        want3 = gru_hside.conv_lstm_hside_res_plain(h, c, gx, w4)
        want4 = phased_cell.conv_lstm_phased_res_plain(h, c, gx, w4, tau,
                                                       phase, t)
        fwd3 = gru_hside.conv_lstm_hside(h, c, gx, w4)
        fwd4 = phased_cell.conv_lstm_phased(h, c, gx, w4, tau, phase, t)
    extra = LSTM_EXTRA_PLANS.get(shape, ())
    for phased, fn, want, fwd in (
            (False, lambda **kw: gru_hside.conv_lstm_hside_res(h, c, gx, w4, **kw),
             want3, fwd3),
            (True, lambda **kw: phased_cell.conv_lstm_phased_res(
                h, c, gx, w4, tau, phase, t, **kw), want4, fwd4)):
        counter = (phased_cell.conv_lstm_phased_res if phased
                   else gru_hside.conv_lstm_hside_res)
        kinds = gru_hside.lstm_plan_kinds(*shape, phased=phased, residuals=True)
        if shape[-1] >= 128:
            assert {p.split for p in kinds} == {1, 2}
        for i, plan in enumerate(kinds + list(extra)):
            n = counter.launches
            with torch.no_grad():
                got = fn(**({"_plan": plan} if i else {}))
            torch.cuda.synchronize()
            assert counter.launches - n == 1
            for a, b in zip(got, want):
                assert a.shape == b.shape
                err = (a.float() - b.float()).abs().max().item()
                assert err <= 2e-2, (plan, err)
            for a, b in zip(got, fwd):
                assert (a.float() - b.float()).abs().max().item() <= 2e-2, plan


def _lstm_layer_grads(mod, x, c0, h0, gx, t, cots, kind, fused):
    """Gradients of sum(out * cot) through the ConvLSTMHside Function
    (kind 'lstm_hside', on gx) or the phased layer (on x), fused (bf16
    inputs: the Functions, K3-res and K4-res) or plain (float32 inputs:
    ConvLSTM.hside, PhasedConvLSTM.forward(fused=False))."""
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc
    dt = torch.bfloat16 if fused else torch.float32
    mod.zero_grad()
    ins = [v.to(dt).requires_grad_() for v in (x, c0, h0, gx)]
    x, c0, h0, gx = ins
    if kind == "lstm_hside":
        if fused:
            outs = gru_hside.conv_lstm_hside(c0, h0, gx, mod.lstm.hside_weights())
        else:
            outs = [to_nhwc(v) for v in mod.lstm.hside(
                to_nchw(gx), (to_nchw(c0), to_nchw(h0)))]
        params = [mod.lstm.Gates.weight]
    else:
        y, (hn, cn) = mod(to_nchw(x), t, (to_nchw(c0), to_nchw(h0)),
                          fused=fused)
        outs = [to_nhwc(v) for v in (y, hn, cn)]
        params = list(mod.parameters())
    sum((o.float() * g).sum() for o, g in zip(outs, cots)).backward()
    return [v.grad for v in ins if v.grad is not None] + [
        p.grad.clone() for p in params]


@pytest.mark.parametrize("kind", ["lstm_hside", "phased"])
def test_lstm_functions_kernels_match_plain_layers(device, kind):
    """The ConvLSTMHside and PhasedCell Functions on the card (bf16,
    float32 master weights, the live tau and phase) against autograd
    through the plain layers in float32 on the same values: every
    gradient (inputs, weights, tau, phase) within 2e-2 of the plain one's
    largest magnitude; one K3-res or K4-res launch."""
    from rpg_ramnet_tpu_torch.models.layers import PhasedConvLSTM
    from rpg_ramnet_tpu_torch.ops import phased_cell
    B, H, W, C = 3, 30, 45, 96
    gen = torch.Generator().manual_seed(1)
    mod = PhasedConvLSTM(C, C, H, W)
    torch.nn.init.uniform_(mod.lstm.Gates.weight, -0.05, 0.05, generator=gen)
    mod.phased_cell.reset_parameters_(gen)
    mod.to(device)

    def bf16_valued(*shape, scale=1.0):
        v = (torch.rand(*shape, generator=gen) * 2 - 1) * scale
        return v.to(device, torch.bfloat16).float()

    x, c0 = bf16_valued(B, H, W, C), bf16_valued(B, H, W, C)
    h0, gx = bf16_valued(B, H, W, C, scale=2.0), bf16_valued(B, H, W, 4 * C)
    t = (torch.rand(B, generator=gen) * 3).to(device)
    cots = [torch.randn(B, H, W, C, generator=gen).to(device) for _ in range(3)]
    counter = (gru_hside.conv_lstm_hside_res if kind == "lstm_hside"
               else phased_cell.conv_lstm_phased_res)
    n = counter.launches
    got = _lstm_layer_grads(mod, x, c0, h0, gx, t, cots, kind, True)
    torch.cuda.synchronize()
    assert counter.launches - n == 1
    want = _lstm_layer_grads(mod, x, c0, h0, gx, t, cots, kind, False)
    assert len(got) == len(want) == (4 if kind == "lstm_hside" else 7)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _rel_err(a, b) <= 2e-2


@pytest.mark.parametrize("recipe", ["phased", "lstm_comb"])
def test_lstm_training_step_kernels_vs_off(device, recipe):
    """One TBPTT loss and backward of a small bf16 model of each recipe
    with the kernels and with fused_gru='off', from the same weights: the
    phased recipe with fused_gru='on' runs K4-res in its encoders and
    K3-res in its state combination, the ConvLSTM combination with
    precompute_x under 'auto' K3-res, each twice per cell (the
    recompute); the loss within 2e-2 relative and every parameter
    gradient (tau and phase included) at cosine >= 0.95 of 'off'."""
    from rpg_ramnet_tpu_torch.core.config import Config, TrainerConfig
    from rpg_ramnet_tpu_torch.ops import phased_cell
    from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
    B, L, K, H, W = 2, 3, 2, 64, 96
    phased = recipe == "phased"
    mcfg = ModelConfig(num_encoders=3, base_num_channels=16,
                       recurrent_block_type="convlstm" if phased else "conv",
                       state_combination="convlstm", use_phased_arch=phased,
                       spatial_resolution=(H, W), num_residual_blocks=1,
                       every_x_rgb_frame=K, compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    batch = {"events": torch.randn(B, L, K, H, W, 5, generator=gen),
             "image": torch.rand(B, L, H, W, 1, generator=gen),
             "depth_events": torch.rand(B, L, K, H, W, 1, generator=gen),
             "depth_image": torch.rand(B, L, H, W, 1, generator=gen)}
    if phased:
        stamps = torch.cumsum(torch.rand(B, L * (K + 1), generator=gen) * 0.1, 1)
        stamps = stamps.view(B, L, K + 1)
        batch.update(times_events=stamps[..., :K].contiguous(),
                     times_image=stamps[..., K].contiguous())
    batch = {k: v.to(device) for k, v in batch.items()}
    out, weights = {}, None
    for mode in ("on" if phased else "auto", "off"):
        cfg = Config(model=dataclasses.replace(mcfg, fused_gru=mode),
                     use_phased_arch=phased, grad_loss_weight=0.25,
                     trainer=TrainerConfig(deferred_decode=True,
                                           precompute_x=not phased,
                                           sequence_length=L))
        model = ERGB2DepthRecurrent(cfg.model, device=device)
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        n = (gru_hside.conv_lstm_hside_res.launches,
             phased_cell.conv_lstm_phased_res.launches)
        loss, _ = make_sequence_loss(cfg, remat=True)(
            model, model.init_state(B, H, W), batch)
        loss.backward()
        torch.cuda.synchronize()
        launched = (gru_hside.conv_lstm_hside_res.launches - n[0],
                    phased_cell.conv_lstm_phased_res.launches - n[1])
        cells = 2 * 3 * (K + 1) * L
        want = (0, 0) if mode == "off" else (cells, cells if phased else 0)
        assert launched == want
        out[mode] = (loss.item(), {k: p.grad.float().flatten()
                                   for k, p in model.named_parameters()})
    (l_on, g_on), (l_off, g_off) = out.values()
    assert abs(l_on - l_off) <= 2e-2 * abs(l_off)
    for k, g in g_off.items():
        cos = torch.nn.functional.cosine_similarity(g_on[k], g, dim=0)
        assert cos.item() >= 0.95, k


def _gru_weights(C, seed, device):
    cell = ConvGRU(C, C)
    cell.reset_parameters_(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return tuple(w.to(device) for w in cell.hside_weights(torch.bfloat16))


def _h_gx(shape, device, gen, steps=None):
    """bf16 h in (-1, 1) and gx ~ N(0, 1): a strided [B, H, W, 3C] view, or
    a [steps, H, W, 3C] buffer."""
    B, H, W, C = shape
    h = (torch.rand(B, H, W, C, device=device, generator=gen) * 2 - 1).bfloat16()
    if steps is None:
        gx = torch.randn(B, 2, H, W, 3 * C, device=device, generator=gen)
        return h, gx.bfloat16()[:, 1]
    return h, torch.randn(steps, H, W, 3 * C, device=device, generator=gen).bfloat16()


@pytest.mark.parametrize("pair", [((1, 128, 256, 64), (1, 64, 128, 128)),
                                  ((2, 30, 45, 96), (2, 15, 23, 32))],
                         ids=["flagship", "ragged"])
def test_pair_kernel_matches_plain(device, pair):
    """K9: both scales within 2e-2 of two plain cells, one launch; gx as
    strided views."""
    from rpg_ramnet_tpu_torch.ops import gru_pair
    gen = torch.Generator(device=device).manual_seed(0)
    args = []
    for shape in pair:
        args += [*_h_gx(shape, device, gen), *_gru_weights(shape[-1], shape[-1], device)]
    n0 = gru_pair.conv_gru_hside_pair.launches
    with torch.no_grad():
        got = gru_pair.conv_gru_hside_pair(*args)
        want = gru_pair.conv_gru_hside_pair_plain(*args)
    torch.cuda.synchronize()
    assert gru_pair.conv_gru_hside_pair.launches == n0 + 1
    for a, b, shape in zip(got, want, pair):
        assert a.shape == shape
        assert (a.float() - b.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("pair", [((1, 128, 256, 64), (1, 64, 128, 128)),
                                  ((2, 30, 45, 96), (2, 15, 23, 32))],
                         ids=["flagship", "ragged"])
def test_pair_kernels_every_plan_kind(device, pair):
    """K9 (gx as strided views) and K10b (batch 1: step 5 of a 7-step
    buffer) under every kind of pair launch (gru_pair.k9_plan_kinds: splits
    1 + 2, 1 + 1 and 2 + 2, every combo, padding blocks, both block
    orders) within K1's 8e-3 of their plain versions: each scale runs K1's
    tile under a K1 plan."""
    from rpg_ramnet_tpu_torch.ops import gru_pair, gru_stream
    gen = torch.Generator(device=device).manual_seed(5)
    args, seq = [], []
    for shape in pair:
        w = _gru_weights(shape[-1], shape[-1] + 1, device)
        args += [*_h_gx(shape, device, gen), *w]
        seq += [*_h_gx((1,) + shape[1:], device, gen, steps=7), *w]
    sel = torch.tensor([5], dtype=torch.int32, device=device)
    with torch.no_grad():
        want = gru_pair.conv_gru_hside_pair_plain(*args)
        want_seq = gru_stream.conv_gru_hside_stream_pair_plain(*seq, sel)
        for plans, first in gru_pair.k9_plan_kinds(*pair):
            got = gru_pair.conv_gru_hside_pair(*args, _plan=plans, _first=first)
            got_seq = gru_stream.conv_gru_hside_stream_pair(*seq, sel, _plan=plans,
                                                            _first=first)
            for a, b in zip(got + got_seq, want + want_seq):
                err = (a.float() - b.float()).abs().max().item()
                assert err <= 8e-3, (plans, first, err)


def test_stream_kernels_match_plain(device):
    """K10a and K10b at a step of a 12-step buffer, and at the buffer's
    last step, within 2e-2 of their plain versions."""
    from rpg_ramnet_tpu_torch.ops import gru_stream
    gen = torch.Generator(device=device).manual_seed(1)
    (h0, g0), (h1, g1) = (_h_gx(s, device, gen, steps=12)
                          for s in ((1, 64, 128, 64), (1, 32, 64, 128)))
    w0, w1 = _gru_weights(64, 3, device), _gru_weights(128, 4, device)
    n = (gru_stream.conv_gru_hside_stream.launches,
         gru_stream.conv_gru_hside_stream_pair.launches)
    with torch.no_grad():
        for step in (7, 11):
            sel = torch.tensor([step], dtype=torch.int32, device=device)
            got = gru_stream.conv_gru_hside_stream(h0, g0, sel, *w0)
            want = gru_stream.conv_gru_hside_stream_plain(h0, g0, sel, *w0)
            assert (got.float() - want.float()).abs().max().item() <= 2e-2
            pair = gru_stream.conv_gru_hside_stream_pair(h0, g0, *w0, h1, g1, *w1, sel)
            want = gru_stream.conv_gru_hside_stream_pair_plain(h0, g0, *w0, h1, g1,
                                                               *w1, sel)
            for a, b in zip(pair, want):
                assert (a.float() - b.float()).abs().max().item() <= 2e-2
    torch.cuda.synchronize()
    assert (gru_stream.conv_gru_hside_stream.launches - n[0],
            gru_stream.conv_gru_hside_stream_pair.launches - n[1]) == (2, 2)


@pytest.mark.parametrize("blocks", [0, 5], ids=["co_resident", "5_blocks"])
def test_chunk_kernel_every_step_matches_plain(device, blocks):
    """K11 over 48 steps (K=5) at the flagship scale 0 (128 tiles), with
    the grid the kernel picks and with 5 blocks looping over the tiles:
    every snapshot within 2e-2 of one plain cell on the kernel's previous
    snapshot, so a stale or raced read of h at any step shows; and the
    trajectory within 2e-2 of the plain loop."""
    from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_hside
    K, S = 5, 48
    gen = torch.Generator(device=device).manual_seed(2)
    h0, gseq = _h_gx((1, 128, 256, 64), device, gen, steps=S)
    w_ev, w_im = _gru_weights(64, 5, device), _gru_weights(64, 6, device)
    n0 = gru_chunk.conv_gru_hside_chunk.launches
    with torch.no_grad():
        snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gseq, h0, K, blocks=blocks)
        grid = gru_chunk.conv_gru_hside_chunk.last_grid
        prev = torch.cat([h0, snaps[:-1]])
        image = torch.arange(S, device=device) % (K + 1) == K
        want = torch.empty_like(snaps)
        want[~image] = gru_hside.conv_gru_hside_plain(prev[~image], gseq[~image], *w_ev)
        want[image] = gru_hside.conv_gru_hside_plain(prev[image], gseq[image], *w_im)
        free = gru_chunk.conv_gru_hside_chunk_plain(w_ev, w_im, gseq, h0, K)
    torch.cuda.synchronize()
    assert gru_chunk.conv_gru_hside_chunk.launches == n0 + 1
    assert grid == (blocks or 128)
    assert (snaps.float() - want.float()).abs().max().item() <= 2e-2
    assert (snaps.float() - free.float()).abs().max().item() <= 2e-2


def test_chunk_kernel_oversized_grid_raises(device):
    """A cooperative grid larger than the blocks that fit at once fails the
    launch, and the wrapper raises (no fallback); the next launch runs."""
    from rpg_ramnet_tpu_torch.ops import gru_chunk
    gen = torch.Generator(device=device).manual_seed(3)
    h0, gseq = _h_gx((1, 32, 64, 256), device, gen, steps=6)
    w = _gru_weights(256, 7, device)
    with torch.no_grad(), pytest.raises(RuntimeError, match="cooperative"):
        gru_chunk.conv_gru_hside_chunk(w, w, gseq, h0, 5, blocks=1 << 20)
    with torch.no_grad():
        got = gru_chunk.conv_gru_hside_chunk(w, w, gseq, h0, 5)
        want = gru_chunk.conv_gru_hside_chunk_plain(w, w, gseq, h0, 5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


# K10a's and K11's shapes (batch 1): the flagship scales, a ragged one,
# and K1's edge shapes (H or W below the tile, H = W = 1, C = 16, 48)
VARIANT_CELLS = [(1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256),
                 (1, 30, 45, 96), (1, 5, 40, 64), (1, 9, 3, 128),
                 (1, 3, 37, 256), (1, 1, 1, 64), (1, 20, 24, 16),
                 (1, 17, 19, 48)]


@pytest.mark.parametrize("shape", VARIANT_CELLS, ids=lambda s: "x".join(map(str, s)))
def test_k10a_plans_match_plain(device, shape):
    """K10a at step 7 of a 12-step buffer within K1's 8e-3 of its plain
    version under every plan kind K1's planner can pick at the shape (its
    own pick through the wrapper's default path), one launch each."""
    from rpg_ramnet_tpu_torch.ops import gru_stream
    gen = torch.Generator(device=device).manual_seed(shape[-1])
    h, gseq = _h_gx(shape, device, gen, steps=12)
    w = _gru_weights(shape[-1], 8, device)
    sel = torch.tensor([7], dtype=torch.int32, device=device)
    with torch.no_grad():
        want = gru_stream.conv_gru_hside_stream_plain(h, gseq, sel, *w)
        for i, plan in enumerate(gru_hside.k1_plan_kinds(*shape)):
            n0 = gru_stream.conv_gru_hside_stream.launches
            got = gru_stream.conv_gru_hside_stream(h, gseq, sel, *w,
                                                   **({"_plan": plan} if i else {}))
            torch.cuda.synchronize()
            assert gru_stream.conv_gru_hside_stream.launches == n0 + 1
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 8e-3, (plan, err)


def test_k10a_refuses_bad_plans(device):
    """A plan K1's tile cannot run raises before the launch; an argument
    K10a's C entry refuses comes back as the launch's CUDA error text."""
    from rpg_ramnet_tpu_torch.ops import gru_stream
    gen = torch.Generator(device=device).manual_seed(9)
    h, gseq = _h_gx((1, 16, 16, 96), device, gen, steps=4)
    w_ur, w_o = _gru_weights(96, 9, device)
    sel = torch.tensor([1], dtype=torch.int32, device=device)
    for bad in (gru_hside.K1Plan(8, 8, 4, 0, 32), gru_hside.K1Plan(8, 8, 1, 3, 32),
                gru_hside.K1Plan(8, 8, 1, 0, 64), gru_hside.K1Plan(64, 64, 1, 0, 32)):
        with pytest.raises(ValueError):
            gru_stream.conv_gru_hside_stream(h, gseq, sel, w_ur, w_o, _plan=bad)
    lib = gru_hside.library()
    out = torch.empty_like(h)
    for split, combo, ks, steps in ((4, 0, 32, 4), (1, 0, 48, 4), (1, 3, 32, 4),
                                    (1, 0, 32, 0)):   # the C entry's own check
        err = lib.ramnet_gru_hside_forward_sel(
            h.data_ptr(), gseq.data_ptr(), sel.data_ptr(), w_ur.data_ptr(),
            w_o.data_ptr(), out.data_ptr(), 16, 16, 96, steps, 8, 8, split, combo,
            ks, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="invalid argument"):
            gru_hside._raise_on(err, lib, "gru_stream")


def _teacher_forced_err(snaps, h0, gseq, w_ev, w_im, K):
    """Every snapshot against one plain cell on the kernel's previous one."""
    prev = torch.cat([h0, snaps[:-1]])
    image = torch.arange(len(snaps), device=snaps.device) % (K + 1) == K
    want = torch.empty_like(snaps)
    want[~image] = gru_hside.conv_gru_hside_plain(prev[~image], gseq[~image], *w_ev)
    want[image] = gru_hside.conv_gru_hside_plain(prev[image], gseq[image], *w_im)
    return (snaps.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("blocks", [0, 5], ids=["co_resident", "5_blocks"])
@pytest.mark.parametrize("shape", [(1, 64, 128, 128), (1, 32, 64, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chunk_kernel_split_plans_match_plain(device, shape, blocks):
    """K11 over 48 steps (K=5) with cluster-split plans (the planner's, in
    clusters of 2) under the planner's grid (one cluster per tile, all
    resident) and under 5 blocks, rounded up to 3 clusters that loop over
    the tiles: every snapshot within 2e-2 of one plain cell on the
    kernel's previous snapshot, so a read of h across clusters that the
    grid barrier did not order shows at its step."""
    from rpg_ramnet_tpu_torch.ops import gru_chunk
    K, S = 5, 48
    gen = torch.Generator(device=device).manual_seed(shape[-1])
    h0, gseq = _h_gx(shape, device, gen, steps=S)
    C = shape[-1]
    w_ev, w_im = _gru_weights(C, 10, device), _gru_weights(C, 11, device)
    n0 = gru_chunk.conv_gru_hside_chunk.launches
    with torch.no_grad():
        snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gseq, h0, K, blocks=blocks)
        plan = gru_chunk.conv_gru_hside_chunk.last_plan
        grid = gru_chunk.conv_gru_hside_chunk.last_grid
        err = _teacher_forced_err(snaps, h0, gseq, w_ev, w_im, K)
    torch.cuda.synchronize()
    assert gru_chunk.conv_gru_hside_chunk.launches == n0 + 1
    assert plan.split == 2
    assert grid == (6 if blocks else gru_chunk.tiles(plan, *shape[1:3]) * 2)
    assert err <= 2e-2, err


@pytest.mark.parametrize("shape", VARIANT_CELLS, ids=lambda s: "x".join(map(str, s)))
def test_k11_plans_match_plain(device, shape):
    """K11 over 12 steps (K=5: two packages) under every plan kind its
    planner can pick at the shape (its own pick through the wrapper's
    default path): every snapshot within 2e-2 of one plain cell on the
    kernel's previous snapshot, one launch each, the grid one cluster per
    tile up to the clusters that fit at once."""
    from rpg_ramnet_tpu_torch.ops import gru_chunk
    K, S = 5, 12
    C = shape[-1]
    gen = torch.Generator(device=device).manual_seed(C + 1)
    h0, gseq = _h_gx(shape, device, gen, steps=S)
    w_ev, w_im = _gru_weights(C, 12, device), _gru_weights(C, 13, device)

    def resident(p):
        return gru_chunk.resident_clusters(device.index or 0, C, p)

    with torch.no_grad():
        for i, plan in enumerate(gru_chunk.k11_plan_kinds(*shape[1:], resident)):
            n0 = gru_chunk.conv_gru_hside_chunk.launches
            snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gseq, h0, K,
                                                   **({"_plan": plan} if i else {}))
            torch.cuda.synchronize()
            assert gru_chunk.conv_gru_hside_chunk.launches == n0 + 1
            assert gru_chunk.conv_gru_hside_chunk.last_plan == plan
            assert gru_chunk.conv_gru_hside_chunk.last_grid == plan.split * min(
                gru_chunk.tiles(plan, *shape[1:3]), resident(plan))
            err = _teacher_forced_err(snaps, h0, gseq, w_ev, w_im, K)
            assert err <= 2e-2, (plan, err)


def test_chunked_variants_kernels_vs_off(device):
    """A small flagship-shaped bf16 model on the precomputed path: each
    launch variant launches its kernels the derived number of times, and
    its predictions stay within 5e-2 of fused_gru='off'."""
    from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_pair, gru_stream
    cfg = ModelConfig(num_encoders=3, base_num_channels=16,
                      recurrent_block_type="conv", state_combination="convgru",
                      num_residual_blocks=1, every_x_rgb_frame=2,
                      compute_dtype="bfloat16")
    off = ERGB2DepthRecurrent(dataclasses.replace(cfg, fused_gru="off"), device=device)
    gen = torch.Generator().manual_seed(4)
    seq = {"events": torch.randn(1, 3, 2, 64, 96, 5, generator=gen).to(device),
           "image": torch.rand(1, 3, 64, 96, 1, generator=gen).to(device)}
    _, p_off = off.forward_sequence_precomputed(off.init_state(1, 64, 96), seq)
    counters = (gru_hside.conv_gru_hside, gru_pair.conv_gru_hside_pair,
                gru_stream.conv_gru_hside_stream, gru_stream.conv_gru_hside_stream_pair,
                gru_chunk.conv_gru_hside_chunk)
    steps = 3 * 3                      # L * (K + 1)
    for over, kw, want in (({"fused_pair": "on"}, {}, (steps, steps, 0, 0, 0)),
                           ({"fused_stream": "on"}, {}, (0, 0, 3 * steps, 0, 0)),
                           ({"fused_stream": "on", "fused_pair": "on"}, {},
                            (0, 0, steps, steps, 0)),
                           ({}, {"chunk_cells": True}, (0, 0, 0, 0, 3))):
        model = ERGB2DepthRecurrent(dataclasses.replace(cfg, **over), device=device)
        model.load_state_dict(off.state_dict())
        n = [c.launches for c in counters]
        _, p = model.forward_sequence_precomputed(model.init_state(1, 64, 96), seq, **kw)
        torch.cuda.synchronize()
        assert tuple(c.launches - m for c, m in zip(counters, n)) == want, over
        for k in p_off:
            assert torch.isfinite(p[k]).all()
            assert (p[k] - p_off[k]).abs().max().item() <= 5e-2, (over, k)


# the flagship decoder layers at 256x512 (B, C, Cout, H, W of the input),
# at the per-package decode batch 6, and ragged ones: odd H and W, C = 48
# (16-channel slabs), Cout = 24 (three n8 tiles), Cout = 96 (two channel
# slices, the second partial); and the border shapes, H, W in {1, 2, 3}
# (the top and bottom, left and right border terms on the same pixels),
# at C = 32 with Cout = 24 (a ragged channel slice) and 128
DECODER_LAYERS = ([(6, 256, 128, 32, 64), (6, 128, 64, 64, 128),
                   (6, 64, 32, 128, 256), (3, 48, 24, 13, 27),
                   (2, 32, 96, 9, 17)]
                  + [(2, 32, cout, h, w) for cout in (24, 128)
                     for h in (1, 2, 3) for w in (1, 2, 3)])


def _decoder_inputs(shape, device, seed=0):
    from rpg_ramnet_tpu_torch.models.layers import UpsampleConvLayer, init_conv_
    B, C, Cout, H, W = shape
    gen = torch.Generator().manual_seed(seed)
    layer = UpsampleConvLayer(C, Cout, 5, padding=2)
    init_conv_(layer.conv2d, gen)
    layer.to(device)
    x = torch.randn(B, H, W, C, generator=gen).to(device, torch.bfloat16)
    skip = torch.randn(B, H, W, C, generator=gen).to(device, torch.bfloat16)
    return layer, x, skip


@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "no_skip"])
@pytest.mark.parametrize("shape", DECODER_LAYERS,
                         ids=lambda s: "x".join(map(str, s)))
def test_upsample_conv_kernel_matches_plain(device, shape, with_skip):
    """K8 against its plain version (the two-stage layer in bf16): max abs
    error over the plain version's max magnitude within 2e-2, and against
    the float32 plain version alike; one launch per call."""
    from rpg_ramnet_tpu_torch.ops import upsample_conv
    layer, x, skip = _decoder_inputs(shape, device)
    skip = skip if with_skip else None
    w, b = layer.conv2d.weight, layer.conv2d.bias
    n0 = upsample_conv.upsample_conv_fused.launches
    with torch.no_grad():
        got = upsample_conv.upsample_conv_fused(layer, x, skip)
        want = upsample_conv.upsample_conv_fused_plain(w, b, x, skip)
        want32 = upsample_conv.upsample_conv_fused_plain(
            w, b, x.float(), None if skip is None else skip.float())
    torch.cuda.synchronize()
    assert upsample_conv.upsample_conv_fused.launches == n0 + 1
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel_err(got, want) <= 2e-2
    assert _rel_err(got, want32) <= 2e-2


def test_upsample_conv_kernel_refuses(device):
    """No fallback: a float32 input, an NCHW-contiguous input and autograd
    raise on the card."""
    from rpg_ramnet_tpu_torch.ops import upsample_conv
    layer, x, _ = _decoder_inputs((2, 32, 16, 8, 8), device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="K8"):
            upsample_conv.upsample_conv_fused(layer, x.float())
        with pytest.raises(ValueError, match="K8"):
            upsample_conv.upsample_conv_fused(
                layer, x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    with pytest.raises(RuntimeError, match="no gradient"):
        upsample_conv.upsample_conv_fused(layer, x)


def test_composed_layer_matches_two_stage(device):
    """The composed layer (library transposed conv and the border
    restitch) against the two-stage layer on the card, bf16, at the
    flagship's widest-map layer."""
    from rpg_ramnet_tpu_torch.models.layers import upsample_conv_layer_composed
    from rpg_ramnet_tpu_torch.utils.layout import to_nchw
    layer, x, skip = _decoder_inputs((6, 64, 32, 128, 256), device)
    s = to_nchw(x + skip)
    with torch.no_grad():
        got = upsample_conv_layer_composed(layer, s)
        want = layer(s)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 2e-2


def test_decoder_options_through_engines(device):
    """A small flagship-shaped bf16 model: with fused_decoder='on' the
    chunked engine launches K8 three times per chunk (one decode of the
    chunk, three layers) and the per-package engine three times per
    package; with composed_decoder='on' never; both within 5e-2 of the
    default decoder."""
    from rpg_ramnet_tpu_torch.eval import StreamingInference, run_chunked_streaming
    from rpg_ramnet_tpu_torch.ops import upsample_conv
    cfg = ModelConfig(num_encoders=3, base_num_channels=16,
                      recurrent_block_type="conv", state_combination="convgru",
                      num_residual_blocks=1, every_x_rgb_frame=2,
                      compute_dtype="bfloat16")
    base = ERGB2DepthRecurrent(cfg, device=device)
    gen = torch.Generator().manual_seed(5)
    items = [{"events": torch.randn(1, 2, 64, 96, 5, generator=gen).numpy(),
              "image": torch.rand(1, 64, 96, 1, generator=gen).numpy()}
             for _ in range(5)]

    class Data:
        datasets = [items]

    def chunked(model):
        out = {}
        run_chunked_streaming(Data(), model, chunk=2,
                              on_prediction=lambda g, p, it, pos: out.__setitem__(g, p))
        return out

    def per_package(model):
        eng = StreamingInference(model, batched_decode=True)
        return {i: eng.step({"events": it["events"][0], "image": it["image"][0]})
                for i, it in enumerate(items)}

    for run, per_run in ((chunked, 3 * 3), (per_package, 3 * 5)):
        want = run(base)
        for over, launches in (({"fused_decoder": "on"}, per_run),
                               ({"composed_decoder": "on"}, 0)):
            model = ERGB2DepthRecurrent(dataclasses.replace(cfg, **over),
                                        device=device)
            model.load_state_dict(base.state_dict())
            n0 = upsample_conv.upsample_conv_fused.launches
            got = run(model)
            torch.cuda.synchronize()
            assert upsample_conv.upsample_conv_fused.launches - n0 == launches
            for g in want:
                for k in want[g]:
                    assert abs(got[g][k] - want[g][k]).max() <= 5e-2, (over, g, k)
