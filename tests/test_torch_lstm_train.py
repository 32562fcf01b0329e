"""The port's ConvLSTM training cells: K3-res, K4-res, the ConvLSTM
backward and the ConvLSTMHside and PhasedCell Functions, and training the
phased regime and the ConvLSTM state combination.

The same numpy inputs from a seed go through the JAX package (its Pallas
kernels in interpret mode, its hand-derived VJPs ``_lstm_hside_bwd`` and
``_phased_cell_bwd``, its ``make_sequence_loss``) and through the port on
the CPU, where the wrappers run the kernels' plain versions.  Tolerances:
float32 forward 1e-5 (the same arithmetic summed in another order; the
phased outputs through the time gate's fmod at atol 2e-3 / rtol 1e-3, as
tests/test_phased.py:74-78); float32 gradients atol 5e-5 / rtol 1e-3 (the
JAX package's own fused-vs-unfused check, tests/test_train.py:671-674);
bf16 one bf16 ulp of the largest magnitude (2^-7 max|want|: both round at
the same places, but a sum in another order can tip a rounding).  The
kernels themselves are tested on a card in tests/test_torch_cuda.py.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import gru_hside as JG
from rpg_ramnet_tpu.ops import phased_cell as JP
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core import config as tconfig
from rpg_ramnet_tpu_torch.data import generate_split
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, statenet
from rpg_ramnet_tpu_torch.models.layers import (ConvLSTM, PhasedConvLSTM,
                                                PhasedLSTMGate)
from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
from rpg_ramnet_tpu_torch.train import trainer as ttrainer
from rpg_ramnet_tpu_torch.train.__main__ import main as train_main
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc

from test_train import tiny_config
from torch_threads import one_thread  # noqa: F401

B, H, W, C = 2, 8, 16, 16
TILE_H = 4              # the JAX kernels' H tile: two tiles, so halos show
LEAK, RATIO_ON = phased_cell.LEAK, phased_cell.RATIO_ON
ATOL_F32 = 1e-5
ATOL_FMOD, RTOL_FMOD = 2e-3, 1e-3
ATOL_GRAD, RTOL_GRAD = 5e-5, 1e-3
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, dtype, atol=ATOL_F32, rtol=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "bf16":
        atol, rtol = 2.0 ** -7 * max(np.abs(want).max(), 1e-30), 0.0
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _t(x, tdt=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(tdt)


def _cell(rng):
    """A ConvLSTM on cat(x, h) with x and h of C channels (torch's init
    range x3, biases in (-0.5, 0.5)) and the JAX HWIO tree of the same
    weights."""
    bound = 3.0 / np.sqrt(9 * 2 * C)
    w = rng.uniform(-bound, bound, (4 * C, 2 * C, 3, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, 4 * C).astype(np.float32)
    cell = ConvLSTM(C, C)
    with torch.no_grad():
        cell.Gates.weight.copy_(torch.from_numpy(w))
        cell.Gates.bias.copy_(torch.from_numpy(b))
    return cell, {"Gates": {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)),
                            "bias": jnp.asarray(b)}}


def _gate(rng, n=C * H * W):
    tau = np.exp(rng.uniform(np.log(0.02), np.log(50.0), n)).astype(np.float32)
    phase = (rng.uniform(0, 1, n) * tau).astype(np.float32)
    gate = PhasedLSTMGate(n)
    with torch.no_grad():
        gate.tau.copy_(torch.from_numpy(tau))
        gate.phase.copy_(torch.from_numpy(phase))
    return gate, tau, phase


def _inputs(seed, jdt):
    """The cell, its JAX tree, and NHWC h (conv operand; c0 for the phased
    cell), c (cell input; h0) of distinct values and ranges, gx, and the
    cotangents, as JAX arrays in jdt; tau, phase [H, W, C] and t [B, 1]."""
    rng = np.random.RandomState(seed)
    cell, tree = _cell(rng)
    gate, tau, phase = _gate(rng)
    arr = lambda *s, scale=1.0: jnp.asarray(  # noqa: E731
        (rng.uniform(-1, 1, s) * scale).astype(np.float32), jdt)
    h, c = arr(B, H, W, C), arr(B, H, W, C, scale=2.0)
    gx = jnp.asarray(rng.randn(B, H, W, 4 * C).astype(np.float32), jdt)
    gs = tuple(jnp.asarray(rng.randn(B, H, W, C).astype(np.float32), jdt)
               for _ in range(3))
    hwc = lambda v: jnp.moveaxis(jnp.asarray(v).reshape(C, H, W), 0, -1)  # noqa: E731
    t2 = jnp.asarray(np.array([[0.37], [12.9]], np.float32))
    return cell, tree, gate, h, c, gx, gs, hwc(tau), hwc(phase), t2


def _to_hwio(w):
    """Folded [9, 4C, C] -> HWIO [3, 3, C, 4C]."""
    return w.detach().float().reshape(3, 3, 4 * C, C).permute(0, 1, 3, 2)


# -- (a), (b): the residual kernels' plain versions -------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lstm_res_plain_matches_jax_residual_kernel(dtype):
    """(h', c', acts) of K3-res's plain version against
    _run_lstm(residuals=True) in interpret mode; the wrapper on CPU
    tensors is the plain version, no launch counted."""
    tdt, jdt = DTYPES[dtype]
    cell, tree, _, h, c, gx, _, _, _, _ = _inputs(0, jdt)
    (want_h, want_c), res = JG._lstm_hside_fwd(TILE_H, True, tree, gx, h, c)
    with torch.no_grad():
        w4 = cell.hside_weights(tdt)
    args = [_t(v, tdt) for v in (h, c, gx)] + [w4]
    got = gru_hside.conv_lstm_hside_res_plain(*args)
    n0 = gru_hside.conv_lstm_hside_res.launches
    wrapped = gru_hside.conv_lstm_hside_res(*args)
    assert gru_hside.conv_lstm_hside_res.launches == n0
    for g, w, shape in zip(got, (want_h, want_c, res[-1]),
                           ((B, H, W, C),) * 2 + ((B, H, W, 4 * C),)):
        assert g.dtype == tdt and g.shape == shape
        _close(g, w, dtype)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
    for a, b in zip(got[:2], gru_hside.conv_lstm_hside_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_phased_res_plain_matches_jax_residual_kernel(dtype):
    """(h_t, h_new, c_new, acts) of K4-res's plain version against
    _run_phased(residuals=True) in interpret mode, with distinct c0 and
    h0; the wrapper on CPU tensors is the plain version."""
    tdt, jdt = DTYPES[dtype]
    cell, tree, _, c0, h0, gx, _, tau, phase, t2 = _inputs(1, jdt)
    want, res = JP._phased_cell_fwd(TILE_H, LEAK, RATIO_ON, True, tree, gx,
                                    c0, h0, tau, phase, t2)
    with torch.no_grad():
        w4 = cell.hside_weights(tdt)
    args = ([_t(v, tdt) for v in (c0, h0, gx)] + [w4]
            + [_t(v) for v in (tau, phase)] + [_t(t2).reshape(B)])
    got = phased_cell.conv_lstm_phased_res_plain(*args)
    n0 = phased_cell.conv_lstm_phased_res.launches
    wrapped = phased_cell.conv_lstm_phased_res(*args)
    assert phased_cell.conv_lstm_phased_res.launches == n0
    for g, w in zip(got, tuple(want) + (res[-1],)):
        assert g.dtype == tdt
        _close(g, w, dtype, ATOL_FMOD, RTOL_FMOD)
    _close(got[3], res[-1], dtype)              # acts: no time gate
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
    for a, b in zip(got[:3], phased_cell.conv_lstm_phased_plain(*args)):
        assert torch.equal(a, b)


# -- (c), (d): the backward against the JAX VJPs ----------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lstm_bwd_matches_jax_vjp(dtype):
    """(dh, dc, dgx, dW) of conv_lstm_hside_bwd against _lstm_hside_bwd on
    the same residuals (JAX's K3-res outputs) and cotangents; the x slice
    of JAX's weight gradient is zero (it flows through the x side)."""
    tdt, jdt = DTYPES[dtype]
    cell, tree, _, h, c, gx, (gh, gc, _), _, _, _ = _inputs(2, jdt)
    _, res = JG._lstm_hside_fwd(TILE_H, True, tree, gx, h, c)
    dp, want_dgx, want_dh, want_dc = JG._lstm_hside_bwd(TILE_H, True, res,
                                                        (gh, gc))
    with torch.no_grad():
        w4 = cell.hside_weights(tdt)
    _, _, _, _, cell_new, acts = res
    dh, dc, dgx, dw = gru_hside.conv_lstm_hside_bwd(
        *(_t(v, tdt) for v in (gh, gc, h, c, cell_new, acts)), w4)
    assert dh.dtype == dc.dtype == tdt and dgx.shape == (B, H, W, 4 * C)
    want_w = np.asarray(dp["Gates"]["weight"], np.float32)
    assert np.abs(want_w[:, :, :C]).max() == 0
    for g, w in ((dh, want_dh), (dc, want_dc), (dgx.to(tdt), want_dgx),
                 (_to_hwio(dw), want_w[:, :, C:])):
        _close(g, w, dtype, ATOL_GRAD, RTOL_GRAD)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_phased_cell_backward_matches_jax_vjp(dtype):
    """PhasedCell's gradients (autograd through the Function on K4-res's
    plain version) against _phased_cell_bwd on JAX's residuals: dc0, dh0
    (distinct c0 and h0, so a missed slot swap shows), dgx, dW from the
    float32 master, and the time gate's dtau, dphase and dt through
    fmod."""
    tdt, jdt = DTYPES[dtype]
    cell, tree, _, c0, h0, gx, gs, tau, phase, t2 = _inputs(3, jdt)
    _, res = JP._phased_cell_fwd(TILE_H, LEAK, RATIO_ON, True, tree, gx, c0,
                                 h0, tau, phase, t2)
    dp, *want = JP._phased_cell_bwd(TILE_H, LEAK, RATIO_ON, True, res, gs)
    with torch.no_grad():
        w4 = cell.hside_weights(torch.float32)
    args = ([_t(v, tdt) for v in (c0, h0, gx)] + [w4]
            + [_t(v) for v in (tau, phase)] + [_t(t2).reshape(B)])
    args = [a.requires_grad_() for a in args]
    outs = phased_cell.PhasedCell.apply(*args)
    grads = torch.autograd.grad(outs, args, [_t(g, tdt) for g in gs])
    for g, a in zip(grads, args):
        assert g.dtype == a.dtype and g.shape == a.shape
    dc0, dh0, dgx, dw, dtau, dphase, dt = grads
    want_w = np.asarray(dp["Gates"]["weight"], np.float32)[:, :, C:]
    want_dgx, want_dc0, want_dh0, want_dtau, want_dphase, want_dt = want
    for g, w in ((dc0, want_dc0), (dh0, want_dh0), (dgx, want_dgx),
                 (_to_hwio(dw), want_w), (dtau, want_dtau),
                 (dphase, want_dphase), (dt, np.asarray(want_dt)[:, 0])):
        _close(g, w, dtype, ATOL_GRAD, RTOL_GRAD)
    assert float(np.abs(np.asarray(want_dtau)).max()) > 0
    assert float(np.abs(np.asarray(want_dt)).max()) > 0


# -- (e): gradcheck in float64 ----------------------------------------------

def _gradcheck_args(kind):
    gen = torch.Generator().manual_seed(0)
    b, h, w, c = 1, 5, 4, 8
    f64 = dict(generator=gen, dtype=torch.float64)
    args = [torch.rand(b, h, w, c, **f64) * 2 - 1,
            torch.rand(b, h, w, c, **f64) * 4 - 2,
            torch.randn(b, h, w, 4 * c, **f64),
            torch.randn(9, 4 * c, c, **f64) * 0.2]
    if kind == "phased":
        tau = torch.rand(h, w, c, **f64) * 1.5 + 0.5
        args += [tau, torch.rand(h, w, c, **f64) * tau,
                 torch.rand(b, **f64) * 3]
    return [a.requires_grad_() for a in args]


@pytest.mark.parametrize("kind", ["lstm_hside", "phased"])
def test_function_gradcheck_float64(kind):
    """Full-mode gradcheck of each Function's plain path (tau, phase and t
    included for the phased cell); on one thread, as the suite runs
    several test processes at once."""
    fn = (gru_hside.ConvLSTMHside.apply if kind == "lstm_hside"
          else phased_cell.PhasedCell.apply)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(fn, _gradcheck_args(kind), eps=1e-6,
                                        atol=1e-6, rtol=1e-4)
    finally:
        torch.set_num_threads(threads)


# -- (f): the Functions against the plain layers' autograd ------------------

def _backward(outs, cots):
    """Backward of sum(out * cot) / sqrt(pixels): random-signed cotangents
    keep every gradient of order one."""
    n = outs[0].numel() / outs[0].shape[1]
    (sum((o * g).sum() for o, g in zip(outs, cots)) / n ** 0.5).backward()


def _lstm_grads(cell, x, h, c, cots, fused):
    cell.zero_grad()
    x, h, c = (v.clone().requires_grad_() for v in (x, h, c))
    gx = cell.x_gates(to_nchw(x))
    if fused:
        out = gru_hside.conv_lstm_hside(h, c, to_nhwc(gx),
                                        cell.hside_weights())
    else:
        out = tuple(to_nhwc(v) for v in cell.hside(gx, (to_nchw(h),
                                                        to_nchw(c))))
    _backward(out, cots)
    return [x.grad, h.grad, c.grad] + [p.grad.clone()
                                       for p in cell.parameters()]


def _phased_grads(layer, x, c0, h0, t, cots, fused):
    layer.zero_grad()
    x, c0, h0 = (v.clone().requires_grad_() for v in (x, c0, h0))
    y, (hn, cn) = layer(to_nchw(x), t, (to_nchw(c0), to_nchw(h0)),
                        fused=fused)
    _backward([to_nhwc(v) for v in (y, hn, cn)], cots)
    return [x.grad, c0.grad, h0.grad] + [p.grad.clone()
                                         for p in layer.parameters()]


@pytest.mark.parametrize("kind", ["lstm_hside", "phased"])
def test_functions_match_plain_layer_autograd_and_refold(kind):
    """float32: gradients through the Function (ConvLSTM.hside_weights
    and PhasedLSTMGate.nhwc of the live parameters) equal autograd through
    the plain layer (ConvLSTM.hside; PhasedConvLSTM.forward(fused=False)).
    After an optimizer step the next forward uses the updated weights,
    tau and phase: a stale fold or nhwc cache fails the second round."""
    torch.manual_seed(0)
    rng = np.random.RandomState(4)
    if kind == "lstm_hside":
        module, _ = _cell(rng)
        run = lambda fused: _lstm_grads(  # noqa: E731
            module, x, h, c, cots, fused)
    else:
        module = PhasedConvLSTM(C, C, H, W)
        module.lstm, _ = _cell(rng)
        module.phased_cell, _, _ = _gate(rng)
        run = lambda fused: _phased_grads(  # noqa: E731
            module, x, h, c, t, cots, fused)
    x = _t(rng.randn(B, H, W, C))
    cots = [_t(rng.randn(B, H, W, C)) for _ in range(3)]
    h = _t(rng.uniform(-1, 1, (B, H, W, C)))
    c = _t(rng.uniform(-2, 2, (B, H, W, C)))
    t = _t([0.37, 12.9])
    with torch.no_grad():   # fill the no-grad caches before any step
        if kind == "phased":
            module.phased_cell.nhwc(C, H, W)
            module.lstm.hside_weights(torch.float32)
        else:
            module.hside_weights(torch.float32)
    opt = torch.optim.SGD(module.parameters(), lr=0.05)
    for _ in range(2):
        want, got = run(False), run(True)
        for a, b in zip(got, want):
            assert a is not None and a.abs().max() > 0
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL_GRAD,
                                       rtol=RTOL_GRAD)
        opt.step()


# -- (g): the sequence loss and every parameter gradient against JAX --------

L, K, HS = 2, 3, 16
RECIPES = {
    "phased": dict(recurrent_block_type="convlstm",
                   state_combination="convlstm", use_phased_arch=True,
                   spatial_resolution=[HS, HS]),
    "lstm_comb": dict(recurrent_block_type="conv",
                      state_combination="convlstm"),
}


def _raw(recipe, fused_gru="off"):
    raw = tiny_config(**RECIPES[recipe]).raw
    phased = recipe == "phased"
    return {**raw, "use_phased_arch": phased,
            "trainer": {**raw["trainer"], "deferred_decode": True,
                        "precompute_x": not phased},
            "model": {**raw["model"], "fused_gru": fused_gru}}


def _batch(phased, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"events": rng.randn(B, L, K, HS, HS, 5).astype(np.float32),
             "image": rng.rand(B, L, HS, HS, 1).astype(np.float32),
             "depth_events": rng.rand(B, L, K, HS, HS, 1).astype(np.float32),
             "depth_image": rng.rand(B, L, HS, HS, 1).astype(np.float32)}
    if phased:
        te = np.cumsum(rng.uniform(0.01, 0.2, (B, L * K)), 1)
        batch["times_events"] = te.reshape(B, L, K).astype(np.float32)
        batch["times_image"] = (batch["times_events"][:, :, -1]
                                + 0.005).astype(np.float32)
    return batch


def _admit_f32(monkeypatch):
    """Let both packages take their fused LSTM cells for float32 CPU states
    of the tiny shapes under fused_gru 'on', as tests/test_train.py:656-669
    does for JAX: the JAX kernels in interpret mode, the port's Functions
    on their plain versions (the port's 'on' policy admits CPU tensors;
    the plain versions' calls are counted, so the test sees that they
    ran)."""
    real_pick = JG._pick_tile_h

    def fake_supports(prev_state, lstm=False):
        if prev_state.ndim != 4:
            return False
        _, h, w, c = prev_state.shape
        budget = 256 * 1024 if lstm else 512 * 1024
        return (real_pick(h, w, c, 4, budget=budget) > 0
                and w % 8 == 0 and c % 8 == 0)

    monkeypatch.setattr(JG, "supports", fake_supports)
    monkeypatch.setattr(JG, "_INTERPRET", True)
    monkeypatch.setattr(statenet, "use_fused_cell",
                        lambda cfg, h, kind="hside": cfg.fused_gru == "on"
                        and kind == "lstm" and h.shape[1] % 8 == 0)
    calls = {"k3_res": 0, "k4_res": 0}
    for mod, name, key in ((gru_hside, "conv_lstm_hside_res_plain", "k3_res"),
                           (phased_cell, "conv_lstm_phased_res_plain",
                            "k4_res")):
        real = getattr(mod, name)

        def counted(*args, _real=real, _key=key):
            calls[_key] += 1
            return _real(*args)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_sequence_loss_and_every_gradient_match_jax(monkeypatch, recipe,
                                                    route):
    """The loss, its parts and every parameter gradient (tau and phase
    included) of one window with remat against JAX make_sequence_loss:
    'plain' the plain layers in both (fused_gru 'off'); 'function'
    fused_gru 'on' in both, admitted for float32: JAX's fused cells in
    interpret mode against the port's ConvLSTMHside and PhasedCell on
    their plain versions, whose calls are counted: per window each cell
    of the path runs twice (the checkpoint's recompute)."""
    calls = _admit_f32(monkeypatch)
    fused = route == "function"
    raw = _raw(recipe, "on" if fused else "off")
    jcfg = jconfig.Config.from_dict(raw)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg.model)
    cfg = tconfig.Config.from_dict(raw)
    model = ERGB2DepthRecurrent(cfg.model)
    params_from_jax(model, params)
    batch = _batch(recipe == "phased")
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        jax_loss(jcfg, remat=True), has_aux=True)(
        params, JaxModel.init_state(jcfg.model, B, HS, HS),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, HS, HS),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(aux) == set(j_aux)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=1e-4)
    want = params_to_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=ATOL_GRAD, rtol=RTOL_GRAD,
                                   err_msg=name)
    taus = [p.grad for n, p in model.named_parameters() if n.endswith(".tau")]
    assert all(g.abs().max() > 0 for g in taus)
    assert len(taus) == (4 if recipe == "phased" else 0)
    n_enc = cfg.model.num_encoders
    cells = 2 * n_enc * (K + 1) * L          # the recompute doubles them
    expect = {"k3_res": cells if fused else 0,
              "k4_res": cells if fused and recipe == "phased" else 0}
    assert calls == expect


# -- (h): the training entry point on a tiny phased config ------------------

def test_train_entry_point_phased_cpu(tmp_path, monkeypatch):
    """``python -m rpg_ramnet_tpu_torch.train --device cpu``'s main() on a
    tiny phased config (use_phased_arch at both levels,
    spatial_resolution = the crop): one epoch of finite losses, a
    checkpoint, and every batch it packs carries the steps' timestamps
    ([B, L, K] and [B, L], increasing within a window)."""
    generate_split(str(tmp_path / "data/train"), n_sequences=2, n_frames=8,
                   height=28, width=26)
    generate_split(str(tmp_path / "data/val"), n_sequences=1, n_frames=6,
                   height=28, width=26, seed=5)
    split = {"every_x_rgb_frame": 2, "step_size": 1, "clip_distance": 80.0,
             "reg_factor": 3.70378}
    raw = {"name": "tiny_phased", "arch": "ERGB2DepthRecurrent",
           "use_phased_arch": True,
           "data_loader": {"train": {"base_folder": "train", **split},
                           "validation": {"base_folder": "val", **split},
                           "batch_size": 2, "num_workers": 2,
                           "crop_size": 24},
           "optimizer_type": "Adam", "optimizer": {"lr": 3e-4},
           "loss": {"type": "scale_invariant_loss",
                    "config": {"weight": 1.0, "n_lambda": 1.0}},
           "grad_loss": {"weight": 0.25},
           "trainer": {"epochs": 1, "sequence_length": 2,
                       "save_dir": str(tmp_path / "runs"), "save_freq": 1,
                       "loss_composition": ["image", "events1"],
                       "loss_weights": [1, 1], "deferred_decode": True},
           "model": {"recurrent_block_type": "convlstm",
                     "state_combination": "convlstm", "use_phased_arch": True,
                     "spatial_resolution": [24, 24], "num_encoders": 2,
                     "base_num_channels": 4, "num_residual_blocks": 1,
                     "norm": "none"}}
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(tmp_path / "data"))
    packed = []
    real_prefetch = ttrainer.device_prefetch

    def prefetch(batches, device, **kw):
        def record():
            for batch in batches:
                packed.append(batch)
                yield batch
        return real_prefetch(record(), device, **kw)

    monkeypatch.setattr(ttrainer, "device_prefetch", prefetch)
    trainer = train_main(["-c", str(tmp_path / "cfg.json"), "--device", "cpu"])
    log = trainer.jsonl.entries[0]
    assert np.isfinite(log["train_loss"]) and np.isfinite(log["val_loss"])
    assert (tmp_path / "runs/tiny_phased/checkpoint-epoch0/state.pt").exists()
    assert packed
    for batch in packed:
        b, l = batch["image"].shape[:2]
        assert batch["times_events"].shape == (b, l, 2)
        assert batch["times_image"].shape == (b, l)
        stamps = np.concatenate([batch["times_events"],
                                 batch["times_image"][..., None]], -1)
        assert (np.diff(stamps.reshape(b, -1), axis=1) >= 0).all()
