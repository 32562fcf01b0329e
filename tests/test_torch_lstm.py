"""The port's ConvLSTM cells against the JAX package's: the ConvLSTM h-side
cell (kernel K3's plain version), the phased ConvLSTM cell (kernel K4's
plain version), the ConvLSTM and phased layers, and the wrappers' contract.

Inputs come from numpy with a seed; the JAX Pallas kernels run in
interpret mode.  Tolerances: 1e-5 in float32 where no fmod is involved;
states through the time gate's fmod at atol 2e-3 / rtol 1e-3
(tests/test_phased.py:74-78); bf16 within two bf16 ulps of the values'
magnitude (2 ** -7 relative, on cells and states of magnitude <= 2).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.models import layers as jlayers
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside
from rpg_ramnet_tpu.ops import phased_cell as jax_phased_cell

from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import statenet
from rpg_ramnet_tpu_torch.models.layers import (ConvLSTM, PhasedConvLSTM,
                                                PhasedLSTMGate,
                                                RecurrentPhasedConvLayer,
                                                phased_gate_k)
from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc
from torch_threads import one_thread  # noqa: F401

ATOL_F32 = 1e-5
ATOL_FMOD, RTOL_FMOD = 2e-3, 1e-3
ATOL_BF16 = 2 * 2.0 ** -7 * 2      # two ulps at magnitude 2
B, H, W, C, CX = 2, 8, 16, 16, 8
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _lstm_params(rng, cin, c):
    """A ConvLSTM's Gates conv (OIHW weight, bias) and the JAX HWIO tree."""
    bound = 1.0 / np.sqrt(9 * cin)
    w = rng.uniform(-bound * 3, bound * 3, (4 * c, cin, 3, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, 4 * c).astype(np.float32)
    tree = {"Gates": {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)),
                      "bias": jnp.asarray(b)}}
    cell = ConvLSTM(cin - c, c)
    with torch.no_grad():
        cell.Gates.weight.copy_(torch.from_numpy(w))
        cell.Gates.bias.copy_(torch.from_numpy(b))
    return cell, tree


def _gate_params(rng, n):
    tau = np.exp(rng.uniform(np.log(0.02), np.log(50.0), n)).astype(np.float32)
    phase = (rng.uniform(0, 1, n) * tau).astype(np.float32)
    gate = PhasedLSTMGate(n)
    with torch.no_grad():
        gate.tau.copy_(torch.from_numpy(tau))
        gate.phase.copy_(torch.from_numpy(phase))
    return gate, {"tau": jnp.asarray(tau), "phase": jnp.asarray(phase)}


def _nhwc(rng, *shape, scale=1.0):
    return (rng.uniform(-1, 1, shape) * scale).astype(np.float32)


def _close(got, want, dtype, atol=ATOL_F32, rtol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "bf16":
        atol, rtol = ATOL_BF16, 0.0
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lstm_hside_plain_matches_jax_kernel(dtype):
    """K3's plain version against conv_lstm_hside_fused in interpret mode
    and the unfused conv_lstm_apply_hside, B > 1."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    cell, tree = _lstm_params(rng, 2 * C, C)
    h, c = _nhwc(rng, B, H, W, C), _nhwc(rng, B, H, W, C, scale=2.0)
    gx = rng.randn(B, H, W, 4 * C).astype(np.float32)
    with torch.no_grad():
        w4 = cell.hside_weights(tdt)
    got = gru_hside.conv_lstm_hside_plain(
        *(torch.from_numpy(a).to(tdt) for a in (h, c, gx)), w4)
    jstate = (jnp.asarray(h, jdt), jnp.asarray(c, jdt))
    kernel = jax_gru_hside.conv_lstm_hside_fused(tree, jnp.asarray(gx, jdt),
                                                 jstate, interpret=True)
    unfused = jlayers.conv_lstm_apply_hside(tree, jnp.asarray(gx, jdt), jstate)
    for g, k, u in zip(got, kernel, unfused):
        assert g.dtype == tdt and g.shape == (B, H, W, C)
        _close(g, k, dtype)
        if dtype == "f32":
            _close(g, u, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv_lstm_module_matches_jax(dtype):
    """ConvLSTM.forward against conv_lstm_apply, x_gates against
    conv_lstm_x_gates, hside against conv_lstm_apply_hside."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    cell, tree = _lstm_params(rng, CX + C, C)
    x, h = _nhwc(rng, B, H, W, CX), _nhwc(rng, B, H, W, C)
    c = _nhwc(rng, B, H, W, C, scale=2.0)
    tx, th, tc = (to_nchw(torch.from_numpy(a).to(tdt)) for a in (x, h, c))
    jx, jh, jc = (jnp.asarray(a, jdt) for a in (x, h, c))
    with torch.no_grad():
        got = cell(tx, (th, tc))
        gx = cell.x_gates(tx)
        split = cell.hside(gx, (th, tc))
    want = jlayers.conv_lstm_apply(tree, jx, (jh, jc))
    jgx = jlayers.conv_lstm_x_gates(tree, jx)
    want_split = jlayers.conv_lstm_apply_hside(tree, jgx, (jh, jc))
    # bf16: the layers round every intermediate to bf16 in both packages,
    # each in its own order, so compare to 4 ulps
    scale = 2.0 if dtype == "bf16" else 1.0
    for a, b in zip(got + split, want + want_split):
        np.testing.assert_allclose(to_nhwc(a).float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=ATOL_BF16 * scale if dtype == "bf16"
                                   else ATOL_F32)
    _close(to_nhwc(gx), jgx, "f32" if dtype == "f32" else dtype)


def _phased_inputs(seed, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    cell, tree = _lstm_params(rng, 2 * C, C)
    gate, gtree = _gate_params(rng, C * H * W)
    c0, h0 = _nhwc(rng, B, H, W, C), _nhwc(rng, B, H, W, C, scale=2.0)
    gx = rng.randn(B, H, W, 4 * C).astype(np.float32)
    t = np.array([0.37, 12.9], np.float32)
    return tdt, jdt, cell, tree, gate, gtree, c0, h0, gx, t


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_phased_plain_matches_jax_kernel(dtype):
    """K4's plain version against conv_lstm_phased_fused in interpret mode
    and phased_conv_lstm_apply's unfused blend (on the same h-side cell),
    with c0 and h0 distinct, so the slot swap shows: (h_t, (h_new, c_new))."""
    tdt, jdt, cell, tree, gate, gtree, c0, h0, gx, t = _phased_inputs(2, dtype)
    with torch.no_grad():
        w4 = cell.hside_weights(tdt)
        tau, phase = gate.nhwc(C, H, W)
    got = phased_cell.conv_lstm_phased_plain(
        *(torch.from_numpy(a).to(tdt) for a in (c0, h0, gx)), w4, tau, phase,
        torch.from_numpy(t))
    jstate = (jnp.asarray(c0, jdt), jnp.asarray(h0, jdt))
    h_t, (h_new, c_new) = jax_phased_cell.conv_lstm_phased_fused(
        tree, gtree, jnp.asarray(gx, jdt), jstate, jnp.asarray(t),
        interpret=True)
    for g, w in zip(got, (h_t, h_new, c_new)):
        assert g.dtype == tdt
        _close(g, w, dtype, ATOL_FMOD, RTOL_FMOD)
    # the unfused reference: conv_lstm_apply_hside on (c0, h0), then the
    # time gate of phased_gate_k, blended in float32
    c_t, h_t2 = jlayers.conv_lstm_apply_hside(tree, jnp.asarray(gx, jdt), jstate)
    k = jlayers.phased_gate_k(gtree, jnp.asarray(t), H, W, C)
    want = (h_t2, (k * h_t2 + (1 - k) * jstate[1]).astype(jdt),
            (k * c_t + (1 - k) * jstate[0]).astype(jdt))
    if dtype == "f32":
        for g, w in zip(got, want):
            _close(g, w, dtype, ATOL_FMOD, RTOL_FMOD)


@pytest.mark.parametrize("t", [0.0, 0.004, 0.73, 31.0])
def test_phased_gate_k_matches_jax_flattened_layout(t):
    """phased_gate_k (NCHW, the parameters viewed [C, H, W]) against
    phased_lstm_gate_apply over the flattened torch-order features, whose
    blend of ones with zeros is k itself."""
    rng = np.random.RandomState(3)
    gate, gtree = _gate_params(rng, C * H * W)
    times = np.array([t, t + 0.5], np.float32)
    k = phased_gate_k(gate, torch.from_numpy(times), C, H, W)
    assert k.shape == (2, C, H, W) and k.dtype == torch.float32
    ones, zeros = jnp.ones((2, C * H * W)), jnp.zeros((2, C * H * W))
    want, _ = jlayers.phased_lstm_gate_apply(gtree, ones, ones, zeros, zeros,
                                             jnp.asarray(times))
    np.testing.assert_allclose(k.detach().reshape(2, -1).numpy(),
                               np.asarray(want), atol=1e-7, rtol=1e-6)
    nhwc = jlayers.phased_gate_k(gtree, jnp.asarray(times), H, W, C)
    np.testing.assert_allclose(to_nhwc(k).detach().numpy(), np.asarray(nhwc),
                               atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_phased_layer_matches_jax(fused):
    """RecurrentPhasedConvLayer (strided conv, then the phased cell)
    against recurrent_phased_conv_layer_apply, fused with K4's plain
    version against the JAX fused branch in interpret mode."""
    rng = np.random.RandomState(4)
    layer = RecurrentPhasedConvLayer(CX, C, H, W)
    layer.recurrent_block.phased_cell.reset_parameters_(
        torch.Generator().manual_seed(0))
    tree = {"conv": {"conv2d": {
                "weight": jnp.asarray(layer.conv.conv2d.weight.detach().numpy()
                                      .transpose(2, 3, 1, 0)),
                "bias": jnp.asarray(layer.conv.conv2d.bias.detach().numpy())}},
            "recurrent_block": {
                "lstm": {"Gates": {
                    "weight": jnp.asarray(layer.recurrent_block.lstm.Gates.weight
                                          .detach().numpy().transpose(2, 3, 1, 0)),
                    "bias": jnp.asarray(layer.recurrent_block.lstm.Gates.bias
                                        .detach().numpy())}},
                "phased_cell": {k: jnp.asarray(getattr(
                    layer.recurrent_block.phased_cell, k).detach().numpy())
                    for k in ("tau", "phase")}}}
    x = rng.randn(B, 2 * H, 2 * W, CX).astype(np.float32)
    c0, h0 = _nhwc(rng, B, H, W, C), _nhwc(rng, B, H, W, C)
    t = np.array([0.11, 2.5], np.float32)
    with torch.no_grad():
        y, (hn, cn) = layer(to_nchw(torch.from_numpy(x)), torch.from_numpy(t),
                            (to_nchw(torch.from_numpy(c0)),
                             to_nchw(torch.from_numpy(h0))), fused=fused)
    old = jax_gru_hside._INTERPRET
    jax_gru_hside._INTERPRET = True
    try:
        jy, (jhn, jcn) = jlayers.recurrent_phased_conv_layer_apply(
            tree, jnp.asarray(x), jnp.asarray(t),
            (jnp.asarray(c0), jnp.asarray(h0)), 2, 2, fused=fused)
    finally:
        jax_gru_hside._INTERPRET = old
    for a, b in zip((y, hn, cn), (jy, jhn, jcn)):
        np.testing.assert_allclose(to_nhwc(a).numpy(), np.asarray(b),
                                   atol=ATOL_FMOD, rtol=RTOL_FMOD)
        np.testing.assert_allclose(to_nhwc(a).numpy(), np.asarray(b),
                                   atol=ATOL_F32 * 10)


@pytest.mark.parametrize("cell_kind", ["lstm_hside", "phased"])
def test_wrappers_contract(cell_kind):
    """A CPU tensor gets the plain version (no launch counted);
    fused_gru='on' on a CPU tensor raises; under autograd the wrapper is
    its Function (ConvLSTMHside, PhasedCell) on the plain versions: the
    same values, gradients for every input (no launch counted); a wrong
    shape raises."""
    tdt, _, cell, _, gate, _, c0, h0, gx, t = _phased_inputs(5, "bf16")
    with torch.no_grad():
        w4 = cell.hside_weights(tdt)
        tau, phase = gate.nhwc(C, H, W)
    args = [torch.from_numpy(a).to(tdt) for a in (c0, h0, gx)] + [w4]
    if cell_kind == "lstm_hside":
        fn, plain, extra = (gru_hside.conv_lstm_hside,
                            gru_hside.conv_lstm_hside_plain, [])
    else:
        fn, plain, extra = (phased_cell.conv_lstm_phased,
                            phased_cell.conv_lstm_phased_plain,
                            [tau, phase, torch.from_numpy(t)])
    n0 = fn.launches
    for a, b in zip(fn(*args, *extra), plain(*args, *extra)):
        assert torch.equal(a, b)
    assert fn.launches == n0
    cfg = ModelConfig(fused_gru="on")
    with pytest.raises(ValueError, match="CUDA"):
        statenet.use_fused_cell(cfg, to_nchw(args[0]), "lstm")
    assert statenet.use_fused_cell(ModelConfig(fused_gru="auto"),
                                   to_nchw(args[0]), "lstm")
    assert not statenet.use_fused_cell(ModelConfig(fused_gru="auto"),
                                       to_nchw(args[0].float()), "lstm")
    grad = [a.clone().float().requires_grad_() if i == 3
            else a.clone().requires_grad_() for i, a in enumerate(args)]
    extra_grad = [v.clone().requires_grad_() for v in extra[:2]] + extra[2:]
    outs = fn(*grad, *extra_grad)
    for a, b in zip(outs, plain(*args, *extra)):
        assert a.grad_fn is not None and torch.equal(a.detach(), b)
    sum(o.float().sum() for o in outs).backward()
    for v in grad + extra_grad[:2]:
        assert v.grad is not None and v.grad.dtype == v.dtype
        assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0
    assert fn.launches == n0
    with pytest.raises(ValueError, match="must be"):
        fn(args[0], args[1], args[2][..., :-8], w4, *extra)


def test_phased_gate_params_init_and_cache():
    """Upstream init ranges; without autograd the [H, W, C] cache is a copy
    of the parameters, refreshed when they change, never an alias; under
    autograd a fresh permute of the live parameters that carries their
    gradient."""
    gate = PhasedLSTMGate(C * H * W)
    gate.reset_parameters_(torch.Generator().manual_seed(0))
    tau = gate.tau.detach()
    assert tau.min() >= 0.02 * 0.999 and tau.max() <= 50.0 * 1.001
    assert (gate.phase.detach() >= 0).all() and (gate.phase.detach() <= tau).all()
    with torch.no_grad():
        t1, p1 = gate.nhwc(C, H, W)
        assert t1.shape == (H, W, C) and t1.is_contiguous()
        assert torch.equal(t1.permute(2, 0, 1), gate.tau.detach().view(C, H, W))
        assert t1.data_ptr() != gate.tau.data_ptr()
        assert gate.nhwc(C, H, W)[0] is t1           # cached
        gate.tau.mul_(2.0)
        t2, _ = gate.nhwc(C, H, W)
    assert torch.equal(t2, t1 * 2.0) and not torch.equal(t1, t2)
    t3, p3 = gate.nhwc(C, H, W)
    assert t3 is not t2 and torch.equal(t3, t2) and t3.is_contiguous()
    (t3.sum() + 2 * p3.sum()).backward()
    assert torch.equal(gate.tau.grad, torch.ones_like(gate.tau))
    assert torch.equal(gate.phase.grad, torch.full_like(gate.phase, 2.0))
    cell = PhasedConvLSTM(C, C, H, W)
    assert cell.phased_cell.tau.shape == (C * H * W,)
