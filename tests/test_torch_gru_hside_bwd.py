"""The port's training cell: K1-res, K2 and the ConvGRUHside Function.

Plain versions against the JAX package's Pallas kernels in interpret mode
(``_run(..., residuals=True)``, ``_run_bwd``) and its XLA backward
(``_gru_hside_bwd_xla``), in float32 (1e-5: the same arithmetic, summed in
another order) and bf16 (one bf16 ulp of the largest value: both round at
the same places, but an f32 sum in another order can tip a rounding).  The
Function's plain path passes ``gradcheck`` in float64 and matches autograd
through the plain layer.  The kernels themselves are tested on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops import gru_hside as JG

from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc
from torch_threads import one_thread  # noqa: F401

PREFIX = "statenetphasedrecurrent."
# (B, H, W, C) and the JAX kernels' H tile (it must divide H)
SHAPES = (((2, 16, 16, 8), 8), ((1, 8, 12, 16), 4))
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, None)}


def _cell(C, seed=0):
    """A JAX ConvGRU param dict and the port's ConvGRU with its weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    cell = ConvGRU(C, C)
    sd = {k[len(PREFIX):]: torch.from_numpy(np.array(v))
          for k, v in params_to_state_dict(p).items()}
    cell.load_state_dict(sd, strict=True)
    return p, cell


def _case(shape, jdt, seed=0):
    """JAX params, the port's cell, and h, gx, g as numpy in jdt's values."""
    B, H, W, C = shape
    p, cell = _cell(C, seed)
    rng = np.random.RandomState(seed)
    h = jnp.asarray(rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32), jdt)
    x = jnp.asarray(rng.randn(B, H, W, C).astype(np.float32))
    gx = JL.conv_gru_x_gates(p, x).astype(jdt)
    g = jnp.asarray(rng.randn(B, H, W, C).astype(np.float32), jdt)
    return p, cell, h, gx, g


def _t(x, tdt):
    return torch.from_numpy(np.array(x, np.float32)).to(tdt)


def _close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if tol is None:   # one bf16 ulp of the largest magnitude
        tol = 2.0 ** -7 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,tile_h", SHAPES, ids=("2x16x16x8", "1x8x12x16"))
def test_res_plain_matches_jax_residual_kernel(shape, tile_h, dtype):
    """(h', acts) of the plain K1-res against _run(residuals=True)."""
    jdt, tdt, tol = DTYPES[dtype]
    p, cell, h, gx, _ = _case(shape, jdt)
    want_h, (_, _, _, want_acts) = JG._gru_hside_fwd(tile_h, True, p, gx, h)
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights(tdt)
        got_h, got_acts = gru_hside.conv_gru_hside_res_plain(
            _t(h, tdt), _t(gx, tdt), w_ur, w_o)
        wrapped = gru_hside.conv_gru_hside_res(_t(h, tdt), _t(gx, tdt),
                                               w_ur, w_o)
    assert got_h.dtype == got_acts.dtype == tdt
    _close(got_h, want_h, tol)
    _close(got_acts, want_acts, tol)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(wrapped[0], got_h) and torch.equal(wrapped[1], got_acts)


def _jax_res(p, h, gx, tile_h):
    _, res = JG._gru_hside_fwd(tile_h, True, p, gx, h)
    return res


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("jax_bwd", ["xla", "pallas_interpret"])
def test_bwd_plain_matches_jax_backward(jax_bwd, dtype):
    """(dh, dgx) of the plain K2 and the library weight gradients against
    _gru_hside_bwd_xla and against the Pallas _run_bwd in interpret mode,
    all from the same residuals."""
    jdt, tdt, tol = DTYPES[dtype]
    (shape, tile_h) = SHAPES[0]
    C = shape[-1]
    p, cell, h, gx, g = _case(shape, jdt, seed=1)
    res = _jax_res(p, h, gx, tile_h)
    if jax_bwd == "xla":
        dp, want_dgx, want_dh = JG._gru_hside_bwd_xla(tile_h, True, res, g)
    else:
        dp, want_dgx, want_dh = JG._gru_hside_bwd_kernel_path(tile_h, True,
                                                              res, g)
    acts = _t(res[3], tdt)
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights(tdt)
        dh, dgx = gru_hside.conv_gru_hside_bwd_plain(
            _t(g, tdt), _t(h, tdt), acts, w_ur, w_o)
        dw_ur, dw_o = gru_hside.hside_weight_grads(_t(h, tdt), acts, dgx)
    _close(dh, want_dh, tol)
    _close(dgx, want_dgx, tol)
    # folded [9, out, in] -> HWIO [3, 3, in, out], against the h slices
    to_hwio = lambda w: w.reshape(3, 3, w.shape[1], C).permute(0, 1, 3, 2)  # noqa: E731
    want_ur = np.concatenate([np.asarray(dp[k]["weight"], np.float32)[:, :, -C:]
                              for k in ("update_gate", "reset_gate")], -1)
    _close(to_hwio(dw_ur), want_ur, tol)
    _close(to_hwio(dw_o),
           np.asarray(dp["out_gate"]["weight"], np.float32)[:, :, -C:], tol)


def test_function_gradcheck_float64():
    """Full-mode gradcheck of the plain path: thousands of tiny forwards,
    so on one thread (the suite runs several test processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _gradcheck()
    finally:
        torch.set_num_threads(threads)


def _gradcheck():
    gen = torch.Generator().manual_seed(0)
    B, H, W, C = 1, 6, 6, 8
    args = [torch.rand(B, H, W, C, generator=gen, dtype=torch.float64) * 2 - 1,
            torch.randn(B, H, W, 3 * C, generator=gen, dtype=torch.float64),
            torch.randn(9, 2 * C, C, generator=gen, dtype=torch.float64) * 0.2,
            torch.randn(9, C, C, generator=gen, dtype=torch.float64) * 0.2]
    for a in args:
        a.requires_grad_()
    assert torch.autograd.gradcheck(gru_hside.ConvGRUHside.apply, args,
                                    eps=1e-6, atol=1e-6, rtol=1e-4)


def _layer_grads(cell, h, gx):
    """Loss and gradients through the plain layer (autograd of its convs)."""
    cell.zero_grad()
    h = h.clone().requires_grad_()
    gx = gx.clone().requires_grad_()
    out = to_nhwc(cell.hside(to_nchw(gx), to_nchw(h)))
    (out * out).sum().backward()
    return [h.grad, gx.grad] + [g.weight.grad.clone() for g in cell.gates()]


def _function_grads(cell, h, gx):
    """The same through the ConvGRUHside Function on the live fold."""
    cell.zero_grad()
    h = h.clone().requires_grad_()
    gx = gx.clone().requires_grad_()
    out = gru_hside.conv_gru_hside(h, gx, *cell.hside_weights())
    (out * out).sum().backward()
    return [h.grad, gx.grad] + [g.weight.grad.clone() for g in cell.gates()]


def test_function_matches_plain_layer_autograd_and_refolds():
    """float32: the Function's gradients (the h slices of the gate weights
    through the fold, dgx into gx) equal autograd through the plain layer
    (1e-5).  After an optimizer step the next forward folds the updated
    weights: the second backward again equals the plain layer's, at the
    new weights."""
    torch.manual_seed(0)
    B, H, W, C = 2, 8, 8, 8
    _, cell = _cell(C)
    gen = torch.Generator().manual_seed(3)
    h = torch.rand(B, H, W, C, generator=gen) * 2 - 1
    gx = torch.randn(B, H, W, 3 * C, generator=gen)
    opt = torch.optim.SGD(cell.parameters(), lr=0.5)
    for _ in range(2):
        want = _layer_grads(cell, h, gx)
        got = _function_grads(cell, h, gx)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-4)
        # the x slices get no gradient from the h side
        assert got[2][:, :C].abs().max() == 0
        opt.step()
