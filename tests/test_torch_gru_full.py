"""The port's whole ConvGRU cell (kernel K5 in ops/gru_hside.py).

Its plain version against the JAX Pallas kernel ``conv_gru_full_fused`` in
interpret mode and against ``layers.conv_gru_apply``: float32 at 1e-5, and
bfloat16 within one bf16 ulp (2^-7 relative; the JAX kernel rounds the
biases to bf16, the port keeps them float32); the weight fold and its
cache; the wrapper's checks.  The kernel itself is tested on a card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops.gru_hside import conv_gru_full_fused

from rpg_ramnet_tpu_torch.compat import params_to_state_dict
from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc
from torch_threads import one_thread  # noqa: F401

SHAPES = ((1, 32, 24, 8), (2, 16, 16, 16))
PREFIX = "statenetphasedrecurrent."
BF16_ULP = 2.0 ** -7


def _cells(C, seed=0):
    """A JAX ConvGRU param dict with nonzero biases and the port's ConvGRU
    with the same weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    rng = np.random.RandomState(seed)
    for gate in ("update_gate", "reset_gate", "out_gate"):
        p[gate]["bias"] = jnp.asarray(rng.uniform(-0.5, 0.5, C).astype(np.float32))
    cell = ConvGRU(C, C)
    sd = {k[len(PREFIX):]: torch.from_numpy(np.array(v))
          for k, v in params_to_state_dict(p).items()}
    cell.load_state_dict(sd, strict=True)
    return p, cell


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel_and_layer_f32(shape):
    p, cell = _cells(shape[-1])
    x, h = _inputs(shape)
    kernel = np.asarray(conv_gru_full_fused(p, jnp.asarray(x), jnp.asarray(h),
                                            interpret=True))
    layer = np.asarray(JL.conv_gru_apply(p, jnp.asarray(x), jnp.asarray(h)))
    tx, th = torch.from_numpy(x), torch.from_numpy(h)
    with torch.no_grad():
        w = cell.full_weights()
        plain = gru_hside.conv_gru_full_plain(tx, th, *w)
        wrapped = gru_hside.conv_gru_full(tx, th, *w)
        module = to_nhwc(cell(to_nchw(tx), to_nchw(th)))
    np.testing.assert_allclose(plain.numpy(), kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(plain.numpy(), layer, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(plain.numpy(), module.numpy(), atol=1e-5,
                               rtol=1e-5)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel_bf16(shape):
    p, cell = _cells(shape[-1], seed=1)
    x, h = _inputs(shape, seed=1)
    xb, hb = (jnp.asarray(v, jnp.bfloat16) for v in (x, h))
    want = np.asarray(conv_gru_full_fused(p, xb, hb, interpret=True),
                      np.float32)
    tx, th = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, h))
    with torch.no_grad():
        got = gru_hside.conv_gru_full(tx, th, *cell.full_weights(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ULP,
                               rtol=BF16_ULP)


def test_weight_fold_layout_and_cache():
    _, cell = _cells(8)
    with torch.no_grad():
        w_ur, w_o, b_ur, b_o = cell.full_weights()
        assert cell.full_weights()[0] is w_ur           # cached
        ur = torch.cat([cell.update_gate.weight, cell.reset_gate.weight])
        for ky in range(3):
            for kx in range(3):
                assert torch.equal(w_ur[ky * 3 + kx], ur[:, :, ky, kx])
                assert torch.equal(w_o[ky * 3 + kx],
                                   cell.out_gate.weight[:, :, ky, kx])
        assert torch.equal(b_ur, torch.cat([cell.update_gate.bias,
                                            cell.reset_gate.bias]))
        assert torch.equal(b_o, cell.out_gate.bias)
        assert (w_ur.shape, w_o.shape) == ((9, 16, 16), (9, 8, 16))
        w16 = cell.full_weights(torch.bfloat16)
        assert w16[0].dtype == torch.bfloat16 and w16[2].dtype == torch.float32
        # an in-place update invalidates the cache, the h-side fold too
        cell.out_gate.bias.add_(1.0)
        assert torch.equal(cell.full_weights()[3], b_o + 1.0)
        assert cell.hside_weights()[1] is cell.hside_weights()[1]
    # under autograd the fold is differentiable and not cached
    w = cell.full_weights()
    assert w[0].requires_grad and w[0] is not cell.full_weights()[0]


def test_wrapper_checks():
    _, cell = _cells(8)
    x = torch.zeros(1, 8, 8, 8)
    with torch.no_grad():
        w = cell.full_weights()
        with pytest.raises(ValueError, match="x must be"):
            gru_hside.conv_gru_full(torch.zeros(1, 8, 4, 8), x, *w)
        with pytest.raises(ValueError, match="w_o"):
            gru_hside.conv_gru_full(x, x, w[0], w[0], w[2], w[3])
    # no gradient: inference only
    with pytest.raises(RuntimeError, match="inference"):
        gru_hside.conv_gru_full(x, x, *cell.full_weights())
    # the flagship per-package shapes have a K5 plan within shared memory
    for shape in ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256)):
        p = gru_hside.plan_k5(*shape)
        assert gru_hside.k5_smem_bytes(p.tile_h, p.tile_w, shape[-1], p.split,
                                       p.ks) <= gru_hside._SMEM_MAX
        assert gru_hside.supports_full(torch.zeros(shape, dtype=torch.bfloat16))
    assert not gru_hside.supports_full(torch.zeros(1, 8, 8, 8))   # float32
    assert not gru_hside.supports_full(torch.zeros(1, 8, 8, 2048,
                                                   dtype=torch.bfloat16))
