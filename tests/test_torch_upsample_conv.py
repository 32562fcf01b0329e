"""The fused decoder layer (kernel K8's wrapper) and the composed decoder
layer of the port, against the JAX package.

``ops.upsample_conv.upsample_conv_fused`` runs its plain version on the
CPU; it is checked against JAX's ``upsample_conv_fused`` with its Pallas
kernel in interpret mode at the shapes of tests/test_ops.py:517-518, with
and without the skip, float32 at 1e-5.  ``staged_tile`` (the kernel's
shared-memory 2x tile: halo, clamp and zero rules, csrc/upsample_conv.cu
step 2) against slices of the
library resize with the conv's zero padding, at tiles on every edge and
corner of images with odd H and W, and a tile-by-tile conv built on it
against the whole layer.  ``upsample_conv_layer_composed`` against JAX's
``upsample_conv_layer_composed_apply`` and the port's two-stage layer,
forward and gradients at tests/test_ops.py:611-644's shapes and
tolerances.  The wrapper's gate, weight cache and refusals.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops import upsample_conv as jax_upsample_conv

from rpg_ramnet_tpu_torch.models.layers import (UpsampleConvLayer,
                                                compose_upsample_conv_kernel,
                                                upsample_conv_layer_composed)
from rpg_ramnet_tpu_torch.ops import upsample_conv
from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc

ATOL = RTOL = 1e-5
FUSED_SHAPES = [(1, 16, 24, 8, 8), (2, 8, 8, 16, 8), (1, 32, 16, 8, 16)]
COMPOSED_SHAPES = [(2, 16, 24, 8, 8), (1, 8, 8, 16, 8), (1, 32, 16, 8, 16)]


T = upsample_conv.TILE         # the kernel's output tile
LO, HI = T // 2 + 4, T + 4     # its low-res and 2x tiles, 2-pixel halos


def staged_tile(s: torch.Tensor, y0: int, x0: int) -> torch.Tensor:
    """The 2x tile the kernel stages in shared memory for the output tile
    at 2x pixel (y0, x0), in plain PyTorch with the kernel's index rules:
    from s = x + skip NHWC [B, H, W, C], the low-res rows y0/2-2 ..
    y0/2+T/2+1 (and columns alike) clamped to the image, then 2x pixel
    (y0-2+hy, x0-2+hx) for hy, hx < T+4 as the blend of two rows of
    column blends (2x row 2i: rows i-1, i at 1/4, 3/4; 2i+1: rows i, i+1 at
    3/4, 1/4), 0 outside [0, 2H) x [0, 2W), rounded to s's dtype.
    Returns [B, T+4, T+4, C]: the kernel's border logic, testable on
    the CPU."""
    B, H, W, C = s.shape
    i0, j0 = y0 // 2 - 2, x0 // 2 - 2
    rows = torch.clamp(torch.arange(LO) + i0, 0, H - 1)
    cols = torch.clamp(torch.arange(LO) + j0, 0, W - 1)
    lo = s[:, rows][:, :, cols].float()                  # [B, LO, LO, C]

    def taps(origin, base, n):
        p = origin - 2 + torch.arange(HI)               # 2x coordinates
        odd = p % 2 == 1
        a = torch.where(odd, p // 2 - base,
                        p // 2 - base - 1).clamp(0, LO - 2)
        wa = torch.where(odd, 0.75, 0.25)
        return a, wa, (p >= 0) & (p < 2 * n)

    ra, wa, in_y = taps(y0, i0, H)
    ca, va, in_x = taps(x0, j0, W)
    wa, va = wa[None, :, None, None], va[None, None, :, None]

    def at(dr, dc):
        return lo[:, ra + dr][:, :, ca + dc]

    hi = (wa * (va * at(0, 0) + (1 - va) * at(0, 1))
          + (1 - wa) * (va * at(1, 0) + (1 - va) * at(1, 1)))
    inside = (in_y[:, None] & in_x[None, :])[None, :, :, None]
    return torch.where(inside, hi, 0.0).to(s.dtype)


def _ids(s):
    return "x".join(map(str, s))


def _layer(C, Cout, seed=0):
    """A JAX upsample-conv param dict and the port's layer with its
    weights (JAX HWIO -> OIHW)."""
    p = JL.upsample_conv_layer_init(jax.random.PRNGKey(seed), C, Cout, 5,
                                    None, jnp.float32)
    layer = UpsampleConvLayer(C, Cout, 5, padding=2)
    with torch.no_grad():
        layer.conv2d.weight.copy_(torch.from_numpy(
            np.asarray(p["conv2d"]["weight"]).transpose(3, 2, 0, 1).copy()))
        layer.conv2d.bias.copy_(torch.from_numpy(np.array(p["conv2d"]["bias"])))
    return p, layer


@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "no_skip"])
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=_ids)
def test_fused_matches_jax_kernel(shape, with_skip):
    B, H, W, C, Cout = shape
    p, layer = _layer(C, Cout)
    rng = np.random.RandomState(1)
    x = rng.randn(B, H, W, C).astype(np.float32)
    sk = rng.randn(B, H, W, C).astype(np.float32) if with_skip else None
    want = jax_upsample_conv.upsample_conv_fused(
        p, jnp.asarray(x), skip=None if sk is None else jnp.asarray(sk),
        interpret=True)
    tx = torch.from_numpy(x)
    ts = None if sk is None else torch.from_numpy(sk)
    with torch.no_grad():
        got = upsample_conv.upsample_conv_fused(layer, tx, ts)
        got_pair = upsample_conv.upsample_conv_fused(
            (layer.conv2d.weight, layer.conv2d.bias), tx, ts)
    assert got.shape == (B, 2 * H, 2 * W, Cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(got_pair.numpy(), got.numpy())
    assert upsample_conv.upsample_conv_fused.launches == 0   # CPU: plain


@pytest.mark.parametrize("hwc", [(13, 11, 16), (9, 17, 32)], ids=_ids)
def test_staged_tile_matches_library_resize(hwc):
    """Every tile of an odd-sized image (so tiles on every edge and
    corner, and ragged ones past the image): the staged 2x tile equals the
    library resize zero-padded by 2, and the 5x5 conv over each tile,
    cropped to the image as the kernel's epilogue stores it, rebuilds the
    two-stage layer."""
    H, W, C = hwc
    rng = np.random.RandomState(2)
    s = torch.from_numpy(rng.randn(2, H, W, C).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, C, 5, 5).astype(np.float32) * 0.1)
    up = F.interpolate(to_nchw(s), scale_factor=2, mode="bilinear",
                       align_corners=False)
    padded = to_nhwc(F.pad(up, (2, 2 + upsample_conv.TILE,
                                2, 2 + upsample_conv.TILE)))
    T = upsample_conv.TILE
    out = torch.zeros(2, 2 * H, 2 * W, 8)
    tiles = 0
    for y0 in range(0, 2 * H, T):
        for x0 in range(0, 2 * W, T):
            tile = staged_tile(s, y0, x0)
            assert tile.shape == (2, T + 4, T + 4, C)
            np.testing.assert_allclose(
                tile.numpy(), padded[:, y0:y0 + T + 4, x0:x0 + T + 4].numpy(),
                atol=1e-6, err_msg=f"tile at {(y0, x0)}")
            o = to_nhwc(F.conv2d(to_nchw(tile), w))
            out[:, y0:y0 + T, x0:x0 + T] = o[:, :2 * H - y0, :2 * W - x0]
            tiles += 1
    assert tiles == -(-2 * H // T) * -(-2 * W // T) >= 4
    want = to_nhwc(F.conv2d(up, w, padding=2))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)


def test_compose_kernel_matches_jax():
    _, layer = _layer(8, 16, seed=3)
    p = {"weight": jnp.asarray(layer.conv2d.weight.detach().numpy()
                               .transpose(2, 3, 1, 0))}
    want = np.asarray(JL.compose_upsample_conv_kernel(p["weight"]))
    got = compose_upsample_conv_kernel(layer.conv2d.weight.detach())
    # JAX: flipped HWIO for a dilated correlation; the port:
    # conv_transpose2d's [C, Cout, 8, 8], unflipped
    np.testing.assert_allclose(got.numpy(),
                               np.flip(want, (0, 1)).transpose(2, 3, 0, 1),
                               atol=1e-6)


@pytest.mark.parametrize("shape", COMPOSED_SHAPES, ids=_ids)
def test_composed_layer_matches_jax_and_two_stage(shape):
    B, H, W, C, Cout = shape
    p, layer = _layer(C, Cout)
    rng = np.random.RandomState(2)
    x = rng.randn(B, H, W, C).astype(np.float32)

    def loss_jax(p, x):
        return jnp.sum(jnp.sin(JL.upsample_conv_layer_composed_apply(
            p, x, "relu")))

    want = JL.upsample_conv_layer_composed_apply(p, jnp.asarray(x), "relu")
    g_p, g_x = jax.grad(loss_jax, argnums=(0, 1))(p, jnp.asarray(x))
    tx = to_nchw(torch.from_numpy(x)).requires_grad_()
    got = upsample_conv_layer_composed(layer, tx, "relu")
    np.testing.assert_allclose(to_nhwc(got).detach().numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(to_nhwc(got).detach().numpy(),
                               to_nhwc(layer(tx)).detach().numpy(),
                               atol=ATOL, rtol=RTOL)
    torch.sin(got).sum().backward()
    tol = dict(atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(to_nhwc(tx.grad).numpy(), np.asarray(g_x), **tol)
    np.testing.assert_allclose(
        layer.conv2d.weight.grad.numpy(),
        np.asarray(g_p["conv2d"]["weight"]).transpose(3, 2, 0, 1), **tol)
    np.testing.assert_allclose(layer.conv2d.bias.grad.numpy(),
                               np.asarray(g_p["conv2d"]["bias"]), **tol)


def test_supports_gate():
    def x(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    assert upsample_conv.supports(x((6, 32, 64, 256)), 128)
    assert upsample_conv.supports(x((96, 128, 256, 64)), 32,
                                  skip=x((96, 128, 256, 64)))
    assert upsample_conv.supports(x((1, 9, 13, 16)), 8)       # odd H, W
    assert not upsample_conv.supports(x((6, 32, 64, 256), torch.float32), 128)
    assert not upsample_conv.supports(x((6, 32, 64, 24)), 128)    # C % 16
    assert not upsample_conv.supports(x((6, 32, 64, 256)), 12)    # Cout % 8
    # an NCHW-contiguous tensor viewed as NHWC: the kernel copies nothing
    nchw = x((6, 256, 32, 64)).permute(0, 2, 3, 1)
    assert not upsample_conv.supports(nchw, 128)
    assert not upsample_conv.supports(x((6, 32, 64, 256)), 128, skip=nchw)
    # the block's shared memory: one slab of 64 channels at pitch 72
    assert upsample_conv.smem_bytes(256) == (12 * 12 + 20 * 20) * 72 * 2


def test_wrapper_refuses_autograd_and_bad_arguments():
    _, layer = _layer(16, 8)
    x = torch.randn(1, 8, 8, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        upsample_conv.upsample_conv_fused(layer, x)
    with torch.no_grad():
        with pytest.raises(ValueError, match="activation"):
            upsample_conv.upsample_conv_fused(layer, x, activation="sigmoid")
        with pytest.raises(ValueError, match="skip"):
            upsample_conv.upsample_conv_fused(layer, x, x[:, :4])
        with pytest.raises(ValueError, match="w must be"):
            upsample_conv.upsample_conv_fused(layer, x[..., :8])
        y = upsample_conv.upsample_conv_fused(layer, x, activation=None)
    assert (y < 0).any()


def test_fused_weights_cached_per_version_and_dtype():
    _, layer = _layer(16, 8)
    with torch.no_grad():
        w1, b1 = layer.fused_weights(torch.bfloat16)
        assert layer.fused_weights(torch.bfloat16)[0] is w1
        assert w1.shape == (25, 8, 16) and w1.dtype == torch.bfloat16
        assert b1.dtype == torch.float32
        np.testing.assert_array_equal(
            w1[7].float().numpy(),
            layer.conv2d.weight[:, :, 1, 2].to(torch.bfloat16).float().numpy())
        assert layer.fused_weights(torch.float32)[0].dtype == torch.float32
        layer.conv2d.weight.add_(1.0)
        w2, _ = layer.fused_weights(torch.bfloat16)
    assert w2 is not w1
    assert torch.equal(w2[0], layer.conv2d.weight[:, :, 0, 0].to(torch.bfloat16))
