"""The fused decoder layer (kernel K8's wrapper and formulation) and the
composed decoder layer of the port, against the JAX package.

``ops.upsample_conv.upsample_conv_fused`` runs its plain version on the
CPU; it is checked against JAX's ``upsample_conv_fused`` with its Pallas
kernel in interpret mode at the shapes of tests/test_ops.py:517-518, with
and without the skip, float32 at 1e-5.  The kernel's formulation: its
phase-weight fold against JAX ``layers._phase_kernels``, its border
weights against JAX ``prep_weights``'s ``c_first``/``c_last`` (rows) and
against direct sums over w's out-of-range taps (columns, corners), and
``phase_emulated`` (the kernel's tile, halo, phase and border rules in
plain PyTorch, csrc/upsample_conv.cu) against JAX
``upsample_conv_layer_fast_apply``, the JAX kernel in interpret mode and
the two-stage layer, at border shapes down to 1x1.
``upsample_conv_layer_composed`` against JAX's
``upsample_conv_layer_composed_apply`` and the port's two-stage layer,
forward and gradients at tests/test_ops.py:611-644's shapes and
tolerances.  The wrapper's gate, weight cache and refusals.
"""
import numpy as np
import pytest
import torch

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


def phase_emulated(w: torch.Tensor, b, x: torch.Tensor,
                   skip=None, activation="relu") -> torch.Tensor:
    """K8's formulation in plain PyTorch with the kernel's index and tile
    rules, in float32: the weights of ``kernel_weights`` (phase kernels,
    negated edge terms, corner terms); per low-res tile of TILE x TILE,
    the sum s = x + skip (rounded to x's dtype) staged with a 2-pixel
    halo whose rows and columns are clamped to the image; per union tap
    (tr, tc) of the 5x5 window, the tile's pixels at offset (tr - 2,
    tc - 2) times every phase (p, q) whose 4x4 support holds the tap (a =
    tr - p, b = tc - q); the top and bottom edge terms on the tile rows
    at image row 0 and H - 1 at taps (2, b + q), the left and right ones
    on the pixels at column 0 and W - 1 at taps (a + p, 2), the corner
    terms at (2, 2) on the four corner pixels; then each phase stored at
    (2i + p, 2j + q) for the pixels inside the image, bias, activation.
    NHWC in and out, [B, 2H, 2W, Cout]."""
    B, H, W, C = x.shape
    T = upsample_conv.TILE
    wk, bk = upsample_conv.kernel_weights(w, b, torch.float32)
    cp, cout = wk.shape[1], w.shape[0]
    main = wk[:64].reshape(2, 4, 2, 4, cp, C)            # [p][a][q][b]
    edges = wk[64:128].reshape(4, 2, 2, 4, cp, C)        # [side][p][q][tap]
    corners = wk[128:].reshape(4, 2, 2, cp, C)           # [corner][p][q]
    s = (x if skip is None else x + skip.to(x.dtype)).float()
    out = torch.zeros(B, 2 * H, 2 * W, cp)
    for i0 in range(0, H, T):
        for j0 in range(0, W, T):
            rows = torch.clamp(torch.arange(T + 4) + i0 - 2, 0, H - 1)
            cols = torch.clamp(torch.arange(T + 4) + j0 - 2, 0, W - 1)
            tile = s[:, rows][:, :, cols]                 # [B, T+4, T+4, C]

            def tap(tr, tc):
                return tile[:, tr:tr + T, tc:tc + T]

            i, j = torch.arange(T) + i0, torch.arange(T) + j0
            at_row = ((i == 0)[:, None], (i == H - 1)[:, None])   # [T, 1]
            at_col = ((j == 0)[None], (j == W - 1)[None])         # [1, T]
            acc = torch.zeros(2, 2, B, T, T, cp)
            for p in range(2):
                for q in range(2):
                    for tr in range(p, p + 4):
                        for tc in range(q, q + 4):
                            acc[p, q] += tap(tr, tc) @ main[p, tr - p, q,
                                                            tc - q].T
                    for t in range(4):
                        for side in range(2):
                            acc[p, q] += at_row[side][..., None] * (
                                tap(2, t + q) @ edges[side, p, q, t].T)
                            acc[p, q] += at_col[side][..., None] * (
                                tap(t + p, 2) @ edges[2 + side, p, q, t].T)
                    for k in range(4):
                        mask = at_row[k // 2] & at_col[k % 2]
                        acc[p, q] += mask[..., None] * (
                            tap(2, 2) @ corners[k, p, q].T)
            h, w_ = min(T, H - i0), min(T, W - j0)
            for p in range(2):
                for q in range(2):
                    out[:, 2 * i0 + p:2 * (i0 + h):2,
                        2 * j0 + q:2 * (j0 + w_):2] = acc[p, q, :, :h, :w_]
    y = out[..., :cout] + bk
    return torch.relu(y) if activation == "relu" else y


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


FOLD_SHAPES = [(8, 8), (16, 24), (32, 16)]          # C, Cout
BORDER_HW = [(1, 1), (2, 3), (3, 2), (4, 4), (13, 27), (18, 33)]


def _hwio(layer):
    return jnp.asarray(layer.conv2d.weight.detach().numpy()
                       .transpose(2, 3, 1, 0))


@pytest.mark.parametrize("c_cout", FOLD_SHAPES, ids=_ids)
def test_phase_weights_match_jax(c_cout):
    C, Cout = c_cout
    _, layer = _layer(C, Cout, seed=4)
    want = JL._phase_kernels(_hwio(layer))
    got = upsample_conv.phase_weights(layer.conv2d.weight.detach())
    assert got.shape == (2, 2, 4, 4, Cout, C) and got.dtype == torch.float32
    for (p, q), k in want.items():
        np.testing.assert_allclose(got[p, q].numpy(),
                                   np.asarray(k).transpose(0, 1, 3, 2),
                                   atol=ATOL, rtol=RTOL)


def _out_of_range(taps_at, n):
    """The taps k of a 5-tap axis that fall outside [0, n) from 2x
    coordinate taps_at (k - 2 offsets)."""
    return [k for k in range(5) if not 0 <= taps_at + k - 2 < n]


@pytest.mark.parametrize("c_cout", FOLD_SHAPES, ids=_ids)
def test_border_weights_match_jax_and_direct_sums(c_cout):
    """Rows against JAX prep_weights' c_first / c_last ([5 kx, C, 2 Cout],
    the phases side by side); columns and corners against sums of w over
    the taps outside a 2x image of 8 x 8 at its first and last two rows
    and columns, derived here from the tap offsets alone."""
    C, Cout = c_cout
    _, layer = _layer(C, Cout, seed=5)
    w = layer.conv2d.weight.detach()
    _, c_first, c_last = jax_upsample_conv.prep_weights(_hwio(layer),
                                                        jnp.float32)
    rows, cols, corners = upsample_conv.border_weights(w)
    for side, want in enumerate((c_first, c_last)):
        want = np.asarray(want).reshape(5, C, 2, Cout).transpose(2, 0, 3, 1)
        np.testing.assert_allclose(rows[side].numpy(), want, atol=ATOL,
                                   rtol=RTOL)
    n = 8
    for side, at in enumerate(((0, 1), (n - 2, n - 1))):
        for q in range(2):
            kx = _out_of_range(at[q], n)
            want = w[:, :, :, kx].sum(-1).permute(2, 0, 1)
            np.testing.assert_allclose(cols[side, q].numpy(), want.numpy(),
                                       atol=ATOL, rtol=RTOL)
    for vs, ys in enumerate(((0, 1), (n - 2, n - 1))):
        for hs, xs in enumerate(((0, 1), (n - 2, n - 1))):
            for p in range(2):
                for q in range(2):
                    ky, kx = _out_of_range(ys[p], n), _out_of_range(xs[q], n)
                    want = w[:, :, ky][:, :, :, kx].sum((-1, -2))
                    np.testing.assert_allclose(
                        corners[vs, hs, p, q].numpy(), want.numpy(),
                        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "no_skip"])
@pytest.mark.parametrize("hw", BORDER_HW, ids=_ids)
def test_phase_emulated_matches_fast_apply_and_two_stage(hw, with_skip):
    """The kernel's formulation at images down to one pixel (top and
    bottom, left and right border terms on the same pixels) and across
    several tiles, against JAX upsample_conv_layer_fast_apply (phase
    convolutions, borders restitched from the reference op) and the
    two-stage layer."""
    H, W = hw
    C, Cout = 16, 24
    p, layer = _layer(C, Cout, seed=6)
    rng = np.random.RandomState(7)
    x = rng.randn(2, H, W, C).astype(np.float32)
    sk = rng.randn(2, H, W, C).astype(np.float32) if with_skip else None
    s = x if sk is None else x + sk
    want = np.asarray(JL.upsample_conv_layer_fast_apply(p, jnp.asarray(s)))
    tx = torch.from_numpy(x)
    ts = None if sk is None else torch.from_numpy(sk)
    w, b = layer.conv2d.weight.detach(), layer.conv2d.bias.detach()
    got = phase_emulated(w, b, tx, ts)
    assert got.shape == (2, 2 * H, 2 * W, Cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    two_stage = upsample_conv.upsample_conv_fused_plain(w, b, tx, ts)
    np.testing.assert_allclose(got.numpy(), two_stage.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("with_skip", [True, False], ids=["skip", "no_skip"])
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=_ids)
def test_phase_emulated_matches_jax_kernel(shape, with_skip):
    """The kernel's formulation against the JAX kernel in interpret mode,
    where its gate admits the shape (W % 8 == 0, H % 4 == 0)."""
    B, H, W, C, Cout = shape
    p, layer = _layer(C, Cout, seed=8)
    rng = np.random.RandomState(9)
    x = rng.randn(B, H, W, C).astype(np.float32)
    sk = rng.randn(B, H, W, C).astype(np.float32) if with_skip else None
    want = jax_upsample_conv.upsample_conv_fused(
        p, jnp.asarray(x), skip=None if sk is None else jnp.asarray(sk),
        interpret=True)
    got = phase_emulated(layer.conv2d.weight.detach(),
                         layer.conv2d.bias.detach(), torch.from_numpy(x),
                         None if sk is None else torch.from_numpy(sk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


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
        with pytest.raises(ValueError, match="border_terms"):
            upsample_conv.upsample_conv_fused(layer, x, border_terms=False)
        y = upsample_conv.upsample_conv_fused(layer, x, activation=None)
    assert (y < 0).any()


def test_fused_weights_cached_per_version_and_dtype():
    """The kernel's fold, cached per weight version and dtype: the phase
    blocks first ([p][a][q][b]), then the negated edge terms and the
    corner terms, Cout padded with zeros to whole slices of NC."""
    _, layer = _layer(16, 8)
    with torch.no_grad():
        w1, b1 = layer.fused_weights(torch.bfloat16)
        assert layer.fused_weights(torch.bfloat16)[0] is w1
        assert w1.shape == (144, upsample_conv.NC, 16)
        assert w1.dtype == torch.bfloat16 and b1.dtype == torch.float32
        w = layer.conv2d.weight
        phase = upsample_conv.phase_weights(w)
        edges, corners = upsample_conv.edge_weights(w)
        np.testing.assert_array_equal(
            w1[(1 * 4 + 2) * 8 + 0 * 4 + 3, :8].float().numpy(),
            phase[1, 0, 2, 3].to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(
            w1[64 + ((2 * 2 + 1) * 2 + 0) * 4 + 1, :8].float().numpy(),
            (-edges[2, 1, 0, 1]).to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(
            w1[128 + (3 * 2 + 0) * 2 + 1, :8].float().numpy(),
            corners[3, 0, 1].to(torch.bfloat16).float().numpy())
        assert not w1[:, 8:].any()
        assert layer.fused_weights(torch.float32)[0].dtype == torch.float32
        layer.conv2d.weight.add_(1.0)
        w2, _ = layer.fused_weights(torch.bfloat16)
    assert w2 is not w1
    np.testing.assert_array_equal(
        w2[:64, :8].float().numpy(),
        upsample_conv.phase_weights(layer.conv2d.weight.detach()).permute(
            0, 2, 1, 3, 4, 5).reshape(64, 8, 16).to(torch.bfloat16)
        .float().numpy())
