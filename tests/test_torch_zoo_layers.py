"""The model zoo's layers in the port against the JAX package's.

Each port layer's weights cross into a JAX param tree (the upstream names,
HWIO conv weights), its running stats set to seeded values off torch's
init, and both packages run numpy-seeded NHWC inputs at small size (B=2,
8-16 channels, maps up to 12x16):

- the norms of ``ConvLayer`` (JAX ``conv_layer_apply``, layers.py:129-244):
  BN and IN in eval mode on the running stats, and in training mode with a
  ``NormCtx`` over three calls of one layer (each call sees the earlier
  update), the outputs and the final stats;
- ``ResidualBlock`` under BN (eval and training) and IN (per-instance
  stats, no running stats);
- ``TransposedConvLayer`` without a norm, under BN in training mode and
  under IN in eval mode;
- ``upsample_conv_layer_fast`` against JAX ``upsample_conv_layer_fast_apply``
  and against the port's two-stage layer, down to 1x1 maps, its gradient
  included;
- ``Recurrent2ConvLayer`` (conv, norm, ConvLSTM) and the phased layer's
  eval-mode norm;
- ``extract_norm_stats``/``merge_norm_stats`` against JAX's on a StateNet,
  and the state dict names against JAX ``params_to_state_dict``;
- a bf16 input keeps its dtype through a norm.

Float32 at atol 2e-5, rtol 1e-4 (tests/test_torch_model.py); the running
stats at atol 1e-6; bf16 at atol 5e-2 against JAX's float32 result
(tests/test_torch_model.py's bf16 bound).
"""
import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict as jax_to_sd
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.models import statenet as jstatenet

from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.models import layers as TL
from rpg_ramnet_tpu_torch.models.statenet import reset_parameters_

from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from torch_threads import one_thread  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
ATOL_STATS = 1e-6
ATOL_BF16 = 5e-2
B = 2


def _init(layer, seed=0):
    """``layer`` with seeded weights and running stats away from (0, 1),
    and its JAX param tree."""
    reset_parameters_(layer, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, buf in layer.named_buffers():
            r = torch.rand(buf.shape, generator=g)
            buf.copy_(0.5 + r if "var" in name else r - 0.5)
        for name, p in layer.named_parameters():
            if name.endswith("norm_layer.weight") or ".bn" in "." + name:
                p.add_(torch.rand(p.shape, generator=g) - 0.5)
    return layer, _jax_tree(nn.ModuleDict({"m": layer}))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    """NHWC numpy -> an NCHW-shaped channels_last tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _n(y):
    return y.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, atol=ATOL, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def _stats_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        for name in ("running_mean", "running_var"):
            _close(got[k][name].numpy(), want[k][name], atol=ATOL_STATS,
                   rtol=0, err_msg=f"{k}.{name}")


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_conv_layer_norm_eval_matches_jax(norm):
    layer, p = _init(TL.ConvLayer(8, 16, 5, 2, 2, norm=norm))
    assert (layer.conv2d.bias is None) == (norm == "BN")
    x = _x((B, 12, 16, 8))
    want = JL.conv_layer_apply(p, jnp.asarray(x), 2, 2, "relu", norm)
    with torch.no_grad():
        _close(_n(layer(_t(x))), want)


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_conv_layer_norm_training_over_repeated_calls_matches_jax(norm):
    """Three calls of one layer in one ctx, as the event encoders run K
    times per package: each normalizes by its batch's statistics and
    moves the stats on from the previous call's update."""
    layer, p = _init(TL.ConvLayer(8, 16, 5, 1, 2, norm=norm))
    layer.norm_layer.key = "enc.norm_layer"
    jctx = JL.NormCtx(JL.extract_norm_stats({"enc": p}))
    ctx = TL.NormCtx(TL.extract_norm_stats(layer))
    for seed in range(3):
        x = _x((B, 12, 16, 8), seed)
        want = JL.conv_layer_apply(p, jnp.asarray(x), 1, 2, "relu", norm,
                                   ctx=jctx, path="enc")
        got = layer(_t(x), ctx)
        _close(_n(got), want, err_msg=str(seed))
    _stats_close(ctx.merged(), jctx.out)
    # the buffers are the starting stats still: only the caller writes
    assert not torch.equal(ctx.merged()["enc.norm_layer"]["running_mean"],
                           layer.norm_layer.running_mean)


@pytest.mark.parametrize("norm,train", [("BN", False), ("BN", True),
                                        ("IN", False)],
                         ids=["BN-eval", "BN-train", "IN"])
def test_residual_block_norms_match_jax(norm, train):
    block, p = _init(TL.ResidualBlock(16, norm))
    assert (block.conv1.bias is None) == (norm == "BN")
    TL.name_norms(block)
    x = _x((B, 6, 8, 16))
    jctx = JL.NormCtx(JL.extract_norm_stats(p)) if train else None
    ctx = TL.NormCtx(TL.extract_norm_stats(block)) if train else None
    want = JL.residual_block_apply(p, jnp.asarray(x), norm, ctx=jctx)
    _close(_n(block(_t(x), ctx)), want)
    if train:
        _stats_close(ctx.merged(), jctx.out)


@pytest.mark.parametrize("norm,train", [(None, False), ("BN", True),
                                        ("IN", False)],
                         ids=["none", "BN-train", "IN-eval"])
def test_transposed_conv_layer_matches_jax(norm, train):
    layer, p = _init(TL.TransposedConvLayer(16, 8, 5, 2, norm=norm))
    assert layer.transposed_conv2d.weight.shape == (16, 8, 5, 5)
    TL.name_norms(layer)
    x = _x((B, 5, 7, 16))
    jctx = JL.NormCtx(JL.extract_norm_stats(p)) if train else None
    ctx = TL.NormCtx(TL.extract_norm_stats(layer)) if train else None
    want = JL.transposed_conv_layer_apply(p, jnp.asarray(x), 2, "relu", norm,
                                          ctx=jctx)
    got = layer(_t(x), ctx)
    assert got.shape == (B, 8, 10, 14)
    _close(_n(got), want)
    if train:
        _stats_close(ctx.merged(), jctx.out)


@pytest.mark.parametrize("hw,norm", [((1, 1), None), ((2, 3), None),
                                     ((5, 7), None), ((6, 8), "BN")],
                         ids=["1x1", "2x3", "5x7", "6x8-BN-train"])
def test_fast_upsample_matches_jax_and_the_two_stage_layer(hw, norm):
    """The four phase convolutions and the border restitch: against JAX's
    fast layer, and against the two-stage layer, which it equals but for
    float summation order, on maps whose borders overlap (below 4x4)."""
    layer, p = _init(TL.UpsampleConvLayer(16, 8, 5, padding=2, norm=norm))
    TL.name_norms(layer)
    train = norm is not None
    x = _x((B, *hw, 16))
    jctx = JL.NormCtx(JL.extract_norm_stats(p)) if train else None
    want = JL.upsample_conv_layer_fast_apply(p, jnp.asarray(x), 2, "relu",
                                             norm, ctx=jctx)
    ctx = TL.NormCtx(TL.extract_norm_stats(layer)) if train else None
    got = TL.upsample_conv_layer_fast(layer, _t(x), ctx)
    assert got.shape == (B, 8, 2 * hw[0], 2 * hw[1])
    _close(_n(got), want)
    ctx2 = TL.NormCtx(TL.extract_norm_stats(layer)) if train else None
    _close(_n(got), _n(layer(_t(x), ctx2)))
    if train:
        _stats_close(ctx.merged(), jctx.out)


def test_fast_upsample_gradient_matches_the_two_stage_layer():
    layer, _ = _init(TL.UpsampleConvLayer(16, 8, 5, padding=2))
    x = _x((B, 6, 5, 16))
    grads = []
    for fn in (lambda t: TL.upsample_conv_layer_fast(layer, t),
               lambda t: layer(t)):
        layer.zero_grad()
        t = _t(x).clone().requires_grad_(True)
        fn(t).square().sum().backward()
        grads.append([t.grad] + [q.grad.clone() for q in layer.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("norm", [None, "BN"], ids=["none", "BN-train"])
def test_recurrent2_conv_layer_matches_jax(norm):
    """Conv (stride 2, the norm), then the ConvLSTM: (hidden, (hidden,
    cell)), two steps from a nonzero state."""
    layer, p = _init(TL.Recurrent2ConvLayer(8, 16, norm))
    TL.name_norms(layer)
    jctx = JL.NormCtx(JL.extract_norm_stats(p)) if norm else None
    ctx = TL.NormCtx(TL.extract_norm_stats(layer)) if norm else None
    h, c = _x((B, 6, 8, 16), 7), _x((B, 6, 8, 16), 8)
    jstate, state = (jnp.asarray(h), jnp.asarray(c)), (_t(h), _t(c))
    for seed in range(2):
        x = _x((B, 12, 16, 8), seed)
        jy, jstate = JL.recurrent2_conv_layer_apply(
            p, jnp.asarray(x), jstate, 2, 2, "convlstm", norm, ctx=jctx)
        y, state = layer(_t(x), state, ctx)
        _close(_n(y), jy)
        for a, b in zip(state, jstate):
            _close(_n(a), b)
    if norm:
        _stats_close(ctx.merged(), jctx.out)


def test_phased_layer_norm_runs_in_eval_mode_as_jax():
    """The phased encoder's conv carries the norm, which JAX runs on the
    running stats, in training too (it passes no ctx)."""
    layer, p = _init(TL.RecurrentPhasedConvLayer(8, 16, 6, 8, "BN"))
    x, t = _x((B, 12, 16, 8)), np.array([0.1, 0.3], np.float32)
    z = np.zeros((B, 6, 8, 16), np.float32)
    jy, _ = JL.recurrent_phased_conv_layer_apply(
        p, jnp.asarray(x), jnp.asarray(t), (jnp.asarray(z),) * 2, 2, 2, "BN")
    with torch.no_grad():
        y, _ = layer(_t(x), torch.from_numpy(t), (_t(z), _t(z)))
    _close(_n(y), jy)


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_norm_stats_and_names_match_jax(norm):
    """extract_norm_stats names every tracked norm by its JAX param path;
    merge_norm_stats writes back the ones it is given; the state dict has
    the names of JAX params_to_state_dict (no num_batches_tracked)."""
    d = dict(num_bins_events=5, num_bins_rgb=1, num_encoders=2,
             base_num_channels=8, num_residual_blocks=1, every_x_rgb_frame=2,
             recurrent_block_type="convlstm", state_combination="conv",
             skip_type="concat", use_upsample_conv=False, norm=norm)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    jcfg = jconfig.ModelConfig.from_dict(d)
    ref = jax.eval_shape(lambda k: jstatenet.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    assert set(model.state_dict()) == set(jax_to_sd(ref))
    assert not any("num_batches" in k for k in model.state_dict())
    stats = TL.extract_norm_stats(model)
    assert sorted(stats) == sorted(JL.extract_norm_stats(ref))
    new = {k: {n: v + 1.0 for n, v in s.items()}
           for k, s in list(stats.items())[:2]}
    kept = {k: {n: v.clone() for n, v in s.items()}
            for k, s in list(stats.items())[2:]}
    TL.merge_norm_stats(model, new)
    after = TL.extract_norm_stats(model)
    for k, s in {**new, **kept}.items():
        for n, v in s.items():
            assert torch.equal(after[k][n], v), (k, n)


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_bf16_input_keeps_its_dtype_through_the_norm(norm):
    """The port's norm computes in float32 and returns the compute dtype;
    JAX's promotes to float32 (its float32 stats and weights), so the
    bound is bf16's."""
    layer, p = _init(TL.ConvLayer(8, 16, 5, 1, 2, norm=norm))
    x = _x((B, 12, 16, 8))
    want = JL.conv_layer_apply(p, jnp.asarray(x, jnp.bfloat16), 1, 2, "relu",
                               norm)
    assert want.dtype == jnp.float32
    with torch.no_grad():
        got = layer(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(_n(got.float()), want, atol=ATOL_BF16, rtol=0)
