"""The model zoo's options in StateNet and the UNet, and the engines on
them, in the port against the JAX package.

One seeded port model per configuration, its running stats set to seeded
values off torch's init, crossed into a JAX param tree; numpy-seeded
inputs at small size (2 encoders, base 8, K=2, B=2, 16x32):

- StateNet: a covering set of norm (None, BN, IN) x skip (sum, concat,
  no_skip) x decoder (two-stage, fast, transposed), ConvLSTM encoders
  without use_phased_arch, the state combinations 'conv' and 'sum' (also
  in the baselines), the phased encoders under a norm: two packages of
  ``forward_package`` (eval-mode norms), every prediction and every state
  tensor;
- the UNet: its norm, skip and decoder options through
  ``forward_sequence``, and 'no_skip', on which JAX raises and which the
  port refuses;
- the engines on normed configs: the chunked path with x precompute, the
  deferred decode of ConvLSTM encoders and the per-package engine, against
  JAX and against forward_package; a bf16 chunked run against JAX's
  float32 maps;
- where the fused decoder K8 runs (its plain version on the CPU): every
  layer with skip=None under no_skip, never under a norm or a concat skip.

Float32 at atol 2e-5, rtol 1e-4 (tests/test_torch_model.py); bf16 at atol
5e-2 (tests/test_torch_model.py's bf16 bound).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import ERGB2Depth as JaxUNet
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel

from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.eval import SequenceScanInference, StreamingInference
from rpg_ramnet_tpu_torch.models import (ERGB2Depth, ERGB2DepthRecurrent,
                                         event_loop_range, unet)
from rpg_ramnet_tpu_torch.ops import upsample_conv

from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from torch_threads import one_thread  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
ATOL_BF16 = 5e-2
B, K, H, W = 2, 2, 16, 32
BASE = dict(num_bins_events=5, num_bins_rgb=1, num_encoders=2,
            base_num_channels=8, num_residual_blocks=1, every_x_rgb_frame=K,
            recurrent_block_type="conv", state_combination="convgru",
            skip_type="sum", norm="none", use_upsample_conv=True)
CASES = {
    "BN": dict(norm="BN"),
    "IN": dict(norm="IN"),
    "concat": dict(skip_type="concat"),
    "no_skip": dict(skip_type="no_skip"),
    "transposed": dict(use_upsample_conv=False),
    "fast": dict(fast_upsample=True),
    "convlstm_encoders": dict(recurrent_block_type="convlstm"),
    "conv_combination_BN": dict(state_combination="conv", norm="BN"),
    "sum_combination_IN": dict(state_combination="sum", norm="IN"),
    "BN_concat_transposed": dict(norm="BN", skip_type="concat",
                                 use_upsample_conv=False),
    "IN_convlstm_encoders_no_skip": dict(
        norm="IN", recurrent_block_type="convlstm", skip_type="no_skip"),
    "concat_fast": dict(skip_type="concat", fast_upsample=True),
    "BN_fast_no_skip_convlstm_combination": dict(
        norm="BN", fast_upsample=True, skip_type="no_skip",
        state_combination="convlstm"),
    "baseline_rgb_conv_combination_BN": dict(
        baseline="rgb", state_combination="conv", norm="BN"),
    "baseline_ergb0_sum_combination_IN_concat": dict(
        baseline="ergb0", num_bins_rgb=6, state_combination="sum",
        norm="IN", skip_type="concat"),
    "phased_BN_transposed": dict(
        recurrent_block_type="convlstm", use_phased_arch=True,
        spatial_resolution=[H, W], norm="BN", use_upsample_conv=False),
}


def _perturb_stats(model, seed=11):
    """Running stats and BN affines away from torch's init, so the eval
    norms do something."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            r = torch.rand(buf.shape, generator=g)
            buf.copy_(0.5 + r if "var" in name else r - 0.5)
        for name, p in model.named_parameters():
            if p.dim() == 1 and ("norm_layer" in name or ".bn" in name):
                p.add_(torch.rand(p.shape, generator=g) - 0.5)


def _models(over, cls=ERGB2DepthRecurrent):
    d = dict(BASE, **over)
    model = cls(ModelConfig.from_dict(d),
                generator=torch.Generator().manual_seed(5))
    _perturb_stats(model)
    return jconfig.ModelConfig.from_dict(d), _jax_tree(model), model


def _package(cfg, seed):
    """A package's NHWC inputs (a baseline's events take the image
    branch's channels) and the phased timestamps."""
    rng = np.random.RandomState(seed)
    loop = event_loop_range(cfg)
    ce = cfg.num_bins_rgb if cfg.is_baseline else cfg.num_bins_events
    pkg = {"events": rng.randn(B, loop, H, W, ce).astype(np.float32),
           "image": rng.rand(B, H, W, cfg.num_bins_rgb).astype(np.float32)}
    if cfg.use_phased_arch:
        t = np.cumsum(rng.uniform(0.005, 0.02, (B, loop + 1)), 1)
        pkg["times_events"] = t[:, :loop].astype(np.float32)
        pkg["times_image"] = t[:, loop].astype(np.float32)
    return pkg


def _sequence(cfg, n, seed=0):
    pkgs = [_package(cfg, seed + t) for t in range(n)]
    return {k: np.stack([p[k] for p in pkgs], 1) for k in pkgs[0]}


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [x for s in state for x in _leaves(s)]


def _close(got, want, atol=ATOL, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_statenet_option_matches_jax(case):
    """Two packages of forward_package from the zero state: every
    prediction and every state tensor (super states, the ConvLSTM and
    phased encoders' pairs)."""
    jcfg, params, model = _models(CASES[case])
    jstate = JaxModel.init_state(jcfg, B, H, W)
    state = model.init_state(B, H, W)
    for t in range(2):
        pkg = _package(model.cfg, t)
        jstate, jpreds = JaxModel.forward_package(
            params, jcfg, jstate, {k: jnp.asarray(v) for k, v in pkg.items()})
        with torch.no_grad():
            state, preds = model.forward_package(
                state, {k: torch.from_numpy(v) for k, v in pkg.items()})
        assert sorted(preds) == sorted(jpreds)
        for k in preds:
            _close(preds[k].numpy(), jpreds[k], err_msg=f"{t} {k}")
    jl, tl = jax.tree_util.tree_leaves(jstate), _leaves(state)
    assert len(jl) == len(tl) > 0
    for a, b in zip(tl, jl):
        _close(a.numpy(), b)


UNET_CASES = {
    "BN": dict(norm="BN"), "IN": dict(norm="IN"),
    "concat": dict(skip_type="concat"),
    "transposed": dict(use_upsample_conv=False),
    "fast": dict(fast_upsample=True),
    "BN_concat_fast": dict(norm="BN", skip_type="concat", fast_upsample=True),
    "IN_concat_transposed": dict(norm="IN", skip_type="concat",
                                 use_upsample_conv=False),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet_option_matches_jax(case):
    over = dict(UNET_CASES[case], baseline="ergb", num_bins_rgb=6)
    jcfg, params, model = _models(over, ERGB2Depth)
    x = np.random.RandomState(3).randn(B, 3, H, W, 6).astype(np.float32)
    _, jpreds = JaxUNet.forward_sequence(params, jcfg, (),
                                         {"image": jnp.asarray(x)})
    with torch.no_grad():
        _, preds = model.forward_sequence((), {"image": torch.from_numpy(x)})
    _close(preds["image"].numpy(), jpreds["image"])


def test_unet_no_skip_raises_in_jax_and_is_refused():
    """JAX sizes the UNet's decoders for a concat and feeds them the
    unskipped tensor: its forward raises, and the port refuses the
    option."""
    d = dict(BASE, baseline="ergb", num_bins_rgb=6, skip_type="no_skip")
    jcfg = jconfig.ModelConfig.from_dict(d)
    # zeros of the init's shapes: the init's compiles are not the point
    params = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda k: JaxUNet.init_params(k, jcfg),
                       jax.random.PRNGKey(0)))
    with pytest.raises((TypeError, ValueError)):
        JaxUNet.forward_package(params, jcfg, (),
                                {"image": jnp.zeros((1, H, W, 6))})
    with pytest.raises(NotImplementedError, match="JAX reference raises"):
        ERGB2Depth(ModelConfig.from_dict(d))
    with pytest.raises(NotImplementedError, match="no_skip"):
        unet.check_supported(ModelConfig.from_dict(d))


# -- the engines --------------------------------------------------------------


def _torch_seq(seq):
    return {k: torch.from_numpy(v) for k, v in seq.items()}


def test_chunked_precompute_on_a_normed_config_matches_jax():
    """BN, concat skips and transposed-conv decoders with conv encoders:
    x precompute holds (JAX statenet.py:315-323), so the chunked engine's
    path is forward_sequence_precomputed, the encoders' norms in eval
    mode; against JAX's and against the port's per-package maps."""
    jcfg, params, model = _models(CASES["BN_concat_transposed"])
    seq = _sequence(model.cfg, 3)
    jstate, jpreds = JaxModel.forward_sequence_precomputed(
        params, jcfg, JaxModel.init_state(jcfg, B, H, W),
        {k: jnp.asarray(v) for k, v in seq.items()})
    state, preds = model.forward_sequence_precomputed(
        model.init_state(B, H, W), _torch_seq(seq))
    for k in jpreds:
        _close(preds[k].numpy(), jpreds[k], err_msg=k)
    for a, b in zip(_leaves(state), jax.tree_util.tree_leaves(jstate)):
        _close(a.numpy(), b)
    engine = SequenceScanInference(model, chunk=2, batched_decode=True,
                                   precompute_x=True)
    out = engine.run_sequence(seq["events"][0], seq["image"][0])
    per = StreamingInference(model)
    for t in range(3):
        got = per.step({"events": seq["events"][0, t],
                        "image": seq["image"][0, t]})
        for k in got:
            _close(out[k][t], got[k], err_msg=f"{t} {k}")
            _close(got[k], jpreds[k][t, 0], err_msg=f"{t} {k}")


def test_convlstm_encoders_take_the_deferred_decode_as_jax():
    """ConvLSTM encoders without use_phased_arch keep their own state, so
    x precompute does not hold: the chunked engine runs
    forward_sequence_batched_decode, which equals JAX's and resets the
    encoders' states of a flagged lane too."""
    jcfg, params, model = _models(CASES["IN_convlstm_encoders_no_skip"])
    seq = _sequence(model.cfg, 3)
    reset = np.zeros((B, 3), bool)
    reset[1, 2] = True
    seq["reset"] = reset
    jstate, jpreds = JaxModel.forward_sequence_batched_decode(
        params, jcfg, JaxModel.init_state(jcfg, B, H, W),
        {k: jnp.asarray(v) for k, v in seq.items()})
    with torch.no_grad():
        state, preds = model.forward_sequence_batched_decode(
            model.init_state(B, H, W), _torch_seq(seq))
    assert len(state.events.encoders) == 2
    for k in jpreds:
        _close(preds[k].numpy(), jpreds[k], err_msg=k)
    for a, b in zip(_leaves(state), jax.tree_util.tree_leaves(jstate)):
        _close(a.numpy(), b)
    with pytest.raises(ValueError, match="requires"):
        model.forward_sequence_precomputed(model.init_state(B, H, W),
                                           _torch_seq(seq))


def test_bf16_chunked_on_a_normed_config_is_close_to_jax_float32():
    """The bf16 chunked path (x precompute, the h-side cells on the K1
    wrapper's plain version for CPU tensors) of the BN + concat +
    transposed config: the norms keep bf16, the maps within bf16's bound
    of JAX's float32 ones."""
    jcfg, params, _ = _models(CASES["BN_concat_transposed"])
    _, _, model = _models(dict(CASES["BN_concat_transposed"],
                               compute_dtype="bfloat16"))
    seq = _sequence(model.cfg, 2)
    _, jpreds = JaxModel.forward_sequence(
        params, jcfg, JaxModel.init_state(jcfg, B, H, W),
        {k: jnp.asarray(v) for k, v in seq.items()})
    state, preds = model.forward_sequence_precomputed(
        model.init_state(B, H, W), _torch_seq(seq))
    assert all(s.dtype == torch.bfloat16 for s in _leaves(state))
    for k in jpreds:
        _close(preds[k].numpy(), jpreds[k], atol=ATOL_BF16, rtol=0,
               err_msg=k)


@pytest.mark.parametrize("case,launches", [
    ("no_skip", 2), ("BN", 0), ("concat", 0)])
def test_fused_decoder_runs_where_jax_gates_it(monkeypatch, case, launches):
    """fused_decoder='on', bf16: K8 (its plain version on the CPU) takes
    every decoder layer with skip=None under no_skip, and none under a
    norm or a concat skip (JAX statenet.py:565-567); the maps equal the
    two-stage layers' within bf16's bound."""
    seen = []
    real = upsample_conv.upsample_conv_fused

    def spy(layer, x, skip=None, *args, **kw):
        seen.append(skip)
        return real(layer, x, skip, *args, **kw)

    monkeypatch.setattr(upsample_conv, "upsample_conv_fused", spy)
    over = dict(CASES[case], compute_dtype="bfloat16", fused_decoder="on")
    _, _, model = _models(over)
    pkg = _torch_seq(_package(model.cfg, 0))
    with torch.no_grad():
        _, fused = model.forward_package(model.init_state(B, H, W), pkg,
                                         allow_fused_decoder=True)
        assert len(seen) == launches * (K + 1)
        assert all(s is None for s in seen)
        _, plain = model.forward_package(model.init_state(B, H, W), pkg)
    for k in plain:
        _close(fused[k].numpy(), plain[k].numpy(), atol=ATOL_BF16, rtol=0)
