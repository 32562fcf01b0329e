"""The port's per-package streaming path against the JAX package's.

Tiny flagship-shaped config (2 encoders, base 8, 1 residual block, K=2,
32x64): ``StreamingInference.step`` with batched decode on and off and
with decode_keys, and ``step_modality``, against the JAX engine over three
packages in float32 at 1e-5; ``forward_package_batched_decode`` with
allow_fused in bf16 ('auto' on the CPU runs K5's plain version) against
JAX with fused_gru='on' and its Pallas kernel in interpret mode, at 5e-2
on the sigmoid predictions; the host pieces of the live path
(``CropParameters``, ``EventPreprocessor``, ``UnsharpMaskFilter``, both
event readers, metrics, ``optimal_scale``) against the JAX package's; and
the checkpoint loader, a per-lane reset mask in forward_package against
JAX's, the unported options and the decoder's opt-in ones.
"""
import dataclasses
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.eval import filters as jfilters
from rpg_ramnet_tpu.eval import inference as jinference
from rpg_ramnet_tpu.eval import metrics as jmetrics
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import event_preprocess as jpre
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside
from rpg_ramnet_tpu.utils import event_readers as jreaders

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import MeshConfig, ModelConfig
from rpg_ramnet_tpu_torch.eval import filters, inference, metrics
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.ops import event_preprocess, gru_hside
from rpg_ramnet_tpu_torch.parallel import make_mesh
from rpg_ramnet_tpu_torch.train import checkpoint
from rpg_ramnet_tpu_torch.utils import event_readers
from torch_threads import one_thread  # noqa: F401

ATOL_F32 = 1e-5
ATOL_BF16 = 5e-2
H, W, K, N_PKG = 32, 64, 2, 3
CFG = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
           state_combination="convgru", num_encoders=2, base_num_channels=8,
           num_residual_blocks=1, recurrent_block_type="conv", norm="none",
           use_upsample_conv=True, every_x_rgb_frame=K, baseline=False)


def _models(**over):
    d = {**CFG, **over}
    jcfg = JaxModelConfig.from_dict(d)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    params_from_jax(model, params)
    return jcfg, params, model


def _packages(seed=0):
    rng = np.random.RandomState(seed)
    return [{"events": rng.randn(K, H, W, 5).astype(np.float32),
             "image": rng.rand(H, W, 1).astype(np.float32)}
            for _ in range(N_PKG)]


ENGINES = {"batched_decode": dict(batched_decode=True),
           "per_step_decode": dict(batched_decode=False),
           "decode_keys": dict(batched_decode=True,
                               decode_keys=("image", "events1"))}


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_step_matches_jax_engine(mode):
    jcfg, params, model = _models()
    j_engine = jinference.StreamingInference(params, jcfg, **ENGINES[mode])
    t_engine = inference.StreamingInference(model, **ENGINES[mode])
    for pkg in _packages():
        want, got = j_engine.step(pkg), t_engine.step(pkg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == (H, W, 1) and got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], atol=ATOL_F32)
    # the state carries; reset starts again from zero
    t_engine.reset(1, H, W)
    again = t_engine.step(_packages()[0])
    first = inference.StreamingInference(model, **ENGINES[mode]).step(
        _packages()[0])
    for k in first:
        np.testing.assert_array_equal(again[k], first[k])


def test_step_modality_matches_jax_engine():
    jcfg, params, model = _models()
    j_engine = jinference.StreamingInference(params, jcfg)
    t_engine = inference.StreamingInference(model)
    for i, pkg in enumerate(_packages(1)):
        x = pkg["events"][0]
        want = j_engine.step_modality(x, "events")
        got = t_engine.step_modality(x, "events")
        assert isinstance(got, np.ndarray) and got.shape == (H, W, 1)
        np.testing.assert_allclose(got, want, atol=ATOL_F32)
        # a tensor in gives a tensor out on the model's device
        if i == 0:
            other = inference.StreamingInference(model)
            t = other.step_modality(torch.from_numpy(x), "events")
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), got)


def test_fused_package_bf16_matches_jax_pallas_kernel(monkeypatch):
    jcfg, params, model = _models(compute_dtype="bfloat16", fused_gru="on")
    # the port's 'on' needs CUDA; 'auto' with allow_fused on the CPU runs
    # K5's plain version, the counterpart of the JAX kernel in interpret mode
    model.cfg = dataclasses.replace(model.cfg, fused_gru="auto")
    calls = []
    real = gru_hside.conv_gru_full
    monkeypatch.setattr(gru_hside, "conv_gru_full",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    monkeypatch.setattr(jax_gru_hside, "_INTERPRET", True)
    fwd = jax.jit(lambda p, s, pkg: JaxModel.forward_package_batched_decode(
        p, jcfg, s, pkg, allow_fused=True))
    j_state = JaxModel.init_state(jcfg, 1, H, W)
    t_state = model.init_state(1, H, W)
    for pkg in _packages(2):
        batched = {k: v[None] for k, v in pkg.items()}
        j_state, want = fwd(params, j_state, {k: jnp.asarray(v)
                                              for k, v in batched.items()})
        with torch.inference_mode():
            t_state, got = model.forward_package_batched_decode(
                t_state, {k: torch.from_numpy(v) for k, v in batched.items()},
                allow_fused=True)
        for k in want:
            d = np.abs(got[k].float().numpy() - np.asarray(want[k], np.float32))
            assert d.max() < ATOL_BF16, (k, d.max())
    # every cell of every step went through K5's wrapper: 2 scales x (K+1)
    assert len(calls) == 2 * (K + 1) * N_PKG
    assert real.launches == 0      # no kernel launch on the CPU


def test_unported_options_raise():
    _, _, model = _models()
    # a spatial mesh whose bands do not split H into whole bands of every
    # scale (tests/test_torch_spatial.py runs the ones that do)
    engine = inference.StreamingInference(model, spatial_mesh=make_mesh(
        MeshConfig(data=1, model=3), [torch.device("cpu")] * 3))
    with pytest.raises(ValueError, match="multiple of 2\\*\\*num_encoders"):
        engine.reset(1, 32, 32)
    # a per-lane reset mask is ported: forward_package with one against
    # JAX's, lanes from a non-zero state, lane 0 reset, lane 1 not
    jcfg, params, _ = _models()
    fwd = jax.jit(lambda p, s, pkg: JaxModel.forward_package(p, jcfg, s, pkg))
    j_state, t_state = JaxModel.init_state(jcfg, 2, H, W), model.init_state(2, H, W)
    pkgs = [{k: np.stack([a[k], b[k]]) for k in a}
            for a, b in zip(_packages(4), _packages(5))]
    with torch.inference_mode():
        for i, pkg in enumerate(pkgs):
            if i:
                pkg = {**pkg, "reset": np.array([True, False])}
            j_state, want = fwd(params, j_state,
                                {k: jnp.asarray(v) for k, v in pkg.items()})
            t_state, got = model.forward_package(
                t_state, {k: torch.from_numpy(v) for k, v in pkg.items()})
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                           atol=ATOL_F32)
    # the decoder's opt-in formulations are ported: both configs build
    # and run one package on the CPU (K8's plain version where its gate
    # holds, the composed layers), as the default does
    want = inference.StreamingInference(model).step(_packages()[0])
    for name in ("fused_decoder", "composed_decoder"):
        for mode in ("on", "off"):
            other = ERGB2DepthRecurrent(ModelConfig.from_dict({**CFG,
                                                               name: mode}))
            other.load_state_dict(model.state_dict())
            got = inference.StreamingInference(other).step(_packages()[0])
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=ATOL_F32)


@pytest.mark.parametrize("hw", [(260, 346), (256, 512), (17, 30)],
                         ids=lambda s: "x".join(map(str, s)))
def test_crop_parameters_match_jax(hw):
    h, w = hw
    t, j = inference.CropParameters(w, h, 3), jinference.CropParameters(w, h, 3)
    assert (t.height_crop, t.width_crop, t.padding_top, t.padding_left) == \
        (j.height_crop, j.width_crop, j.padding_top, j.padding_left)
    x = np.random.RandomState(0).randn(2, h, w, 5).astype(np.float32)
    want = np.asarray(j.pad(jnp.asarray(x)))
    np.testing.assert_array_equal(t.pad(x), want)
    np.testing.assert_array_equal(t.pad(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(t.crop(t.pad(x)), x)
    assert inference.optimal_crop_size(h, 3) == jinference.optimal_crop_size(h, 3)


def test_preprocessor_filter_metrics_match_jax():
    rng = np.random.RandomState(3)
    grid = rng.randn(2, 24, 30, 5).astype(np.float32)
    grid[grid < 0.2] = 0.0
    hot = np.array([[3, 4], [29, 23], [0, 0]])
    for kw in (dict(), dict(flip=True), dict(no_normalize=True, flip=True)):
        want = np.asarray(jpre.EventPreprocessor(hot_pixel_locations=hot, **kw)(
            jnp.asarray(grid)))
        got = event_preprocess.EventPreprocessor(hot_pixel_locations=hot, **kw)(
            torch.from_numpy(grid))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=1e-5)
    one = event_preprocess.EventPreprocessor(hot_pixel_locations=hot)(
        torch.from_numpy(grid[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(jpre.EventPreprocessor(
        hot_pixel_locations=hot)(jnp.asarray(grid[0]))), atol=ATOL_F32, rtol=1e-5)

    img = rng.rand(24, 30, 1).astype(np.float32)
    for amount, sigma in ((0.3, 1.0), (0.8, 2.0), (0.0, 1.0)):
        want = np.asarray(jfilters.UnsharpMaskFilter(amount, sigma)(jnp.asarray(img)))
        got = filters.UnsharpMaskFilter(amount, sigma)
        np.testing.assert_allclose(got(img), want, atol=ATOL_F32)
        np.testing.assert_allclose(got(torch.from_numpy(img)).numpy(), want,
                                   atol=ATOL_F32)
    assert filters.ImageFilter(0.0)(img) is img

    pred, targ = rng.rand(1, 1, 24, 30), rng.rand(1, 1, 24, 30)
    targ[0, 0, :3] = np.nan
    np.testing.assert_allclose(metrics.eval_metrics(pred, targ),
                               jmetrics.eval_metrics(pred, targ), rtol=1e-12)
    assert inference.optimal_scale(pred[0, 0, 3:], targ[0, 0, 3:], 3.7, 80.0) == \
        jinference.optimal_scale(pred[0, 0, 3:], targ[0, 0, 3:], 3.7, 80.0)


def _event_log(path, n=2500, seed=4):
    """A header line, then 't x y p' rows, as the reference's logs."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(0.0, 0.2, n))
    with open(path, "w") as f:
        f.write("346 260\n")
        for ti, x, y, p in zip(t, rng.randint(0, 346, n), rng.randint(0, 260, n),
                               rng.randint(0, 2, n)):
            f.write(f"{ti:.9f} {x} {y} {p}\n")
    return path


@pytest.mark.parametrize("container", ["txt", "zip"])
def test_event_readers_match_jax(tmp_path, container):
    path = _event_log(str(tmp_path / "events.txt"))
    if container == "zip":
        with zipfile.ZipFile(str(tmp_path / "events.zip"), "w") as z:
            z.write(path, "events.txt")
        path = str(tmp_path / "events.zip")
    for make in (lambda m: m.FixedSizeEventReader(path, num_events=700,
                                                  start_index=5),
                 lambda m: m.FixedDurationEventReader(path, duration_ms=30.0,
                                                      start_index=3)):
        want, got = list(make(jreaders)), list(make(event_readers))
        assert len(got) == len(want) > 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b, np.float64))


def test_load_any(tmp_path):
    _, params, model = _models()
    other = ERGB2DepthRecurrent(model.cfg, generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "m.pth.tar")
    checkpoint.export_pth_tar(path, model, "ERGB2DepthRecurrent", {"k": 1}, epoch=3)
    meta = checkpoint.load_any(path, other)
    assert meta == {"config": {"k": 1}, "epoch": 3}
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    # an Orbax directory is read through its tree/_METADATA
    os.makedirs(tmp_path / "orbax" / "tree")
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        checkpoint.load_any(str(tmp_path / "orbax"), other)
