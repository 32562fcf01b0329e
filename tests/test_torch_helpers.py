"""The port's remaining public helpers against the JAX package's, on the
CPU, on seeded numpy inputs: the log-depth transforms (numpy and torch),
``sobel_magnitude``, ``closest_element_to``, ``IntensityRescaler`` over
a sequence of frames (its EMA state), and ``summary``'s lines and totals,
from the model and from the eval entry point.  ``ops`` exports JAX's
names.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rpg_ramnet_tpu.ops as jops
from rpg_ramnet_tpu.core.config import Config as JaxConfig
from rpg_ramnet_tpu.data.timestamps import closest_element_to as jax_closest
from rpg_ramnet_tpu.eval.writers import IntensityRescaler as JaxRescaler
from rpg_ramnet_tpu.models.model import get_model as jax_get_model
from rpg_ramnet_tpu.models.model import summary as jax_summary

import rpg_ramnet_tpu_torch.ops as ops
from rpg_ramnet_tpu_torch.core.config import Config
from rpg_ramnet_tpu_torch.data import generate_split
from rpg_ramnet_tpu_torch.data.timestamps import closest_element_to
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.eval.writers import IntensityRescaler
from rpg_ramnet_tpu_torch.models import build_model
from rpg_ramnet_tpu_torch.models.model import summary
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
CLIP, REG = 80.0, 3.70378


def _depths(seed=0, shape=(2, 7, 9, 1)):
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.0, 120.0, shape).astype(np.float32)
    d.flat[:3] = (0.0, CLIP, 200.0)        # zero, the clip, beyond it
    return d


def test_ops_exports_jax_names():
    assert set(ops.__all__) == set(jops.__all__) - {"events_to_voxel_grid_host"}
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


@pytest.mark.parametrize("clip_prediction", [False, True])
def test_log_to_depth_np_matches_jax(clip_prediction):
    x = np.random.RandomState(1).uniform(-0.2, 1.2, (3, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        ops.log_to_depth_np(x, CLIP, REG, clip_prediction),
        jops.log_to_depth_np(x, CLIP, REG, clip_prediction))


@pytest.mark.parametrize("clip_prediction", [False, True])
def test_torch_log_depth_transforms_match_jax(clip_prediction):
    d = _depths()
    got = ops.depth_to_log(torch.from_numpy(d), CLIP, REG)
    want = np.asarray(jops.depth_to_log(jnp.asarray(d), CLIP, REG))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), ops.depth_to_log_np(d, CLIP, REG),
                               rtol=1e-6, atol=1e-7)
    x = np.random.RandomState(2).uniform(-0.2, 1.2, d.shape).astype(np.float32)
    back = ops.log_to_depth(torch.from_numpy(x), CLIP, REG, clip_prediction)
    want = np.asarray(jops.log_to_depth(jnp.asarray(x), CLIP, REG,
                                        clip_prediction))
    np.testing.assert_allclose(back.numpy(), want, rtol=1e-6)
    # the round trip inside (exp(-reg) * clip, clip)
    inside = np.exp(-REG) * CLIP < d.ravel()
    inside &= d.ravel() < CLIP
    rt = ops.log_to_depth(got, CLIP, REG).numpy().ravel()
    np.testing.assert_allclose(rt[inside], d.ravel()[inside], rtol=1e-5)


def test_sobel_magnitude_matches_jax():
    x = np.random.RandomState(3).randn(2, 9, 11, 3).astype(np.float32)
    got = ops.sobel_magnitude(torch.from_numpy(x))
    want = np.asarray(jops.sobel_magnitude(jnp.asarray(x)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    eps = ops.sobel_magnitude(torch.from_numpy(x), eps=0.5).numpy()
    np.testing.assert_allclose(
        eps, np.asarray(jops.sobel_magnitude(jnp.asarray(x), eps=0.5)),
        rtol=1e-5, atol=1e-6)


def test_closest_element_to_matches_jax():
    rng = np.random.RandomState(4)
    values = np.cumsum(rng.uniform(0.01, 0.2, 40))
    reqs = np.concatenate([rng.uniform(-0.5, values[-1] + 0.5, 200), values,
                           (values[:-1] + values[1:]) / 2,   # the ties
                           [values[0] - 1.0, values[-1] + 1.0]])
    for req in reqs:
        assert closest_element_to(values, req) == jax_closest(values, req)
    assert closest_element_to(np.array([2.5]), 7.0) == (0, 2.5, 4.5)
    with pytest.raises(AssertionError):
        closest_element_to(np.array([]), 0.0)


@pytest.mark.parametrize("auto_hdr, size, percentile",
                         [(True, 10, 1.0), (True, 3, 5.0), (False, 10, 1.0)])
def test_intensity_rescaler_matches_jax_over_frames(auto_hdr, size, percentile):
    rng = np.random.RandomState(5)
    kw = dict(auto_hdr=auto_hdr, imin=0.5, imax=30.0,
              median_filter_size=size, percentile=percentile)
    port, ref = IntensityRescaler(**kw), JaxRescaler(**kw)
    for t in range(12):
        frame = (rng.gamma(2.0, 5.0 + t, (24, 31)) + t).astype(np.float32)
        out = port(frame)
        np.testing.assert_array_equal(out, ref(frame))
        assert out.min() >= 0.0 and out.max() <= 1.0
        assert port._min_ema == ref._min_ema and port._max_ema == ref._max_ema
    if auto_hdr:
        # an exponential average of the percentiles, not the last frame's
        assert port._max_ema != np.percentile(frame, 100.0 - percentile)
    else:
        assert port._min_ema is None


def _groups(lines):
    """{group: count} and the total of summary's lines."""
    rows = lines.splitlines()
    groups = {}
    for row in rows[1:-1]:
        name, n = row.strip().split(": ")
        groups[name] = int(n[:-len(" params")].replace(",", ""))
    return groups, int(rows[-1].split(": ")[1].replace(",", ""))


def _running_stats(params):
    """{group: count} of the BN/IN running stats in a JAX param tree,
    which JAX's summary counts and the port holds as buffers (the
    reference's summary counts parameters that require grad alone)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        if str(getattr(path[-1], "key", "")).startswith("running_"):
            group = path[0].key
            out[group] = out.get(group, 0) + int(np.prod(np.shape(leaf)))
    return out


@pytest.mark.parametrize(
    "path, over",
    [(p, {"base_num_channels": 8}) for p in CONFIGS]
    + [(CONFIGS[-1], {"base_num_channels": 8, **z}) for z in (
        {"state_combination": "convlstm", "recurrent_block_type": "convlstm"},
        {"state_combination": "conv", "skip_type": "concat"},
        {"state_combination": "sum", "norm": "IN"},
        {"norm": "BN", "use_upsample_conv": False})],
    ids=[os.path.basename(p)[36:-5] for p in CONFIGS]
    + ["convlstm", "conv_concat", "sum_IN", "BN_transposed"])
def test_summary_matches_jax(path, over):
    cfg = Config.load(path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **over))
    jcfg = JaxConfig.load(path)
    jmodel = dataclasses.replace(jcfg.model, **over)
    params = jax_get_model(jcfg.arch).init_params(jax.random.PRNGKey(0), jmodel)
    port_lines, jax_lines = [], []
    total = summary(build_model(cfg), cfg.arch, log=port_lines.append)
    jtotal = jax_summary(params, jcfg.arch, log=jax_lines.append)
    groups, printed = _groups(port_lines[0])
    jgroups, jprinted = _groups(jax_lines[0])
    assert port_lines[0].splitlines()[0] == jax_lines[0].splitlines()[0] \
        == f"Model: {cfg.arch}"
    assert printed == total == sum(groups.values()) > 0 and jprinted == jtotal
    stats = _running_stats(params)
    assert bool(stats) == (over.get("norm") in ("BN", "IN"))
    assert total == jtotal - sum(stats.values())
    assert groups == {g: n - stats.get(g, 0) for g, n in jgroups.items()}


def test_eval_entry_prints_summary(tmp_path, monkeypatch, capsys):
    raw = {"name": "tiny", "arch": "ERGB2DepthRecurrent",
           "data_loader": {"validation": {"every_x_rgb_frame": 2,
                                          "clip_distance": CLIP,
                                          "reg_factor": REG}},
           "model": {"recurrent_block_type": "conv",
                     "state_combination": "convgru", "num_encoders": 2,
                     "base_num_channels": 4, "num_residual_blocks": 1,
                     "norm": "none", "every_x_rgb_frame": 2}}
    generate_split(str(tmp_path / "data/test"), n_sequences=1, n_frames=4,
                   height=20, width=24)
    (tmp_path / "config.json").write_text(json.dumps(raw))
    cfg = Config.from_dict(raw)
    model = build_model(cfg)
    export_pth_tar(str(tmp_path / "m.pth.tar"), model, cfg.arch, raw)
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(tmp_path / "data"))
    eval_main(["--path_to_model", str(tmp_path / "m.pth.tar"), "--config",
               str(tmp_path / "config.json"), "--data_folder", "test",
               "--crop", "16,16", "--device", "cpu"])
    printed = capsys.readouterr().out
    lines = []
    summary(model, cfg.arch, log=lines.append)
    assert lines[0] in printed
    assert printed.index("Loading model weights") < printed.index(
        "Trainable parameters")
