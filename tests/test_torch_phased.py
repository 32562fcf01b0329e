"""The phased (irregular-timestamp) RAM-Net and the ConvLSTM state
combination in the port, against the JAX package.

Tiny configs of the two recipes: phased ConvLSTM encoders with the ConvLSTM
state combination (BASELINE config 3's architecture: 2 encoders, base 8,
1 residual block, K=2, 16x32, spatial_resolution = the crop), and the
flagship conv encoders with the ConvLSTM state combination.  The models
and engines against the JAX ones with the same params and the same
numpy-made packages and timestamps: float32 at atol 2e-3 / rtol 1e-3 for
whatever passes through the time gate's fmod (tests/test_phased.py:74-78)
and 1e-5 elsewhere; bf16 with the cell kernels' plain versions against the
JAX kernels in interpret mode at 5e-2 on the sigmoid predictions.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.data import concatenate_subfolders as jconcat
from rpg_ramnet_tpu.eval import inference as jinference
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside

from rpg_ramnet_tpu_torch.compat import params_from_jax, params_to_state_dict
from rpg_ramnet_tpu_torch.core.config import Config, ModelConfig, TrainerConfig
from rpg_ramnet_tpu_torch.data import concatenate_subfolders
from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
from rpg_ramnet_tpu_torch.eval import inference
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, statenet
from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar, load_any
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-3, 1e-3
ATOL_F32 = 1e-5
ATOL_BF16 = 5e-2
H, W, K, L = 16, 32, 2, 3
BASE = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
            num_encoders=2, base_num_channels=8, num_residual_blocks=1,
            norm="none", use_upsample_conv=True, every_x_rgb_frame=K,
            baseline=False)
PHASED = dict(BASE, recurrent_block_type="convlstm",
              state_combination="convlstm", use_phased_arch=True,
              spatial_resolution=[H, W])
LSTM_COMB = dict(BASE, recurrent_block_type="conv",
                 state_combination="convlstm")


def _models(cfg, **over):
    d = {**cfg, **over}
    jcfg = JaxModelConfig.from_dict(d)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    params_from_jax(model, params)
    return jcfg, params, model


def _times(rng, n):
    """Irregular increasing stamps: [n, K] for the event steps, [n] for
    the frames, as a dataset's items carry them."""
    t = np.cumsum(rng.uniform(0.01, 0.2, n * K)).astype(np.float32)
    return t.reshape(n, K), (t.reshape(n, K)[:, -1] + 0.005).astype(np.float32)


def _sequence(seed=0, n=L):
    """[1, n, ...] arrays of a batch-1 sequence with its timestamps."""
    rng = np.random.RandomState(seed)
    te, ti = _times(rng, n)
    return {"events": rng.randn(1, n, K, H, W, 5).astype(np.float32),
            "image": rng.rand(1, n, H, W, 1).astype(np.float32),
            "times_events": te[None], "times_image": ti[None]}


def _leaves(state):
    out = []

    def walk(s):
        if isinstance(s, torch.Tensor):
            out.append(s.float().numpy())
        else:
            for x in s:
                walk(x)
    walk(state)
    return out


def _check_state(t_state, j_state, atol=ATOL, rtol=RTOL):
    jl = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(j_state)]
    tl = _leaves(t_state)
    assert len(tl) == len(jl) > 0
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def _jax_packages(jcfg, params, seq, batched):
    fn = (JaxModel.forward_package_batched_decode if batched
          else JaxModel.forward_package)
    fwd = jax.jit(lambda p, s, pkg: fn(p, jcfg, s, pkg))
    state = JaxModel.init_state(jcfg, 1, H, W)
    preds = []
    for t in range(seq["image"].shape[1]):
        state, p = fwd(params, state, {k: jnp.asarray(v[:, t])
                                       for k, v in seq.items()})
        preds.append({k: np.asarray(v, np.float32) for k, v in p.items()})
    return state, preds


@pytest.mark.parametrize("batched", [False, True],
                         ids=["forward_package", "batched_decode"])
def test_phased_package_matches_jax(batched):
    jcfg, params, model = _models(PHASED)
    seq = _sequence()
    j_state, j_preds = _jax_packages(jcfg, params, seq, batched)
    state = model.init_state(1, H, W)
    assert len(state.events.encoders) == 2 and len(state.super_states[0]) == 2
    fn = (model.forward_package_batched_decode if batched
          else model.forward_package)
    with torch.inference_mode():
        for t in range(L):
            state, p = fn(state, {k: torch.from_numpy(v[:, t])
                                  for k, v in seq.items()})
            assert sorted(p) == ["events0", "events1", "image"]
            for k in p:
                assert p[k].shape == (1, H, W, 1)
                np.testing.assert_allclose(p[k].numpy(), j_preds[t][k],
                                           atol=ATOL, rtol=RTOL)
    _check_state(state, j_state)


def test_phased_sequence_batched_decode_matches_jax():
    """forward_sequence_batched_decode over a window with timestamps,
    state included, against JAX (and decode_keys restricting the decode)."""
    jcfg, params, model = _models(PHASED)
    seq = _sequence(1)
    j_state, j_preds = JaxModel.forward_sequence_batched_decode(
        params, jcfg, JaxModel.init_state(jcfg, 1, H, W),
        {k: jnp.asarray(v) for k, v in seq.items()})
    with torch.inference_mode():
        state, preds = model.forward_sequence_batched_decode(
            model.init_state(1, H, W),
            {k: torch.from_numpy(v) for k, v in seq.items()})
        _, only = model.forward_sequence_batched_decode(
            model.init_state(1, H, W),
            {k: torch.from_numpy(v) for k, v in seq.items()},
            decode_keys=("image",))
    for k in j_preds:
        assert preds[k].shape == (L, 1, H, W, 1)
        np.testing.assert_allclose(preds[k].numpy(), np.asarray(j_preds[k]),
                                   atol=ATOL, rtol=RTOL)
    assert set(only) == {"image"}
    np.testing.assert_array_equal(only["image"].numpy(), preds["image"].numpy())
    _check_state(state, j_state)


def test_phased_time_sensitivity():
    """Other timestamps, other predictions: the time gate is live (the
    pattern of tests/test_phased_model.py:39-58); the same timestamps give
    the same predictions."""
    _, _, model = _models(PHASED)
    seq = {k: torch.from_numpy(v) for k, v in _sequence(2).items()}
    other = dict(seq, times_events=seq["times_events"] * 7.3 + 1.0,
                 times_image=seq["times_image"] * 7.3 + 1.0)
    with torch.inference_mode():
        run = [model.forward_sequence_batched_decode(
                   model.init_state(1, H, W), s)[1]["image"]
               for s in (seq, other, seq)]
    assert torch.isfinite(run[0]).all()
    assert (run[0] - run[1]).abs().max().item() > 1e-5
    assert torch.equal(run[0], run[2])


@pytest.mark.parametrize("recipe", ["phased", "lstm_comb"])
def test_bf16_cell_kernels_match_jax_pallas(recipe, monkeypatch):
    """bf16 with allow_fused: 'auto' on the CPU runs K4's and K3's plain
    versions through their wrappers on every cell (the port's 'on' needs
    CUDA), against JAX with fused_gru='on' and its Pallas kernels in
    interpret mode."""
    cfg = PHASED if recipe == "phased" else LSTM_COMB
    jcfg, params, model = _models(cfg, compute_dtype="bfloat16",
                                  fused_gru="on")
    model.cfg = dataclasses.replace(model.cfg, fused_gru="auto")
    calls = {"k3": 0, "k4": 0}
    real3, real4 = gru_hside.conv_lstm_hside, phased_cell.conv_lstm_phased

    def count(name, real):
        def fn(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(gru_hside, "conv_lstm_hside", count("k3", real3))
    monkeypatch.setattr(phased_cell, "conv_lstm_phased", count("k4", real4))
    monkeypatch.setattr("rpg_ramnet_tpu_torch.models.layers.conv_lstm_phased",
                        count("k4", real4))
    monkeypatch.setattr(jax_gru_hside, "_INTERPRET", True)
    seq = _sequence(3)
    if recipe == "phased":
        j_state, j_preds = _jax_packages(jcfg, params, seq, batched=True)
        j_preds = {k: np.concatenate([p[k] for p in j_preds]) for k in j_preds[0]}
        with torch.inference_mode():
            state, preds = model.forward_sequence_batched_decode(
                model.init_state(1, H, W),
                {k: torch.from_numpy(v) for k, v in seq.items()},
                allow_fused=True)
        preds = {k: v[:, 0] for k, v in preds.items()}
        assert calls == {"k3": 2 * (K + 1) * L, "k4": 2 * (K + 1) * L}
    else:
        seq = {k: seq[k] for k in ("events", "image")}
        j_state, j_preds = JaxModel.forward_sequence_precomputed(
            params, jcfg, JaxModel.init_state(jcfg, 1, H, W),
            {k: jnp.asarray(v) for k, v in seq.items()})
        j_preds = {k: np.asarray(v, np.float32)[:, 0] for k, v in j_preds.items()}
        state, preds = model.forward_sequence_precomputed(
            model.init_state(1, H, W),
            {k: torch.from_numpy(v) for k, v in seq.items()})
        preds = {k: v[:, 0] for k, v in preds.items()}
        assert calls == {"k3": 2 * (K + 1) * L, "k4": 0}
    assert real3.launches == 0 and real4.launches == 0
    for k in j_preds:
        d = np.abs(preds[k].float().numpy() - j_preds[k]).max()
        assert d < ATOL_BF16, (k, d)
    _check_state(state, j_state, atol=ATOL_BF16, rtol=0)


def test_lstm_state_combination_precomputed_matches_jax():
    """The flagship conv encoders with the ConvLSTM state combination on
    forward_sequence_precomputed (float32): (hidden, cell) supers carried
    over two chunks, against JAX's and the port's per-package loop."""
    jcfg, params, model = _models(LSTM_COMB)
    seq = {k: v for k, v in _sequence(4, n=4).items()
           if k in ("events", "image")}
    fwd = jax.jit(lambda p, s, sub: JaxModel.forward_sequence_precomputed(
        p, jcfg, s, sub))
    j_state, t_state = JaxModel.init_state(jcfg, 1, H, W), model.init_state(1, H, W)
    for t0 in (0, 2):
        sub = {k: v[:, t0:t0 + 2] for k, v in seq.items()}
        j_state, j_preds = fwd(params, j_state, {k: jnp.asarray(v)
                                                 for k, v in sub.items()})
        t_state, t_preds = model.forward_sequence_precomputed(
            t_state, {k: torch.from_numpy(v) for k, v in sub.items()})
        for k in j_preds:
            np.testing.assert_allclose(t_preds[k].numpy(),
                                       np.asarray(j_preds[k]), atol=ATOL_F32)
    _check_state(t_state, j_state, atol=ATOL_F32, rtol=0)
    assert isinstance(t_state.super_states[0], tuple)
    # the package loop (whole cells on cat(x, h)) agrees
    state = model.init_state(1, H, W)
    with torch.inference_mode():
        for t in range(4):
            state, _ = model.forward_package(
                state, {k: torch.from_numpy(v[:, t]) for k, v in seq.items()})
    for a, b in zip(_leaves(state), _leaves(t_state)):
        np.testing.assert_allclose(a, b, atol=ATOL_F32)


def test_streaming_inference_with_times_matches_jax():
    """StreamingInference.step with timestamps in the packages against the
    JAX engine (batched decode), and step without them (zeros) differs."""
    jcfg, params, model = _models(PHASED)
    seq = _sequence(5)
    j_engine = jinference.StreamingInference(params, jcfg, batched_decode=True)
    t_engine = inference.StreamingInference(model, batched_decode=True)
    for t in range(L):
        pkg = {"events": seq["events"][0, t], "image": seq["image"][0, t],
               "times_events": seq["times_events"][0, t],
               "times_image": seq["times_image"][0, t]}
        want, got = j_engine.step(pkg), t_engine.step(pkg)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL)
    untimed = inference.StreamingInference(model, batched_decode=True).step(
        {"events": seq["events"][0, 0], "image": seq["image"][0, 0]})
    first = inference.StreamingInference(model, batched_decode=True).step(
        {k: seq[k][0, 0] for k in seq})
    assert np.abs(untimed["image"] - first["image"]).max() > 1e-6


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A synthetic on-disk test split of two sequences (5 and 4 packages)
    whose timestamps the phased datasets read."""
    root = tmp_path_factory.mktemp("phased")
    for s, n in enumerate((10, 8)):
        generate_eventscape_sequence(str(root / "data/test" / f"s{s}"),
                                     seed=s, n_frames=n, height=H, width=W,
                                     events_per_frame=300)
    return root


def _datasets(root):
    kw = dict(sequence_length=1, every_x_rgb_frame=K, clip_distance=80.0,
              use_phased_arch=True)
    args = (str(root / "data/test"), "SequenceSynchronizedFramesEventsDataset",
            "events/voxels", "depth/data", "rgb/data")
    return concatenate_subfolders(*args, **kw), jconcat(*args, **kw)


def test_phased_dataset_items_match_jax(split):
    port, jds = _datasets(split)
    assert len(port) == len(jds) == 9
    for i in (0, 4, 5, 8):
        a, da = port[i]
        b, db = jds[i]
        assert da == db
        assert a["times_events"].shape == (1, K) and a["times_image"].shape == (1,)
        for k in ("times_events", "times_image", "events", "image"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("precompute", [None, False])
def test_chunked_streaming_phased_matches_jax(split, precompute):
    """run_chunked_streaming with chunks of 2 over the split (padded tail
    chunks, a reset at the sequence boundary) against the JAX engine: the
    phased config routes to forward_sequence_batched_decode under auto and
    off alike, with the chunk's timestamps."""
    jcfg, params, model = _models(PHASED)
    port, jds = _datasets(split)
    got, want = {}, {}
    inference.run_chunked_streaming(
        port, model, chunk=2, precompute_x=precompute,
        on_prediction=lambda g, p, item, pos: got.__setitem__(g, (pos, p)))
    jinference.run_chunked_streaming(
        jds, params, jcfg, chunk=2, precompute_x=precompute,
        on_prediction=lambda g, p, item, pos: want.__setitem__(g, (pos, p)))
    assert sorted(got) == sorted(want) == list(range(9))
    for g in want:
        assert got[g][0] == want[g][0]
        for k in want[g][1]:
            np.testing.assert_allclose(got[g][1][k], np.asarray(want[g][1][k]),
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cfg,dtype,want", [
    (PHASED, "bfloat16", False), (PHASED, "float32", False),
    (LSTM_COMB, "bfloat16", True), (dict(LSTM_COMB, state_combination="convgru"),
                                    "bfloat16", True),
    (LSTM_COMB, "float32", False)],
    ids=["phased_bf16", "phased_f32", "lstm_comb_bf16", "flagship_bf16",
         "lstm_comb_f32"])
def test_resolve_precompute_follows_supports_x_precompute(cfg, dtype, want,
                                                          monkeypatch):
    """_resolve_precompute under auto agrees with the JAX function, and
    the chunked engine takes the route it names: the phased bf16 config
    goes to forward_sequence_batched_decode, allow_fused only for 'on'."""
    d = dict(cfg, compute_dtype=dtype)
    jcfg, tcfg = JaxModelConfig.from_dict(d), ModelConfig.from_dict(d)
    assert inference._resolve_precompute(tcfg, None) == want
    assert jinference._resolve_precompute(jcfg, None, JaxModel) == want
    model = ERGB2DepthRecurrent(tcfg)
    seen = []
    monkeypatch.setattr(model, "forward_sequence_precomputed",
                        lambda s, seq, **kw: seen.append(("pre", kw)) or (s, {}))
    monkeypatch.setattr(model, "forward_sequence_batched_decode",
                        lambda s, seq, **kw: seen.append(("bd", kw)) or (s, {}))
    engine = inference.SequenceScanInference(model, chunk=2,
                                             batched_decode=True)
    engine.run_sequence(np.zeros((2, K, H, W, 5), np.float32),
                        np.zeros((2, H, W, 1), np.float32))
    assert seen[0][0] == ("pre" if want else "bd")
    if not want:
        assert seen[0][1]["allow_fused"] is False


def _cli_setup(root, cfg_dict, name):
    config = {"name": name, "arch": "ERGB2DepthRecurrent",
              "use_phased_arch": True,
              "data_loader": {s: {"every_x_rgb_frame": K, "step_size": 1,
                                  "clip_distance": 80.0, "reg_factor": 3.70378}
                              for s in ("train", "validation")},
              "model": {k: v for k, v in cfg_dict.items()
                        if k not in ("every_x_rgb_frame", "baseline")}}
    (root / f"{name}.json").write_text(json.dumps(config))
    cfg = Config.from_dict(config)
    assert cfg.use_phased_arch and cfg.model.use_phased_arch
    model = ERGB2DepthRecurrent(cfg.model,
                                generator=torch.Generator().manual_seed(3))
    export_pth_tar(str(root / f"{name}.pth.tar"), model, cfg.arch, config)
    return model


def test_eval_entry_point_phased_matches_test_py(split, monkeypatch):
    """``python -m rpg_ramnet_tpu_torch.eval`` on the phased config against
    the repo's test.py (a subprocess on the CPU) on the same split and
    .pth.tar: the same output tree, the saved predictions within the fmod
    tolerance; and --scan_chunk against the per-package engine."""
    _cli_setup(split, PHASED, "phased")
    args = ["--path_to_model", str(split / "phased.pth.tar"), "--config",
            str(split / "phased.json"), "--data_folder", "test",
            "--crop", f"{H},{W}"]
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2",
           "PREPROCESSED_DATASETS_FOLDER": str(split / "data")}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "test.py"), *args,
                           "--output_path", str(split / "out_jax")],
                          cwd=split, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(split / "data"))
    per_package, chunked = {}, {}
    eval_main([*args, "--output_path", str(split / "out_port"), "--device",
               "cpu"], on_prediction=per_package.__setitem__)

    def tree(r):
        return sorted(os.path.relpath(os.path.join(d, f), r)
                      for d, _, fs in os.walk(r) for f in fs)
    names = tree(split / "out_port")
    assert names == tree(split / "out_jax")
    npys = [n for n in names if n.endswith(".npy")]
    # 5 + 4 packages, kept from the third on: 3 + 2 items, each with a
    # prediction, a ground truth and a label per key
    assert len(npys) == (3 + 2) * 3 * (K + 1)
    for n in npys:
        np.testing.assert_allclose(np.load(split / "out_port" / n),
                                   np.load(split / "out_jax" / n),
                                   atol=ATOL, rtol=RTOL, err_msg=n)
    eval_main([*args, "--device", "cpu", "--scan_chunk", "2"],
              on_prediction=chunked.__setitem__)
    assert sorted(chunked) == sorted(per_package) == list(range(9))
    for i in per_package:
        for k in per_package[i]:
            np.testing.assert_allclose(chunked[i][k], per_package[i][k],
                                       atol=ATOL_F32)


@pytest.mark.parametrize("recipe", ["phased", "lstm_comb"])
def test_params_load_strict(recipe, tmp_path):
    """A phased / ConvLSTM JAX param tree loads with strict=True (the 1-D
    tau and phase untransposed), and a .pth.tar round trip keeps it."""
    cfg = PHASED if recipe == "phased" else LSTM_COMB
    _, params, model = _models(cfg)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert sorted(sd) == sorted(got)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    pre = "statenetphasedrecurrent."
    if recipe == "phased":
        tau = got[pre + "encoders_rgb.1.recurrent_block.phased_cell.tau"]
        assert tau.shape == (32 * (H // 4) * (W // 4),)
        assert got[pre + "encoders_events.0.recurrent_block.lstm.Gates.weight"
                   ].shape == (64, 32, 3, 3)
    assert got[pre + "state_combination_images.0.recurrent_block.Gates.weight"
               ].shape == (64, 32, 3, 3)
    path = str(tmp_path / "m.pth.tar")
    export_pth_tar(path, model, "ERGB2DepthRecurrent", {})
    other = ERGB2DepthRecurrent(model.cfg,
                                generator=torch.Generator().manual_seed(9))
    load_any(path, other)
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("recipe", ["phased", "lstm_comb"])
def test_training_and_unported_raise(recipe):
    """Either recipe trains: make_sequence_loss builds, and one window's
    loss is finite with a gradient for every parameter.  Plain convlstm
    encoders (no use_phased_arch) build and train too; what stays
    unported is the ConvLSTM-combination baseline, in check_supported
    and in make_sequence_loss."""
    mcfg = ModelConfig.from_dict(PHASED if recipe == "phased" else LSTM_COMB)
    cfg = Config(model=mcfg, use_phased_arch=recipe == "phased",
                 trainer=TrainerConfig(deferred_decode=True))
    model = ERGB2DepthRecurrent(mcfg)
    seq = _sequence(n=2)
    rng = np.random.RandomState(1)
    batch = {k: torch.from_numpy(v) for k, v in seq.items()}
    batch["depth_events"] = torch.from_numpy(
        rng.rand(1, 2, K, H, W, 1).astype(np.float32))
    batch["depth_image"] = torch.from_numpy(
        rng.rand(1, 2, H, W, 1).astype(np.float32))
    loss, _ = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(1, H, W), batch)
    loss.backward()
    assert np.isfinite(loss.item())
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    plain = dataclasses.replace(mcfg, recurrent_block_type="convlstm",
                                use_phased_arch=False)
    statenet.check_supported(plain)
    model = ERGB2DepthRecurrent(plain)
    loss, _ = make_sequence_loss(Config(model=plain), remat=True)(
        model, model.init_state(1, H, W), batch)
    assert np.isfinite(loss.item())
    unported = dataclasses.replace(mcfg, baseline="rgb",
                                   state_combination="convlstm")
    with pytest.raises(NotImplementedError, match="JAX reference raises"):
        statenet.check_supported(unported)
    with pytest.raises(NotImplementedError, match="JAX reference raises"):
        make_sequence_loss(Config(model=unported))
