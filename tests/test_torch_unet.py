"""The non-recurrent baseline ERGB2Depth (a plain UNet) in the port against
the JAX package.

One seeded port model's weights, crossed into a JAX param tree, at small
size (2 encoders, base 4, 16x32, B=2, L=3) on numpy-seeded inputs:

- the parameter tree and the upstream ``unet.`` names, both ways, and a
  ``.pth.tar`` round trip that loads with strict=True;
- ``forward_package`` on 'image' (NHWC) and 'image_cf' (NCHW), and
  ``forward_sequence`` on the batch-leading 'image' and the chunked
  engines' time-leading 'image_tcf', squeezed and not; bf16 compute;
- the options of ``unet.check_supported`` (norms, skips, decoders)
  against JAX, and its one refusal, 'no_skip', on which JAX raises;
- the raw-event datasets (``SynchronizedFramesEventsRawDataset`` and the
  ``recurrency=False`` windows) against JAX's on a tiny on-disk split;
- the first step's loss and every gradient (``make_sequence_loss``);
- the eval entry point against ``test.py`` (per package, --scan_chunk,
  --lanes 2), the training entry point for one tiny epoch, and the live
  path, which both packages refuse for ERGB2Depth.

Float32 at ATOL_F32 = 2e-5 with rtol 1e-4 (tests/test_torch_model.py);
gradients at the JAX package's training tolerance (atol 5e-5, rtol 1e-3,
tests/test_torch_train.py); bf16 at 5e-2 (tests/test_torch_model.py).
"""
import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu import data as jdata
from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict as jax_to_sd
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.eval import inference as jinference
from rpg_ramnet_tpu.models import ERGB2Depth as JaxUNetModel
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss

from rpg_ramnet_tpu_torch import data as tdata
from rpg_ramnet_tpu_torch import stream
from rpg_ramnet_tpu_torch.compat import load_reference_checkpoint, params_from_jax
from rpg_ramnet_tpu_torch.core.config import Config, ModelConfig
from rpg_ramnet_tpu_torch.eval import StreamingInference
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import ERGB2Depth, build_model, unet
from rpg_ramnet_tpu_torch.train.__main__ import main as train_main
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar, load_any
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss

from test_torch_baselines import XLA_ONE_THREAD
from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_F32, RTOL_F32 = 2e-5, 1e-4
ATOL_GRAD, RTOL_GRAD = 5e-5, 1e-3
ATOL_BF16 = 5e-2
B, L, K, H, W = 2, 3, 3, 16, 32
SHIPPED = os.path.join(REPO, "configs", "train_e2depth_si_grad_loss_statenet_"
                       "baseline_ergb_no_recurrent.json")
CFG = dict(num_bins_rgb=6, num_bins_events=5, skip_type="sum",
           num_encoders=2, base_num_channels=4, num_residual_blocks=1,
           norm="none", use_upsample_conv=True, every_x_rgb_frame=K,
           recurrent_block_type="conv", state_combination="convgru",
           baseline="ergb")


def _models(**over):
    d = {**CFG, **over}
    model = ERGB2Depth(ModelConfig.from_dict(d),
                       generator=torch.Generator().manual_seed(4))
    return jconfig.ModelConfig.from_dict(d), _jax_tree(model), model


def _images(seed=0):
    return np.random.RandomState(seed).randn(B, L, H, W, 6).astype(np.float32)


def _close(got, want, atol=ATOL_F32, rtol=RTOL_F32, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def test_params_cross_both_ways(tmp_path):
    """The port's parameters are the JAX init's tree under the upstream
    ``unet.`` names; a reference-named .pth.tar loads with strict=True,
    and an export of the port reloads to the same weights."""
    jcfg, params, model = _models()
    ref = jax.eval_shape(lambda k: JaxUNetModel.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(ref))
    sd = jax_to_sd(params, "ERGB2Depth")
    assert set(sd) == set(model.state_dict())
    assert all(k.startswith("unet.") for k in sd)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"arch": "ERGB2Depth", "state_dict": {
        k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}},
        path)
    fresh = ERGB2Depth(model.cfg, generator=torch.Generator().manual_seed(8))
    load_reference_checkpoint(fresh, path)
    out = str(tmp_path / "out.pth.tar")
    export_pth_tar(out, fresh, "ERGB2Depth", {})
    again = ERGB2Depth(model.cfg, generator=torch.Generator().manual_seed(9))
    load_any(out, again)
    other = ERGB2Depth(model.cfg, generator=torch.Generator().manual_seed(7))
    params_from_jax(other, params, "ERGB2Depth")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, atol=0, rtol=0)
        torch.testing.assert_close(other.state_dict()[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("layout", ["image", "image_cf"])
def test_forward_package_matches_jax(layout):
    jcfg, params, model = _models()
    x = _images()[:, 0]
    inp = x if layout == "image" else np.ascontiguousarray(
        np.moveaxis(x, -1, 1))
    _, jpreds = JaxUNetModel.forward_package(params, jcfg, (),
                                             {layout: jnp.asarray(inp)})
    with torch.no_grad():
        state, preds = model.forward_package(
            model.init_state(B, H, W), {layout: torch.from_numpy(inp),
                                        "events": torch.zeros(B, 0, H, W, 0)})
    assert state == () and set(preds) == set(jpreds) == {"image"}
    assert preds["image"].shape == (B, H, W, 1)
    _close(preds["image"].numpy(), jpreds["image"])


@pytest.mark.parametrize("layout", ["image", "image_tcf"])
@pytest.mark.parametrize("squeeze", [False, True])
def test_forward_sequence_matches_jax(layout, squeeze):
    """L packages as one batch: batch-leading 'image' [B, L, H, W, C] or
    the time-leading channel-first 'image_tcf' [L, B, C, H, W]; the
    predictions time-leading either way, and equal to forward_package's
    per package."""
    jcfg, params, model = _models()
    x = _images(1)
    inp = x if layout == "image" else np.ascontiguousarray(
        np.transpose(x, (1, 0, 4, 2, 3)))
    _, jpreds = JaxUNetModel.forward_sequence(
        params, jcfg, (), {layout: jnp.asarray(inp)}, squeeze_preds=squeeze)
    with torch.no_grad():
        _, preds = model.forward_sequence((), {layout: torch.from_numpy(inp)},
                                          squeeze_preds=squeeze)
        _, per_pkg = model.forward_package((), {"image": torch.from_numpy(
            np.ascontiguousarray(x[:, 1]))})
    want = (L, B, H, W) if squeeze else (L, B, H, W, 1)
    assert preds["image"].shape == want == jpreds["image"].shape
    _close(preds["image"].numpy(), jpreds["image"])
    got1 = preds["image"][1] if squeeze else preds["image"][1, ..., 0]
    torch.testing.assert_close(got1, per_pkg["image"][..., 0], atol=1e-6,
                               rtol=1e-5)


def test_bf16_compute_matches_jax():
    jcfg, params, model = _models(compute_dtype="bfloat16")
    x = _images(2)[:, 0]
    _, jpreds = JaxUNetModel.forward_package(params, jcfg, (),
                                             {"image": jnp.asarray(x)})
    with torch.no_grad():
        _, preds = model.forward_package((), {"image": torch.from_numpy(x)})
    assert preds["image"].dtype == torch.float32
    _close(preds["image"].numpy(), jpreds["image"], atol=ATOL_BF16, rtol=0)


@pytest.mark.parametrize("over", [
    dict(norm="BN"), dict(norm="IN"), dict(skip_type="concat"),
    dict(skip_type="no_skip"), dict(use_upsample_conv=False),
    dict(fast_upsample=True)],
    ids=["BN", "IN", "concat", "no_skip", "transposed", "fast_upsample"])
def test_check_supported_refuses_unported_options(over):
    """The UNet's options build and match JAX's forward_sequence (float32
    tolerance above), the norms on running stats off torch's init; the
    one refusal is 'no_skip', whose JAX layers are sized for a concat, so
    that JAX's forward raises (ROADMAP queue 3)."""
    if over.get("skip_type") == "no_skip":
        cfg = ModelConfig.from_dict({**CFG, **over})
        with pytest.raises(NotImplementedError, match="JAX reference raises"):
            ERGB2Depth(cfg)
        with pytest.raises(NotImplementedError, match="queue 3"):
            unet.check_supported(cfg)
        return
    jcfg, _, model = _models(**over)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5) if "var" in name else buf.uniform_(-.5, .5)
    params = _jax_tree(model)
    x = _images(4)
    _, jpreds = JaxUNetModel.forward_sequence(params, jcfg, (),
                                              {"image": jnp.asarray(x)})
    with torch.no_grad():
        _, preds = model.forward_sequence((), {"image": torch.from_numpy(x)})
    _close(preds["image"].numpy(), jpreds["image"])


# -- the raw-event datasets --------------------------------------------------


@pytest.fixture(scope="module")
def raw_split(tmp_path_factory):
    """A JAX-written split whose raw event files also sit in events/voxels,
    the folder the no_recurrent config names."""
    root = tmp_path_factory.mktemp("raw_split")
    jdata.synthetic.generate_split(str(root), seed=6, n_sequences=2,
                                   n_frames=10, height=30, width=28,
                                   events_per_frame=400)
    for seq in os.listdir(root):
        d = root / seq / "events"
        for f in os.listdir(d / "data"):
            if f.endswith("_events.npy"):
                shutil.copy(d / "data" / f, d / "voxels" / f)
    return str(root)


@pytest.fixture
def numpy_voxelizer(monkeypatch):
    """JAX's host voxelizer on its numpy path (it prefers a C++ helper of
    the same semantics, built on import): exact comparisons, no build."""
    monkeypatch.setitem(sys.modules, "rpg_ramnet_tpu.native", None)


@pytest.mark.parametrize("normalize", [True, False])
def test_raw_dataset_items_match_jax(raw_split, numpy_voxelizer, normalize):
    """Every package: the K windows' events voxelized in one grid at the
    sensor size, normalized or not, cropped and flipped with the frame
    concatenated, and the log depth."""
    items = []
    for lib in (tdata, jdata):
        transform = lib.Compose([lib.RandomRotationFlip(0.0, 0.5, 0.0),
                                 lib.RandomCrop(24)])
        ds = lib.SynchronizedFramesEventsRawDataset(
            base_folder=os.path.join(raw_split, "seq00"),
            event_folder="events/voxels", depth_folder="depth/data",
            frame_folder="rgb/data", clip_distance=80.0,
            every_x_rgb_frame=K, transform=transform, normalize=normalize,
            reg_factor=3.70378)
        items.append([ds.__getitem__(i, seed=21 + i)
                      for i in range(ds.num_packages())])
    assert len(items[0]) == len(items[1]) == 3
    for t_item, j_item in zip(*items):
        assert list(t_item) == list(j_item)
        assert t_item["image"].shape == (24, 24, 6)
        for k in t_item:
            np.testing.assert_array_equal(t_item[k], j_item[k], err_msg=k)


def test_raw_windows_and_loader_match_jax(raw_split, numpy_voxelizer):
    """The recurrency=False windows through concatenate_subfolders (pauses
    included) and the batch loader, as the training entry point builds
    them for the no_recurrent config."""
    out = []
    for lib in (tdata, jdata):
        ds = lib.concatenate_subfolders(
            raw_split, "SequenceSynchronizedFramesEventsDataset",
            "events/voxels", "depth/data", "rgb/data", sequence_length=2,
            transform=lib.CenterCrop(24), proba_pause_when_running=0.3,
            proba_pause_when_paused=0.5, step_size=1, clip_distance=80.0,
            every_x_rgb_frame=K, reg_factor=3.70378, baseline="ergb",
            loss_composition=["image"], recurrency=False)
        out.append([b for b in lib.BatchLoader(ds, 2, shuffle=True,
                                               num_workers=1)])
    assert len(out[0]) == len(out[1]) > 0
    for t_b, j_b in zip(*out):
        assert set(t_b) == set(j_b)
        assert t_b["events"].shape[2] == 0
        for k in t_b:
            np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)


# -- training -----------------------------------------------------------------


def _raw_config(deferred=False):
    with open(SHIPPED) as f:
        raw = copy.deepcopy(json.load(f))
    raw["model"].update(base_num_channels=4, num_encoders=2,
                        num_residual_blocks=1)
    for s in ("train", "validation"):
        raw["data_loader"][s].update(every_x_rgb_frame=K, step_size=1)
    raw["trainer"].update(sequence_length=2, deferred_decode=deferred)
    return raw


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["as_shipped", "deferred_decode"])
def test_first_step_loss_and_every_gradient_match_jax(deferred, monkeypatch):
    """ERGB2Depth has no deferred decode: both settings run its
    forward_sequence, as JAX's loss does.  JAX's loss passes remat_policy
    to a forward_sequence that does not take it (its trainer cannot run
    ERGB2Depth); the reference side here drops that argument."""
    jax_forward = JaxUNetModel.forward_sequence
    monkeypatch.setattr(JaxUNetModel, "forward_sequence", staticmethod(
        lambda *a, remat_policy=None, **kw: jax_forward(*a, **kw)))
    raw = _raw_config(deferred)
    cfg, jcfg = Config.from_dict(raw), jconfig.Config.from_dict(raw)
    model = build_model(cfg, generator=torch.Generator().manual_seed(3))
    params = _jax_tree(model)
    rng = np.random.RandomState(5)
    batch = {"events": np.zeros((B, 2, 0, H, W, 0), np.float32),
             "image": rng.randn(B, 2, H, W, 6).astype(np.float32),
             "depth_events": np.zeros((B, 2, 0, H, W, 1), np.float32),
             "depth_image": rng.rand(B, 2, H, W, 1).astype(np.float32)}
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        jax_loss(jcfg, remat=True), has_aux=True)(
        params, (), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, H, W),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(aux) == set(j_aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]),
                                   rtol=RTOL_F32, err_msg=k)
    want = jax_to_sd(j_grads, "ERGB2Depth")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=ATOL_GRAD, rtol=RTOL_GRAD,
                                   err_msg=name)


def test_training_entry_point_runs(tmp_path, raw_split, monkeypatch):
    """``python -m rpg_ramnet_tpu_torch.train`` for one epoch of the
    shrunk no_recurrent config on raw events: finite losses, a checkpoint
    and an exported .pth.tar that reloads."""
    raw = _raw_config()
    raw["trainer"].update(epochs=1, save_dir=str(tmp_path / "runs"))
    raw["data_loader"].update(batch_size=2, crop_size=24, num_workers=1)
    for s in ("train", "validation"):
        raw["data_loader"][s]["base_folder"] = "split"
    (tmp_path / "data").mkdir()
    os.symlink(raw_split, tmp_path / "data" / "split")
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(tmp_path / "data"))
    trainer = train_main(["-c", str(tmp_path / "cfg.json"), "--device", "cpu"])
    log = trainer.jsonl.entries[0]
    assert np.isfinite(log["train_loss"]) and np.isfinite(log["val_loss"])
    assert isinstance(trainer.model, ERGB2Depth)
    assert os.path.exists(os.path.join(trainer.run_dir, "checkpoint-epoch0",
                                       "state.pt"))
    trainer.export_reference_checkpoint(str(tmp_path / "m.pth.tar"))
    again = ERGB2Depth(trainer.model.cfg,
                       generator=torch.Generator().manual_seed(1))
    load_any(str(tmp_path / "m.pth.tar"), again)
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v)


# -- the entry points -----------------------------------------------------------


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_eval_entry_point_matches_test_py(tmp_path, raw_split, monkeypatch):
    """The no_recurrent config through test.py and the port's eval entry
    point: the same output tree (no semantic labels: the raw dataset has
    none), the saved maps within ATOL_F32; --scan_chunk 2 and --lanes 2
    (with and without --scan_chunk) give the per-package maps."""
    raw = _raw_config()
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    model = build_model(Config.from_dict(raw),
                        generator=torch.Generator().manual_seed(3))
    export_pth_tar(str(tmp_path / "m.pth.tar"), model, raw["arch"], raw)
    (tmp_path / "data").mkdir()
    os.symlink(raw_split, tmp_path / "data" / "test")
    args = ["--path_to_model", str(tmp_path / "m.pth.tar"), "--config",
            str(tmp_path / "cfg.json"), "--data_folder", "test", "--crop",
            "16,24"]
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1", "XLA_FLAGS": XLA_ONE_THREAD,
           "PREPROCESSED_DATASETS_FOLDER": str(tmp_path / "data")}
    # test.py with its host voxelizer on the numpy path, as the port's:
    # the C++ helper JAX prefers rounds the time split in another order,
    # which can move an event to the next bin
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.modules['rpg_ramnet_tpu.native'] = None; "
         "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], "
         "run_name='__main__')", os.path.join(REPO, "test.py"), *args,
         "--output_path", str(tmp_path / "out_jax")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(tmp_path / "data"))
    monkeypatch.setitem(sys.modules, "rpg_ramnet_tpu.native", None)
    runs = {}
    for extra in ((), ("--scan_chunk", "2"), ("--lanes", "2"),
                  ("--lanes", "2", "--scan_chunk", "2")):
        got = {}
        out = ["--output_path", str(tmp_path / "out_port")] if not extra else []
        eval_main([*args, *out, *extra, "--device", "cpu"],
                  on_prediction=got.__setitem__)
        runs[extra] = got
    names = _tree(tmp_path / "out_port")
    assert names == _tree(tmp_path / "out_jax")
    assert not any("semantic" in n for n in names)
    for n in names:
        if n.endswith(".npy"):
            _close(np.load(tmp_path / "out_port" / n),
                   np.load(tmp_path / "out_jax" / n), err_msg=n)
    base = runs[()]
    assert len(base) == 6 and all(set(p) == {"image"} for p in base.values())
    for extra, got in runs.items():
        assert sorted(got) == sorted(base)
        for i in base:
            _close(got[i]["image"], base[i]["image"], atol=1e-6, rtol=1e-5,
                   err_msg=f"{extra} {i}")


def test_live_path_refuses_ergb2depth(tmp_path):
    """ERGB2Depth has no modality branch to stream a window through: the
    JAX live engine fails on it, the port's refuses it with a message."""
    jcfg, params, model = _models()
    engine = jinference.StreamingInference(params, jcfg, "ERGB2Depth")
    with pytest.raises(KeyError):
        engine.step_modality(np.zeros((H, W, 5), np.float32), "image")
    with pytest.raises(ValueError, match="ERGB2Depth"):
        StreamingInference(model).step_modality(np.zeros((H, W, 5),
                                                         np.float32))
    raw = _raw_config()
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    (tmp_path / "events.txt").write_text("8 4\n0.1 1 1 1\n")
    with pytest.raises(ValueError, match="ERGB2Depth"):
        stream.main(["-i", str(tmp_path / "events.txt"), "--path_to_model",
                     str(tmp_path / "m.pth.tar"), "--config",
                     str(tmp_path / "cfg.json"), "--device", "cpu"])
