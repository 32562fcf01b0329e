"""The port's product surface against the JAX package's, on the CPU:
``scale_factor < 1`` (numpy down-scaling against JAX's cv2.resize within
1e-5, the semantic labels equal), ``FrameDataset`` bit for bit, Orbax
checkpoints written by JAX's ``CheckpointManager`` read by ``load_any``
(the forward within 1e-5, no JAX loaded by the read; the error without
tensorstore), and the window display: its LUT math bit for bit,
``DepthDisplay``'s routing and ``stream --display`` through a mocked cv2
window layer (tests/test_eval_extras.py:82-135's).
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.data import augmentation as jaug
from rpg_ramnet_tpu.data import datasets as jds
from rpg_ramnet_tpu.eval import display as jdisplay
from rpg_ramnet_tpu.models import ERGB2Depth as JaxUNet
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.train.checkpoint import CheckpointManager

from rpg_ramnet_tpu_torch import stream
from rpg_ramnet_tpu_torch.core.config import Config, ModelConfig
from rpg_ramnet_tpu_torch.data import augmentation as taug
from rpg_ramnet_tpu_torch.data import datasets as tds
from rpg_ramnet_tpu_torch.data import generate_split
from rpg_ramnet_tpu_torch.eval import display
from rpg_ramnet_tpu_torch.models import ERGB2Depth, ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar, load_any

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 2
MODEL = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
             recurrent_block_type="conv", state_combination="convgru",
             num_encoders=2, base_num_channels=4, num_residual_blocks=1,
             use_upsample_conv=True, norm="none", every_x_rgb_frame=K,
             baseline=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (tests/test_torch_lanes.py::_one_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[(24, 32), (25, 33)], ids=["even", "odd"])
def seq(request, tmp_path_factory):
    h, w = request.param
    root = tmp_path_factory.mktemp(f"surface{h}") / "split"
    generate_split(str(root), n_sequences=1, n_frames=12, height=h, width=w,
                   events_per_frame=300)
    return str(root / "seq00")


@pytest.mark.parametrize("scale", [0.5, 0.75])
def test_scale_factor_matches_jax_cv2(seq, scale):
    """Every key of a window with semantic labels and timestamps: linear
    maps within 1e-5 of cv2's, the labels (nearest) and the timestamps
    equal, the size (int(h * s), int(w * s))."""
    kw = dict(depth_folder="depth/data", frame_folder="rgb/data",
              sequence_length=2, step_size=1, clip_distance=80.0,
              every_x_rgb_frame=K, reg_factor=3.70378, load_semantic=True,
              use_phased_arch=True, scale_factor=scale)
    port = tds.SequenceSynchronizedFramesEventsDataset(seq, "events/voxels", **kw)
    ref = jds.SequenceSynchronizedFramesEventsDataset(seq, "events/voxels", **kw)
    h, w = np.load(os.path.join(seq, "depth/data/seq_0000_depth.npy")).shape
    for i in (0, len(ref) - 1):
        got, want = port.__getitem__(i, seed=i), ref.__getitem__(i, seed=i)
        assert list(got) == list(want)
        assert got["image"].shape[1:3] == (int(h * scale), int(w * scale))
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            if "semantic" in k or k.startswith("times"):
                assert np.array_equal(got[k], want[k]), k
            else:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                           err_msg=k)


@pytest.mark.parametrize("crop", [None, 16])
def test_frame_dataset_bitwise(seq, crop):
    port = tds.FrameDataset(seq, "rgb/data",
                            transform=crop and taug.CenterCrop(crop))
    ref = jds.FrameDataset(seq, "rgb/data",
                           transform=crop and jaug.CenterCrop(crop))
    assert len(port) == len(ref) == 12
    for i in (0, 5, 11):
        got, want = port.__getitem__(i, seed=i), ref.__getitem__(i, seed=i)
        assert got.dtype == want.dtype == np.float32 and got.shape[-1] == 1
        assert np.array_equal(got, want)


def _jax_models(arch):
    mcfg = JaxModelConfig.from_dict(MODEL)
    if arch == "ERGB2Depth":
        mcfg = JaxModelConfig.from_dict({**MODEL, "num_bins_rgb": 6})
        return mcfg, JaxUNet.init_params(jax.random.PRNGKey(2), mcfg)
    return mcfg, JaxModel.init_params(jax.random.PRNGKey(2), mcfg)


def _forward_both(arch, mcfg, params, model):
    rng = np.random.RandomState(0)
    H, W = 16, 24
    if arch == "ERGB2Depth":
        pkg = {"image": rng.randn(2, H, W, 6).astype(np.float32)}
        _, jp = JaxUNet.forward_package(params, mcfg, None,
                                        {k: jnp.asarray(v) for k, v in pkg.items()})
        state = ()
    else:
        pkg = {"events": rng.randn(2, K, H, W, 5).astype(np.float32),
               "image": rng.rand(2, H, W, 1).astype(np.float32)}
        _, jp = JaxModel.forward_package(params, mcfg,
                                         JaxModel.init_state(mcfg, 2, H, W),
                                         {k: jnp.asarray(v) for k, v in pkg.items()})
        state = model.init_state(2, H, W)
    with torch.no_grad():
        _, tp = model.forward_package(state, {k: torch.from_numpy(v)
                                              for k, v in pkg.items()})
    return tp, jp


@pytest.fixture(scope="module")
def orbax_dirs(tmp_path_factory):
    """One JAX Orbax checkpoint per arch (params + Adam state, meta.json)."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for arch in ("ERGB2DepthRecurrent", "ERGB2Depth"):
        mcfg, params = _jax_models(arch)
        mgr = CheckpointManager(str(root / arch))
        path = mgr.save("checkpoint-epoch3", params, optax.adam(1e-3).init(params),
                        epoch=3, monitor_best=0.25,
                        config={"arch": arch},
                        logger={"train_loss": 1.5})
        mgr.close()
        out[arch] = (path, mcfg, params)
    return out


@pytest.mark.parametrize("arch", ["ERGB2DepthRecurrent", "ERGB2Depth"])
def test_orbax_checkpoint_forward_matches_jax(orbax_dirs, arch):
    path, mcfg, params = orbax_dirs[arch]
    d = {**MODEL, "num_bins_rgb": 6} if arch == "ERGB2Depth" else MODEL
    model = (ERGB2Depth if arch == "ERGB2Depth" else ERGB2DepthRecurrent)(
        ModelConfig.from_dict(d), generator=torch.Generator().manual_seed(9))
    meta = load_any(path, model)
    assert (meta["epoch"], meta["monitor_best"], meta["logger"]) == \
        (3, 0.25, {"train_loss": 1.5})
    tp, jp = _forward_both(arch, mcfg, params, model)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-5,
                                   err_msg=k)


def test_orbax_read_loads_no_jax(orbax_dirs):
    path = orbax_dirs["ERGB2DepthRecurrent"][0]
    code = (
        "import sys\n"
        "from rpg_ramnet_tpu_torch.core.config import ModelConfig\n"
        "from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent\n"
        "from rpg_ramnet_tpu_torch.train.checkpoint import load_any\n"
        f"m = ERGB2DepthRecurrent(ModelConfig.from_dict({MODEL!r}))\n"
        f"assert load_any({path!r}, m)['epoch'] == 3\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'rpg_ramnet_tpu', 'orbax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_orbax_without_tensorstore_names_the_way_round(orbax_dirs, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(MODEL))
    with pytest.raises(ImportError, match="tensorstore.*pth.tar"):
        load_any(orbax_dirs["ERGB2DepthRecurrent"][0], model)


# -- the window display ---------------------------------------------------------


@pytest.mark.parametrize("gamma", [1e-9, 0.5, 1.0, 1.7, 2.2, 3.0])
def test_gamma_lut_bitwise(gamma):
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(display.gamma_lut(gamma), jdisplay.gamma_lut(gamma))
    assert np.array_equal(display.apply_gamma(img, gamma),
                          jdisplay.apply_gamma(img, gamma))


@pytest.mark.parametrize("contrast,brightness", [(1.0, 0.0), (2.0, 10.0),
                                                 (0.5, -50.0), (1.3, 7.0)])
def test_contrast_brightness_bitwise(contrast, brightness):
    img = np.random.RandomState(0).randint(0, 256, (8, 8)).astype(np.uint8)
    assert np.array_equal(
        display.apply_contrast_brightness(img, contrast, brightness),
        jdisplay.apply_contrast_brightness(img, contrast, brightness))


@pytest.mark.parametrize("mode", ["linear", "inverse", "log_inverse"])
def test_depth_to_display_bitwise(mode):
    depth = np.random.RandomState(1).rand(12, 10).astype(np.float32)
    for reg in (3.70378, 5.7):
        assert np.array_equal(display.depth_to_display(depth, mode, reg),
                              jdisplay.depth_to_display(depth, mode, reg))


def _fake_cv2(monkeypatch, shown):
    bars = {}
    fake = types.SimpleNamespace(error=RuntimeError)
    fake.namedWindow = lambda name: None
    fake.createTrackbar = (
        lambda name, win, val, mx, cb: bars.__setitem__((name, win), val))
    fake.getTrackbarPos = lambda name, win: bars[(name, win)]
    fake.imshow = lambda win, img: shown.append((win, img))
    fake.waitKey = lambda t: None
    monkeypatch.setitem(sys.modules, "cv2", fake)
    return bars


def test_display_routing_with_mocked_gui(monkeypatch):
    shown = []
    bars = _fake_cv2(monkeypatch, shown)
    img = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    disp = display.ImageDisplay("win")
    disp.show(img)
    u8 = np.clip(img * 255, 0, 255).astype(np.uint8)
    assert shown[-1][0] == "win" and np.array_equal(shown[-1][1], u8)
    bars[("contrast x10", "win")] = 20
    bars[("brightness", "win")] = 10
    bars[("gamma x10", "win")] = 20
    disp.show(img)
    want = jdisplay.apply_gamma(jdisplay.apply_contrast_brightness(u8, 2.0, 10.0), 2.0)
    assert np.array_equal(shown[-1][1], want)
    ddisp = display.DepthDisplay("dwin", mode="log_inverse")
    ddisp.show(img)
    assert shown[-1][0] == "dwin"
    assert np.array_equal(shown[-1][1],
                          jdisplay.depth_to_display(img, "log_inverse", 3.70378))


def test_display_headless_error(monkeypatch):
    fake = types.SimpleNamespace(error=RuntimeError)

    def no_gui(name):
        raise fake.error("The function is not implemented")

    fake.namedWindow = no_gui
    monkeypatch.setitem(sys.modules, "cv2", fake)
    with pytest.raises(RuntimeError, match="headless"):
        display.DepthDisplay("depth")


def test_stream_display_shows_every_window(tmp_path, monkeypatch):
    """``stream --display`` through the mocked window layer: one inverse
    depth image per window, the depth the window handed out, waited on
    with --display_wait_time."""
    shown, waits = [], []
    _fake_cv2(monkeypatch, shown)
    sys.modules["cv2"].waitKey = waits.append
    cfg = {"name": "tiny", "arch": "ERGB2DepthRecurrent", "model": MODEL,
           "data_loader": {"train": {"every_x_rgb_frame": K}}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    model = ERGB2DepthRecurrent(Config.from_dict(cfg).model,
                                generator=torch.Generator().manual_seed(3))
    export_pth_tar(str(tmp_path / "m.pth.tar"), model, "ERGB2DepthRecurrent", cfg)
    h, w, n = 14, 22, 3 * int(14 * 22 * 0.35)
    rng = np.random.RandomState(0)
    t = np.sort(rng.uniform(100.0, 100.5, n))
    with open(tmp_path / "events.txt", "w") as f:
        f.write(f"{w} {h}\n")
        for ti, x, y, p in zip(t, rng.randint(0, w, n), rng.randint(0, h, n),
                               rng.randint(0, 2, n)):
            f.write(f"{ti:.9f} {x} {y} {p}\n")
    depths = {}
    windows = stream.main(
        ["-i", str(tmp_path / "events.txt"), "--path_to_model",
         str(tmp_path / "m.pth.tar"), "--config", str(tmp_path / "config.json"),
         "--height", str(h), "--width", str(w), "--device", "cpu", "--display",
         "--display_wait_time", "7", "--reg_factor", "5.7"],
        on_window=depths.__setitem__)
    assert windows == len(shown) == len(depths) == 3 and waits == [7] * 3
    for (win, img), i in zip(shown, sorted(depths)):
        assert win == "depth"
        assert np.array_equal(img, jdisplay.depth_to_display(depths[i], "inverse", 5.7))
