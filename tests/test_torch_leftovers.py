"""The port's leftovers against the JAX package's, on the CPU: the frame
trainer (``contrast_loss``, ``make_preview``, three epochs of
``FrameReconstructionTrainer`` with Adam against JAX's with optax, the
template of tests/test_train.py:683-711), the timers, and the registries
(every name JAX's hold resolves in the port's to the callable of the same
name, and the four lookups route through them).
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import rpg_ramnet_tpu.data  # noqa: F401  (fills the JAX registries)
import rpg_ramnet_tpu.eval.metrics  # noqa: F401
import rpg_ramnet_tpu.models  # noqa: F401
import rpg_ramnet_tpu.train.losses  # noqa: F401
from rpg_ramnet_tpu.core import registry as jregistry
from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.data.loader import \
    concatenate_subfolders as jax_concatenate_subfolders
from rpg_ramnet_tpu.models import ERGB2Depth as JaxUNet
from rpg_ramnet_tpu.train import frame_trainer as jft

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core import registry
from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.data.loader import concatenate_subfolders
from rpg_ramnet_tpu_torch.eval.metrics import get_metric
from rpg_ramnet_tpu_torch.models import ERGB2Depth, get_model
from rpg_ramnet_tpu_torch.train import frame_trainer as ft
from rpg_ramnet_tpu_torch.train.losses import get_loss
from rpg_ramnet_tpu_torch.utils import timers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 16, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (tests/test_torch_lanes.py::_one_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the frame trainer ------------------------------------------------------------


@pytest.mark.parametrize("shape,weight", [((2, 16, 16, 1), 0.5), ((1, 3, 5, 1), 2.0),
                                          ((1, 1, 1, 1), 1.0)])
def test_contrast_loss_matches_jax(shape, weight):
    rng = np.random.RandomState(0)
    pred, target = rng.randn(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)
    got = ft.contrast_loss(torch.from_numpy(pred), torch.from_numpy(target), weight)
    want = jft.contrast_loss(jnp.asarray(pred), jnp.asarray(target), weight)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("flat", [False, True], ids=["scene", "flat_panel"])
def test_make_preview_matches_jax(flat):
    rng = np.random.RandomState(1)
    ev = rng.randn(H, W, 5).astype(np.float32)
    pred = np.full((H, W, 1), 0.3, np.float32) if flat else rng.rand(H, W, 1).astype(np.float32)
    target = rng.rand(H, W, 1).astype(np.float32)
    got, want = ft.make_preview(ev, target, pred), jft.make_preview(ev, target, pred)
    assert got.shape == (H, 3 * W) and np.array_equal(got, want)


MCFG = {"num_bins_rgb": 5, "num_bins_events": 5, "skip_type": "sum",
        "recurrent_block_type": "conv", "state_combination": "convgru",
        "num_encoders": 2, "base_num_channels": 4, "num_residual_blocks": 1,
        "use_upsample_conv": True, "norm": "none", "baseline": False}


def test_frame_trainer_three_epochs_match_jax():
    """ERGB2Depth (2 encoders, base 4) on three batches of voxel grids and
    frames, MSE + contrast loss (weight 0.5), Adam at 1e-3 in both: every
    epoch's loss and metric within 1e-4, the previews within 1e-4, the
    validation epoch likewise."""
    jcfg = JaxModelConfig.from_dict(MCFG)
    params = JaxUNet.init_params(jax.random.PRNGKey(0), jcfg)
    model = ERGB2Depth(ModelConfig.from_dict(MCFG))
    params_from_jax(model, params, "ERGB2Depth")

    def japply(p, events):
        return JaxUNet.forward_package(p, jcfg, None, {"image": events})[1]["image"]

    def apply(m, events):
        return m.forward_package((), {"image": events})[1]["image"]

    rng = np.random.RandomState(0)
    batches = [{"events": rng.randn(B, H, W, 5).astype(np.float32),
                "frame": rng.rand(B, H, W, 1).astype(np.float32)}
               for _ in range(3)]
    item = [{k: v[0] for k, v in batches[0].items()}]
    metrics = [("mse", lambda p, t: float(np.mean((p - t) ** 2)))]
    jtr = jft.FrameReconstructionTrainer(
        params, japply, lambda p, t: jnp.mean((p - t) ** 2), optax.adam(1e-3),
        weight_contrast_loss=0.5, metrics=metrics)
    tr = ft.FrameReconstructionTrainer(
        model, apply, lambda p, t: ((p - t) ** 2).mean(),
        torch.optim.Adam(model.parameters(), lr=1e-3), weight_contrast_loss=0.5,
        metrics=metrics)
    logs = []
    for epoch in range(3):
        got = tr.train_epoch(batches, preview_items=item)
        want = jtr.train_epoch(batches, preview_items=item)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-4)
        np.testing.assert_allclose(got["previews"][0], want["previews"][0], atol=1e-4)
        logs.append(got["loss"])
    assert logs[-1] < logs[0]
    got, want = tr.valid_epoch(batches[:2], item), jtr.valid_epoch(batches[:2], item)
    assert set(got) == set(want) == {"val_loss", "val_metrics", "val_previews"}
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["val_metrics"], want["val_metrics"], rtol=1e-4)


# -- the timers -------------------------------------------------------------------


def test_timer_and_device_timer_on_the_cpu(monkeypatch):
    monkeypatch.setattr(timers, "timers", type(timers.timers)(list))
    with timers.Timer("host") as t:
        sum(range(1000))
    with timers.DeviceTimer("dev", device="cpu") as d:
        out = d.sync(torch.ones(4) * 2)
    assert torch.equal(out, torch.full((4,), 2.0))
    assert timers.timers["host"] == [t.interval] and t.interval >= 0
    assert timers.timers["dev"] == [d.interval] and d.interval >= 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        timers.print_timing_info()
    lines = buf.getvalue().splitlines()
    assert lines[0] == "== Timing statistics ==" and len(lines) == 3
    assert lines[1].startswith("host: ") and lines[1].endswith("(1 samples)")


def test_device_timer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timers.DeviceTimer("x")


def test_timing_info_printed_at_exit():
    """As the JAX timers: the means per name printed when the process
    ends."""
    code = ("from rpg_ramnet_tpu_torch.utils.timers import Timer\n"
            "for _ in range(2):\n"
            "    with Timer('load'):\n"
            "        pass\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "== Timing statistics ==" and len(lines) == 2
    assert lines[1].startswith("load: ") and lines[1].endswith("(2 samples)")


def test_profile_trace_writes_a_trace(tmp_path):
    with timers.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / "trace.json"
    assert path.exists() and path.stat().st_size > 0


# -- the registries ---------------------------------------------------------------


def _jax_names():
    return [(kind, name) for kind in ("MODELS", "DATASETS", "LOSSES", "METRICS")
            for name in getattr(jregistry, kind).names()]


@pytest.mark.parametrize("kind,name", _jax_names(),
                         ids=[f"{k}:{n}" for k, n in _jax_names()])
def test_every_jax_name_resolves_in_the_port(kind, name):
    got = getattr(registry, kind).get(name)
    assert name in getattr(registry, kind)
    assert got.__name__ == getattr(jregistry, kind).get(name).__name__
    lookup = {"MODELS": get_model, "LOSSES": get_loss, "METRICS": get_metric}
    if kind in lookup:
        assert lookup[kind](name) is got


def test_registries_hold_the_same_names():
    for kind in ("MODELS", "DATASETS", "LOSSES", "METRICS"):
        assert getattr(registry, kind).names() == getattr(jregistry, kind).names()
        assert list(getattr(registry, kind)) == getattr(registry, kind).names()


def test_registry_semantics(tmp_path):
    reg = registry.Registry("widget")

    @reg.register()
    def alpha():
        return 1

    reg.register("beta")(len)
    assert reg.names() == ["alpha", "beta"] and "alpha" in reg and "gamma" not in reg
    assert reg.get("alpha") is alpha and reg.get("beta") is len
    with pytest.raises(KeyError, match="widget 'alpha' already registered"):
        reg.register("alpha")(len)
    with pytest.raises(KeyError, match=r"Unknown widget 'gamma'. Available: \['alpha', 'beta'\]"):
        reg.get("gamma")
    # the lookups keep their messages, an unknown dataset type JAX's
    with pytest.raises(KeyError, match="Unknown model 'Nope'"):
        get_model("Nope")
    with pytest.raises(KeyError, match="Unknown loss 'nope'"):
        get_loss("nope")
    for concat in (concatenate_subfolders, jax_concatenate_subfolders):
        with pytest.raises(KeyError, match="Unknown dataset 'NoSuchDataset'"):
            concat(str(tmp_path), "NoSuchDataset", "e", "d", "f", 2)
