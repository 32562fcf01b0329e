"""The port's trainer against the JAX package's, on the same files.

A tiny config (2 encoders, base 4, K=2, B=2, L=2, 24x24 crops, float32)
with the shipped configs' preview settings (still previews, movies,
num_previews 2, a metrics list) plus state previews trains for 2 epochs
of 5 steps in both packages from the same weights (the port's seeded init,
crossed into JAX).  Held against JAX: the 10-step trajectory (per-epoch
losses, final parameters at the Adam bound of tests/test_torch_train.py),
every TensorBoard tag, read back with EventAccumulator (GIF movies,
state-change images), the preview metric vector in both metric modes at
the same weights, and what the checkpoints carry as monitor_best.  The
port alone: a resumed run equals the straight one bitwise, async
checkpoints equal sync ones, ``device_prefetch`` keeps the loader's
batches, and the histograms' gradients under grad_accum are the train
step's, taken in its micro-batches.
"""
import glob
import io
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

import jax

from rpg_ramnet_tpu import data as jdata
from rpg_ramnet_tpu.compat.torch_import import (params_to_state_dict,
                                                state_dict_to_params)
from rpg_ramnet_tpu.core.config import Config as JConfig
from rpg_ramnet_tpu.train.trainer import Trainer as JTrainer

from rpg_ramnet_tpu_torch import data as tdata
from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import Config
from rpg_ramnet_tpu_torch.data.loader import device_prefetch
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train.train_step import make_grad_fn
from rpg_ramnet_tpu_torch.train.trainer import Trainer
from rpg_ramnet_tpu_torch.utils.training_utils import strip_arch_prefix

LR = 3e-4
STEPS = 10        # 2 epochs of 5 batches


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (tests/test_torch_lanes.py::_one_thread), for
    the module: runs compared bitwise must share it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw(save_dir, name="tiny_tb", **trainer):
    split = {"base_folder": "train", "every_x_rgb_frame": 2, "step_size": 1,
             "clip_distance": 80.0, "reg_factor": 3.70378}
    return {
        "name": name, "arch": "ERGB2DepthRecurrent", "use_phased_arch": False,
        "data_loader": {"train": split,
                        "validation": {**split, "base_folder": "val"},
                        "batch_size": 2, "num_workers": 2, "shuffle": True},
        "optimizer_type": "Adam", "optimizer": {"lr": LR, "weight_decay": 0},
        "loss": {"type": "scale_invariant_loss",
                 "config": {"weight": 1.0, "n_lambda": 1.0}},
        "grad_loss": {"weight": 0.25},
        "metrics": ["mse", "abs_rel_diff", "scale_invariant_error",
                    "median_error"],
        "trainer": {"epochs": 2, "sequence_length": 2, "save_dir": save_dir,
                    "save_freq": 4, "verbosity": 0, "monitor": "val_loss",
                    "monitor_mode": "min", "num_previews": 2,
                    "num_val_previews": 2, "still_previews": True,
                    "movie": True, "state_preview": True,
                    "loss_composition": ["image", "events1"],
                    "loss_weights": [1, 1], "deferred_decode": True,
                    "precompute_x": True, **trainer},
        "model": {"num_bins_rgb": 1, "num_bins_events": 5, "skip_type": "sum",
                  "recurrent_block_type": "conv",
                  "state_combination": "convgru", "num_encoders": 2,
                  "base_num_channels": 4, "num_residual_blocks": 1,
                  "use_upsample_conv": True, "norm": "none"}}


def _loaders(lib, root, **kw):
    def build(split, seq_len=2):
        ds = lib.concatenate_subfolders(
            os.path.join(root, split), "SequenceSynchronizedFramesEventsDataset",
            "events/voxels", "depth/data", "rgb/data", sequence_length=seq_len,
            step_size=1, clip_distance=80.0, every_x_rgb_frame=2,
            reg_factor=3.70378, transform=lib.CenterCrop(24))
        return ds
    return (lib.BatchLoader(build("train"), 2, shuffle=True, num_workers=2,
                            **kw),
            lib.BatchLoader(build("val"), 2, shuffle=False, num_workers=2,
                            **kw))


def _write_data(root):
    tdata.generate_split(os.path.join(root, "train"), n_sequences=2,
                         n_frames=12, height=28, width=26)
    tdata.generate_split(os.path.join(root, "val"), n_sequences=1,
                         n_frames=8, height=28, width=26, seed=5)


def _port_trainer(root, raw, params, **kw):
    model = ERGB2DepthRecurrent(Config.from_dict(raw).model)
    params_from_jax(model, params)
    return Trainer(Config.from_dict(raw), *_loaders(tdata, root),
                   model=model, **kw)


def _tags(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(os.path.join(run_dir, "tensorboard"),
                           size_guidance={"images": 0, "histograms": 0,
                                          "scalars": 0})
    acc.Reload()
    return acc


def _metas(run_dir):
    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "*", "meta.json"))):
        with open(path) as f:
            meta = json.load(f)
        out[os.path.basename(os.path.dirname(path))] = (
            meta["epoch"], meta["monitor_best"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers, 2 epochs each on the same split and weights."""
    # both writers on tensorboard's own event-file stub, as the port's
    # trainer picks it: TensorFlow (and the JAX it imports) takes seconds
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    tmp = tmp_path_factory.mktemp("trainers")
    root = str(tmp / "data")
    _write_data(root)
    raw = _raw(str(tmp / "runs_jax"))
    jcfg = JConfig.from_dict(raw)
    # the port's seeded init crossed into JAX as numpy (no JAX init
    # compiles; the JAX train step donates its parameter buffers)
    params = state_dict_to_params(
        ERGB2DepthRecurrent(Config.from_dict(raw).model).state_dict())
    jt = JTrainer(jcfg, *_loaders(jdata, root), initial_params=params,
                  use_mesh=False)
    t0 = time.perf_counter()
    jt.train()
    t1 = time.perf_counter()
    raw_t = _raw(str(tmp / "runs_port"))
    pt = _port_trainer(root, raw_t, params)
    pt.train()
    print(f"jax {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s")
    return {"root": root, "params": params, "jax": jt, "port": pt,
            "raw": raw_t, "tmp": tmp}


def test_ten_step_trajectory_matches_jax(runs):
    jt, pt = runs["jax"], runs["port"]
    assert len(pt.train_loader) * 2 == STEPS
    assert pt.preview_errors == []
    for e in range(2):
        j, t = jt.jsonl.entries[e], pt.jsonl.entries[e]
        assert set(t) == set(j)
        for k in j:
            if k.endswith("sec_per_epoch") or k in ("epoch", "lr"):
                continue
            np.testing.assert_allclose(t[k], j[k], rtol=2e-3, err_msg=k)
    # Adam moves an element whose gradient is float noise in both by up
    # to lr a step, either way: 2 x lr x STEPS; nearly all agree to 1e-5
    want = params_to_state_dict(jax.device_get(jt.params))
    diffs = []
    for name, p in pt.model.named_parameters():
        d = np.abs(p.detach().numpy() - np.asarray(want[name]))
        assert d.max() <= 2 * LR * STEPS, name
        diffs.append(d.ravel())
    assert np.mean(np.concatenate(diffs) > 1e-5) < 2e-2


def test_tensorboard_tags_match_jax(runs):
    """Scalars, images (grids, GIF movies, the gradient-flow figure,
    state-change images) and histograms: the tags of JAX's run, and
    payloads that decode."""
    jacc, tacc = _tags(runs["jax"].run_dir), _tags(runs["port"].run_dir)
    for kind in ("scalars", "images", "histograms"):
        assert sorted(tacc.Tags()[kind]) == sorted(jacc.Tags()[kind]), kind
    images = tacc.Tags()["images"]
    keys = ("events0", "events1", "image")
    assert {f"movie_{i}__{k}__prediction__groundtruth"
            for i in range(2) for k in keys} <= set(images)
    assert {f"{p}{i}_{k}__input_pred_gt" for p in ("preview_", "val_preview_")
            for i in range(2) for k in keys} <= set(images)
    assert {f"state_change_{k}" for k in keys} | {"grad_figure"} <= set(images)
    assert {f"{p}metric_{m}" for p in ("preview_", "val_preview_")
            for m in runs["raw"]["metrics"]} <= set(tacc.Tags()["scalars"])
    n_params = len(list(runs["port"].model.parameters()))
    assert len(tacc.Tags()["histograms"]) == 2 * n_params
    from PIL import Image
    movie = tacc.Images("movie_0__image__prediction__groundtruth")
    # JAX tags the training and validation previews' movies alike
    assert [m.step for m in movie] == [0, 0, 1, 1]
    gif = Image.open(io.BytesIO(movie[-1].encoded_image_string))
    assert movie[-1].encoded_image_string[:6] == b"GIF89a"
    assert (gif.n_frames, gif.size) == (2, (3 * 24, 24))
    # state changes at window steps {1, L/2, L-1} = {1}: one block of
    # 3 slices (12 px at 12x12, 2x-zoomed 6x6) per scale
    state = tacc.Images("state_change_events0")[-1]
    img = np.asarray(Image.open(io.BytesIO(state.encoded_image_string)))
    assert img.shape[:2] == (2 * 12, 3 * 12), img.shape
    jstate = jacc.Images("state_change_events0")[-1]
    assert (state.width, state.height) == (jstate.width, jstate.height)


class _Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def add_image(self, *a, **k):
        pass


@pytest.mark.parametrize("all_steps", [False, True],
                         ids=["reference", "all_steps"])
def test_preview_metric_vector_matches_jax(runs, tmp_path, all_steps):
    """_write_previews of both trainers at the same (initial) weights, in
    both metric modes (tests/test_preview_metrics.py's semantics)."""
    raw = _raw(str(tmp_path / "runs"), movie=False,
               preview_metrics_all_steps=all_steps)
    jcfg = JConfig.from_dict(raw)
    jt = JTrainer(jcfg, *_loaders(jdata, runs["root"]),
                  initial_params=runs["params"], use_mesh=False)
    pt = _port_trainer(runs["root"], raw, runs["params"])
    got = {}
    for name, t in (("jax", jt), ("port", pt)):
        t.tb = _Recorder()
        t._write_previews(0, "val_preview_", t.valid_loader, 2)
        got[name] = t.tb.scalars
    assert set(got["port"]) == {f"val_preview_metric_{m}"
                                for m in raw["metrics"]} == set(got["jax"])
    for k, v in got["jax"].items():
        np.testing.assert_allclose(got["port"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_checkpoint_monitor_best_follows_jax(runs):
    """At an improving epoch JAX saves the checkpoint before it updates
    monitor_best (trainer.py:382-386), so checkpoint-epoch0 carries inf;
    the port follows."""
    jmeta = _metas(runs["jax"].run_dir)
    tmeta = _metas(runs["port"].run_dir)
    assert tmeta.keys() == jmeta.keys()
    for name, (epoch, best) in jmeta.items():
        assert tmeta[name][0] == epoch, name
        np.testing.assert_allclose(tmeta[name][1], best, rtol=1e-5)
    assert tmeta["checkpoint-epoch0"] == (0, float("inf"))
    val0 = runs["port"].jsonl.entries[0]["val_loss"]
    if "checkpoint-epoch1" in tmeta:
        np.testing.assert_allclose(tmeta["checkpoint-epoch1"][1], val0,
                                   rtol=1e-6)


def _state(path):
    return torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_resume_equals_straight_run_and_async_equals_sync(runs):
    """The straight port run (sync checkpoints) against an async run and
    a run resumed from its checkpoint-epoch0: parameters, optimizer state
    and checkpoints bitwise equal."""
    tmp = runs["tmp"]
    straight = runs["port"]
    raw = _raw(str(tmp / "runs_async"), still_previews=False, movie=False,
               state_preview=False, async_checkpoint=True, save_freq=1)
    raw_sync = _raw(str(tmp / "runs_sync"), still_previews=False, movie=False,
                    state_preview=False, save_freq=1)
    sync = _port_trainer(runs["root"], raw_sync, runs["params"])
    sync.train()
    asy = _port_trainer(runs["root"], raw, runs["params"])
    assert asy.ckpt.use_async
    asy.train()
    for name in ("checkpoint-epoch0", "checkpoint-epoch1", "model_best"):
        a, s = (os.path.join(t.run_dir, name) for t in (asy, sync))
        assert _equal(_state(a), _state(s)), name
        with open(os.path.join(a, "meta.json")) as fa, \
                open(os.path.join(s, "meta.json")) as fs:
            ma, ms = json.load(fa), json.load(fs)
        ma["config"] = ms["config"] = None
        for m in (ma, ms):
            for entry in m["logger"].values():
                entry.pop("train_sec_per_epoch")
                entry.pop("val_sec_per_epoch")
        assert ma == ms, name
    resumed = _port_trainer(runs["root"], raw_sync, runs["params"],
                            resume=os.path.join(sync.run_dir,
                                                "checkpoint-epoch0"),
                            run_dir=str(tmp / "runs_resumed"))
    assert resumed.start_epoch == 1
    resumed.train()
    for t in (resumed, straight):
        for a, b in zip(sync.model.state_dict().values(),
                        t.model.state_dict().values()):
            assert torch.equal(a, b)
    assert _equal(resumed.optimizer.state_dict(), sync.optimizer.state_dict())
    assert resumed.jsonl.entries[0]["train_loss"] == \
        sync.jsonl.entries[1]["train_loss"]


def test_device_prefetch_keeps_the_loaders_batches(runs):
    train, _ = _loaders(tdata, runs["root"])
    train.set_epoch(3)
    want = list(train)
    train.set_epoch(3)
    got = list(device_prefetch(train, torch.device("cpu"), size=2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            assert np.array_equal(g[k].numpy(), w[k]), k


class _Histograms:
    def __init__(self):
        self.hists = {}

    def add_histogram(self, tag, values, step):
        self.hists[tag] = np.asarray(values)

    def add_figure(self, *a, **k):
        pass


def test_histograms_under_grad_accum_split_as_the_step(runs, tmp_path):
    """Under grad_accum 2 the histograms' backward runs the step's two
    micro-batches (each from its own zero state), and its gradients are
    those the train step takes; no .grad is left behind."""
    raw = _raw(str(tmp_path / "runs"), grad_accum=2)
    pt = _port_trainer(runs["root"], raw, runs["params"],
                       writer=_Histograms())
    batch = next(device_prefetch(pt.train_loader, torch.device("cpu")))
    make_grad_fn(pt.cfg, pt.model)(batch)
    want = {n: p.grad.clone() for n, p in pt.model.named_parameters()}
    pt.model.zero_grad(set_to_none=True)
    sizes = []
    init_state = pt.model.init_state

    def counted(b, h, w):
        sizes.append(b)
        return init_state(b, h, w)

    pt.model.init_state = counted
    pt._last_batch = batch
    pt._write_histograms(0)
    assert sizes == [1, 1]
    assert all(p.grad is None for p in pt.model.parameters())
    for n, g in want.items():
        got = pt.tb.hists[strip_arch_prefix(n) + "/grad"]
        assert np.array_equal(got, g.numpy()), n
