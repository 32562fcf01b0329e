"""The port's host data path and training entry point.

The synthetic writer and the TBPTT datasets against the JAX package's on
the same files and seeds (exact: the same numpy arithmetic), and
``python -m rpg_ramnet_tpu_torch.train`` for one tiny epoch on the CPU:
checkpoint, resume at the next epoch, the duplicate-run-dir refusal, and a
``.pth.tar`` export that both packages' loaders read.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from rpg_ramnet_tpu import data as jdata
from rpg_ramnet_tpu.compat import load_params_from_checkpoint
from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict

from rpg_ramnet_tpu_torch import data as tdata
from rpg_ramnet_tpu_torch.compat import load_reference_checkpoint
from rpg_ramnet_tpu_torch.core.config import Config
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train import checkpoint
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = dict(n_sequences=2, n_frames=9, height=30, width=28)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_writer_matches_jax(tmp_path):
    tdata.generate_split(str(tmp_path / "t"), seed=3, **SPLIT)
    jdata.synthetic.generate_split(str(tmp_path / "j"), seed=3, **SPLIT)
    names = _files(tmp_path / "t")
    assert names == _files(tmp_path / "j") and len(names) == 2 * (5 + 5 * 9)
    for name in names:
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if name.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), name
        else:
            assert a.read_bytes() == b.read_bytes(), name


def _datasets(root, lib, crop=24):
    transform = lib.Compose([lib.RandomRotationFlip(0.0, 0.5, 0.0),
                             lib.RandomCrop(crop)])
    kw = dict(sequence_length=3, transform=transform,
              proba_pause_when_running=0.3, proba_pause_when_paused=0.5,
              step_size=1, clip_distance=80.0, every_x_rgb_frame=2,
              reg_factor=3.70378)
    return lib.concatenate_subfolders(
        root, "SequenceSynchronizedFramesEventsDataset", "events/voxels",
        "depth/data", "rgb/data", **kw)


def test_datasets_and_loader_match_jax(tmp_path):
    """A split written by the JAX writer: every window of the port's
    datasets equals the JAX package's for the same transform seed (random
    crop, flips and pauses included), and so do the loader's batches."""
    root = str(tmp_path / "split")
    jdata.synthetic.generate_split(root, seed=1, **SPLIT)
    t_ds, j_ds = _datasets(root, tdata), _datasets(root, jdata)
    assert len(t_ds) == len(j_ds) == 2 * 2
    for i in range(len(t_ds)):
        (t_item, t_d), (j_item, j_d) = t_ds.get(i, seed=7 + i), j_ds.get(i, seed=7 + i)
        assert t_d == j_d and list(t_item) == list(j_item)
        for k in t_item:
            assert t_item[k].shape == j_item[k].shape, k
            np.testing.assert_array_equal(t_item[k], j_item[k], err_msg=k)
    t_loader = tdata.BatchLoader(t_ds, 3, num_workers=2)
    j_loader = jdata.BatchLoader(j_ds, 3, num_workers=2)
    for t_b, j_b in zip(t_loader, j_loader):
        for k in t_b:
            np.testing.assert_array_equal(t_b[k], j_b[k], err_msg=k)
    assert len(t_loader) == len(j_loader) == 2


def _config(save_dir, epochs):
    return {
        "name": "tiny", "arch": "ERGB2DepthRecurrent",
        "data_loader": {
            "train": {"base_folder": "train", "every_x_rgb_frame": 2,
                      "step_size": 1, "clip_distance": 80.0,
                      "reg_factor": 3.70378},
            "validation": {"base_folder": "val", "every_x_rgb_frame": 2,
                           "step_size": 1, "clip_distance": 80.0,
                           "reg_factor": 3.70378},
            "batch_size": 2, "num_workers": 2, "crop_size": 24},
        "optimizer_type": "Adam", "optimizer": {"lr": 3e-4},
        "loss": {"type": "scale_invariant_loss",
                 "config": {"weight": 1.0, "n_lambda": 1.0}},
        "grad_loss": {"weight": 0.25},
        "trainer": {"epochs": epochs, "sequence_length": 2,
                    "save_dir": save_dir, "save_freq": 1,
                    "loss_composition": ["image", "events1"],
                    "loss_weights": [1, 1], "deferred_decode": True,
                    "precompute_x": True},
        "model": {"recurrent_block_type": "conv",
                  "state_combination": "convgru", "num_encoders": 2,
                  "base_num_channels": 4, "num_residual_blocks": 1,
                  "norm": "none"}}


def _train(tmp_path, *args):
    # two threads: the suite runs several test processes at once
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
           "PREPROCESSED_DATASETS_FOLDER": str(tmp_path / "data")}
    return subprocess.run(
        [sys.executable, "-m", "rpg_ramnet_tpu_torch.train", "--device", "cpu",
         *args], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)


def test_train_entry_point_checkpoint_resume_export(tmp_path):
    tdata.generate_split(str(tmp_path / "data/train"), n_sequences=2,
                         n_frames=8, height=28, width=26)
    tdata.generate_split(str(tmp_path / "data/val"), n_sequences=1,
                         n_frames=6, height=28, width=26, seed=5)
    runs = str(tmp_path / "runs")
    for epochs in (1, 2):
        (tmp_path / f"cfg{epochs}.json").write_text(
            json.dumps(_config(runs, epochs)))
    proc = _train(tmp_path, "-c", "cfg1.json")
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "runs/tiny"
    assert (run / "checkpoint-epoch0/state.pt").exists()
    assert (run / "model_best/meta.json").exists()
    # the run directory exists now: a fresh run is refused
    refused = _train(tmp_path, "-c", "cfg1.json")
    assert refused.returncode != 0 and "already exists" in refused.stderr
    # resume continues at the next epoch, with the longer schedule
    proc = _train(tmp_path, "-c", "cfg2.json", "-r",
                  str(run / "checkpoint-epoch0"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().split("\n") if x]
    assert [e["epoch"] for e in log] == [0, 1]
    assert all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
               for e in log)
    # export to the reference format: both packages' loaders read it
    cfg = Config.from_dict(_config(runs, 2))
    model = ERGB2DepthRecurrent(cfg.model)
    meta = checkpoint.restore(str(run / "checkpoint-epoch1"), model)
    assert meta["epoch"] == 1
    path = str(tmp_path / "model.pth.tar")
    checkpoint.export_pth_tar(path, model, cfg.arch, cfg.raw, epoch=1)
    other = load_reference_checkpoint(
        ERGB2DepthRecurrent(cfg.model, generator=torch.Generator().manual_seed(9)),
        path)
    params, _ = load_params_from_checkpoint(path)
    want = params_to_state_dict(params)
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               other.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(want[k]))
