"""The port's inference entry points against the repo's JAX CLIs.

``python -m rpg_ramnet_tpu_torch.eval`` and ``test.py`` on the same
synthetic split and .pth.tar (tiny float32 config, --device cpu): the same
output tree, file for file, the saved predictions within 1e-5, and the
entry point's predictions equal to the per-package engine's run directly;
``--scan_chunk`` and ``--lanes 2`` within 1e-5 of the per-package
engine.
``python -m rpg_ramnet_tpu_torch.stream`` and ``depth_stream.py`` on the
same synthetic event log: the same windows, depth maps within 1e-5.
The JAX CLIs run as subprocesses on the CPU; the port's in-process.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rpg_ramnet_tpu_torch import stream
from rpg_ramnet_tpu_torch.core.config import Config
from rpg_ramnet_tpu_torch.data import (CenterCrop, concatenate_subfolders,
                                       generate_split)
from rpg_ramnet_tpu_torch.eval import StreamingInference
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
K, CROP = 2, (32, 64)
SPLIT = {"every_x_rgb_frame": K, "step_size": 1, "clip_distance": 80.0,
         "reg_factor": 3.70378}
CONFIG = {
    "name": "tiny", "arch": "ERGB2DepthRecurrent",
    "data_loader": {"train": dict(SPLIT), "validation": dict(SPLIT),
                    "batch_size": 1},
    "model": {"recurrent_block_type": "conv", "state_combination": "convgru",
              "num_encoders": 2, "base_num_channels": 8,
              "num_residual_blocks": 1, "norm": "none"}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic test split of two sequences, the config and a .pth.tar
    of seeded random weights."""
    root = tmp_path_factory.mktemp("cli")
    generate_split(str(root / "data/test"), n_sequences=2, n_frames=10,
                   height=40, width=70, events_per_frame=500)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(CONFIG))
    cfg = Config.from_dict(CONFIG)
    model = ERGB2DepthRecurrent(cfg.model,
                                generator=torch.Generator().manual_seed(3))
    export_pth_tar(str(root / "model.pth.tar"), model, cfg.arch, CONFIG)
    return root, cfg, model


def _env(root):
    # two threads: the suite runs several test processes at once
    return {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "2",
            "PREPROCESSED_DATASETS_FOLDER": str(root / "data")}


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _cli_args(root, out):
    return ["--path_to_model", str(root / "model.pth.tar"), "--config",
            str(root / "config.json"), "--output_path", str(out),
            "--data_folder", "test", "--crop", ",".join(map(str, CROP))]


def test_eval_entry_point_matches_test_py(setup, monkeypatch, capsys):
    root, cfg, model = setup
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "test.py"),
         *_cli_args(root, root / "out_jax")],
        cwd=root, env=_env(root), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(root / "data"))
    got = {}
    eval_main([*_cli_args(root, root / "out_port"), "--device", "cpu"],
              on_prediction=got.__setitem__)
    printed = capsys.readouterr().out
    for line in ("total scale: ", "min scale: ", "max scale: ",
                 "total metrics: "):
        assert line in printed and line in proc.stdout, line

    names = _tree(root / "out_port")
    assert names == _tree(root / "out_jax")
    npys = [n for n in names if n.endswith(".npy")]
    # 5 packages per sequence, kept from the third on: 3 x 2 items, each
    # with a prediction, a ground truth and a label per key
    assert len(npys) == 3 * 2 * 3 * (K + 1)
    for n in npys:
        np.testing.assert_allclose(np.load(root / "out_port" / n),
                                   np.load(root / "out_jax" / n), atol=ATOL,
                                   err_msg=n)

    # the entry point's predictions are the engine's, run directly
    dataset = concatenate_subfolders(
        str(root / "data/test"), "SequenceSynchronizedFramesEventsDataset",
        "events/voxels", "depth/data", "rgb/data", sequence_length=1,
        transform=CenterCrop(CROP), every_x_rgb_frame=K, clip_distance=80.0)
    engine = StreamingInference(model, batched_decode=True)
    prev = -1
    assert sorted(got) == list(range(len(dataset))) and len(got) == 10
    for idx in range(len(dataset)):
        item, d = dataset[idx]
        if d != prev:
            engine.reset(1, *CROP)
            prev = d
        want = engine.step({"events": item["events"][0],
                            "image": item["image"][0]})
        for k in want:
            np.testing.assert_array_equal(got[idx][k], want[k])


def test_eval_scan_chunk_matches_per_package(setup, monkeypatch):
    root, _, _ = setup
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(root / "data"))
    base = ["--path_to_model", str(root / "model.pth.tar"), "--config",
            str(root / "config.json"), "--data_folder", "test", "--crop",
            ",".join(map(str, CROP)), "--device", "cpu"]
    per_package, chunked = {}, {}
    eval_main(base, on_prediction=per_package.__setitem__)
    eval_main(base + ["--scan_chunk", "3", "--precompute_x", "on"],
              on_prediction=chunked.__setitem__)
    assert sorted(chunked) == sorted(per_package)
    for idx in per_package:
        for k in per_package[idx]:
            np.testing.assert_allclose(chunked[idx][k], per_package[idx][k],
                                       atol=ATOL)
    # spatial partitioning: H in two row bands over a CPU mesh of two
    spatial = {}
    eval_main(base + ["--mesh", "2", "--lanes", "1"],
              on_prediction=spatial.__setitem__)
    assert sorted(spatial) == sorted(per_package)
    for idx in per_package:
        for k in per_package[idx]:
            np.testing.assert_allclose(spatial[idx][k], per_package[idx][k],
                                       atol=ATOL)
    # lane-batched streaming runs: two lanes, one sequence each
    lanes = {}
    eval_main(base + ["--lanes", "2"], on_prediction=lanes.__setitem__)
    assert sorted(lanes) == sorted(per_package)
    for idx in per_package:
        for k in per_package[idx]:
            np.testing.assert_allclose(lanes[idx][k], per_package[idx][k],
                                       atol=ATOL)


def _event_log(path, n, height, width, seed=0):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(100.0, 100.5, n))
    with open(path, "w") as f:
        f.write(f"{width} {height}\n")
        for ti, x, y, p in zip(t, rng.randint(0, width, n),
                               rng.randint(0, height, n), rng.randint(0, 2, n)):
            f.write(f"{ti:.9f} {x} {y} {p}\n")


def test_stream_entry_point_matches_depth_stream(setup):
    root, _, _ = setup
    h, w = 30, 46                  # reflection-padded to 32 x 48
    per_window = int(w * h * 0.35)
    _event_log(str(root / "events.txt"), 4 * per_window + 100, h, w)
    args = ["-i", str(root / "events.txt"), "--path_to_model",
            str(root / "model.pth.tar"), "--config", str(root / "config.json"),
            "--height", str(h), "--width", str(w), "--save_numpy",
            "--show_events"]
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "depth_stream.py"), *args,
         "-o", str(root / "stream_jax")],
        cwd=root, env=_env(root), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    depths = {}
    windows = stream.main(args + ["-o", str(root / "stream_port"),
                                  "--device", "cpu"],
                          on_window=depths.__setitem__)
    assert windows == len(depths) == 5      # four full windows and a tail
    names = _tree(root / "stream_port")
    assert names == _tree(root / "stream_jax") and len(names) == 3 * windows
    for n in names:
        if n.endswith(".npy"):
            got = np.load(root / "stream_port" / n)
            assert got.shape == (1, h, w) and np.isfinite(got).all()
            np.testing.assert_allclose(got, np.load(root / "stream_jax" / n),
                                       atol=ATOL, err_msg=n)
