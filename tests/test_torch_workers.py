"""The port's process workers (``BatchLoader(worker_mode='process')``)
against its thread workers and the JAX package's loader, on the CPU, and
``python -m rpg_ramnet_tpu_torch.train --worker_mode process`` in-process.

The mirror of JAX's tests/test_data.py::test_process_workers_match_thread_workers:
on one synthetic split with the training transforms (random flips and
crops, seeded per (seed, epoch, index)), two epochs of process batches
equal the thread batches and JAX's bit for bit, unsharded and under the
data-parallel shard (each rank's share of every global batch).  The
training entry point trains through process workers to the thread
workers' losses, in one process and as two data-parallel gloo ranks, and
shuts both pools down when it returns and when training raises.
"""
import json
import logging
import math
import multiprocessing
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import rpg_ramnet_tpu.data as jdata

from rpg_ramnet_tpu_torch import data as tdata
from rpg_ramnet_tpu_torch.data import loader as tloader
from rpg_ramnet_tpu_torch.parallel.input_pipeline import local_indices
from rpg_ramnet_tpu_torch.train import trainer as ttrainer
from rpg_ramnet_tpu_torch.train.__main__ import main as train_main
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 24


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("workers") / "train")
    tdata.generate_split(root, n_sequences=2, n_frames=14, height=32,
                         width=48, events_per_frame=150)
    return root


def _loader(lib, root, mode, batch_size=4, **kw):
    ds = lib.concatenate_subfolders(
        root, "SequenceSynchronizedFramesEventsDataset", "events/voxels",
        "depth/data", "rgb/data", sequence_length=2, step_size=2,
        clip_distance=80.0, every_x_rgb_frame=2, reg_factor=3.70378,
        transform=lib.Compose([lib.RandomRotationFlip(0.0, 0.5, 0.0),
                               lib.RandomCrop(CROP)]))
    return lib.BatchLoader(ds, batch_size=batch_size, shuffle=True,
                           num_workers=2, seed=11, worker_mode=mode, **kw)


def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def _assert_same(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            assert set(bg) == set(bw)
            for k in bw:
                assert bg[k].dtype == bw[k].dtype, k
                np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


@pytest.mark.parametrize("shard, drop_last",
                         [(None, False), ((1, 2), False), ((0, 2, 2), True)],
                         ids=["unsharded", "rank1of2", "rank0of2_accum2"])
def test_process_workers_match_thread_workers_and_jax(split, shard, drop_last):
    """Batches of 4 over 6 windows: a ragged last batch where drop_last
    is off; two micro-batches of 2 over two ranks need whole batches."""
    thread = _epochs(_loader(tdata, split, "thread", shard=shard,
                             drop_last=drop_last))
    lp = _loader(tdata, split, "process", shard=shard, drop_last=drop_last)
    try:
        process = [list(lp)]
        pool = lp._proc_pool
        assert pool is not None
        process.append(list(lp))
        assert lp._proc_pool is pool        # one pool for the loader's life
    finally:
        lp.close()
    assert lp._proc_pool is None
    _assert_same(process, thread)
    jax_batches = _epochs(_loader(jdata, split, "thread", drop_last=drop_last))
    if shard is not None:
        jax_batches = [[{k: v[local_indices(len(v), *shard)]
                         for k, v in b.items()} for b in e]
                       for e in jax_batches]
    _assert_same(process, jax_batches)
    sizes = [len(b["image"]) for b in process[0]]
    assert sizes == {None: [4, 2], (1, 2): [2, 1], (0, 2, 2): [2]}[shard]


def test_worker_mode_is_checked(split):
    with pytest.raises(ValueError, match="worker_mode 'fork'"):
        _loader(tdata, split, "fork")
    _loader(tdata, split, "thread").close()      # a no-op in thread mode


class _NullWriter:
    def __getattr__(self, name):
        return lambda *a, **k: None


class _RecordedPool(tloader.ProcessPoolExecutor):
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.made.append(self)


def _write_run(tmp_path, names, val_sequences=1):
    """A synthetic train/val split under tmp_path/data and a tiny config
    per name (runs under tmp_path/runs); returns {name: config path}."""
    data = tmp_path / "data"
    tdata.generate_split(str(data / "train"), n_sequences=2, n_frames=8,
                         height=28, width=26)
    tdata.generate_split(str(data / "val"), n_sequences=val_sequences,
                         n_frames=8 if val_sequences > 1 else 6,
                         height=28, width=26, seed=5)
    paths = {}
    for name in names:
        cfg = {
            "name": f"workers_{name}", "arch": "ERGB2DepthRecurrent",
            "data_loader": {
                "train": {"base_folder": "train", "every_x_rgb_frame": 2,
                          "step_size": 1, "clip_distance": 80.0,
                          "reg_factor": 3.70378},
                "validation": {"base_folder": "val", "every_x_rgb_frame": 2,
                               "step_size": 1, "clip_distance": 80.0,
                               "reg_factor": 3.70378},
                "batch_size": 2, "num_workers": 2, "crop_size": CROP},
            "optimizer_type": "Adam", "optimizer": {"lr": 3e-4},
            "loss": {"type": "scale_invariant_loss",
                     "config": {"weight": 1.0, "n_lambda": 1.0}},
            "grad_loss": {"weight": 0.25},
            "trainer": {"epochs": 1, "sequence_length": 2,
                        "save_dir": str(tmp_path / "runs"), "save_freq": 1,
                        "still_previews": False, "movie": False,
                        "num_previews": 0, "num_val_previews": 0},
            "model": {"recurrent_block_type": "conv",
                      "state_combination": "convgru", "num_encoders": 2,
                      "base_num_channels": 4, "num_residual_blocks": 1,
                      "norm": "none"}}
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    return paths


def _train_setup(tmp_path, monkeypatch):
    paths = _write_run(tmp_path, ("thread", "process"))
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(tmp_path / "data"))
    monkeypatch.setattr(tloader, "ProcessPoolExecutor", _RecordedPool)
    _RecordedPool.made = []
    return paths


def _assert_pools_down(n, children_before):
    assert len(_RecordedPool.made) == n
    assert all(p._shutdown_thread for p in _RecordedPool.made)
    assert set(multiprocessing.active_children()) <= children_before


def test_train_entry_process_workers(tmp_path, monkeypatch, caplog):
    paths = _train_setup(tmp_path, monkeypatch)
    before = set(multiprocessing.active_children())
    logs = {}
    for mode in ("thread", "process"):
        with caplog.at_level(logging.INFO, logger="Trainer"):
            trainer = train_main(["-c", paths[mode], "--device", "cpu",
                                  "--no_mesh", "--worker_mode", mode],
                                 writer=_NullWriter())
        logs[mode] = trainer.jsonl.entries[0]
        assert trainer.train_loader.worker_mode == mode
        assert trainer.train_loader._proc_pool is None
        assert trainer.valid_loader._proc_pool is None
    # the train and the validation loader each had a pool, both shut down
    _assert_pools_down(2, before)
    for key in ("train_loss", "val_loss"):
        assert math.isfinite(logs["process"][key])
        assert logs["process"][key] == logs["thread"][key], key
    # the trainer logs the parameter summary once at start, per run
    assert caplog.text.count("Trainable parameters: ") == 2
    assert "Model: ERGB2DepthRecurrent" in caplog.text


def test_train_entry_closes_pools_when_training_raises(tmp_path, monkeypatch):
    paths = _train_setup(tmp_path, monkeypatch)

    def fail(self):
        next(iter(self.train_loader))          # the pool has started
        next(iter(self.valid_loader))
        raise RuntimeError("training failed")

    monkeypatch.setattr(ttrainer.Trainer, "train", fail)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="training failed"):
        train_main(["-c", paths["process"], "--device", "cpu", "--no_mesh",
                    "--worker_mode", "process"], writer=_NullWriter())
    _assert_pools_down(2, before)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_entry_process_workers_under_data_parallelism(tmp_path):
    """Two gloo ranks of ``python -m rpg_ramnet_tpu_torch.train
    --worker_mode process``, each with its own pools loading its share of
    every global batch, against one process with thread workers on the
    whole batch: the same losses; every process exits."""
    paths = _write_run(tmp_path, ("dp", "single"), val_sequences=2)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "PREPROCESSED_DATASETS_FOLDER": str(tmp_path / "data"),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2"}
    cmd = [sys.executable, "-m", "rpg_ramnet_tpu_torch.train", "--device",
           "cpu", "-c"]
    procs = [subprocess.Popen(
        cmd + [paths["dp"], "--worker_mode", "process"], cwd=tmp_path,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    procs.append(subprocess.Popen(
        cmd + [paths["single"], "--no_mesh"], cwd=tmp_path,
        env={**env, "RANK": "1", "LOCAL_RANK": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "data parallel: rank 0 of 2" in logs[0]
    entries = {}
    for name in ("dp", "single"):
        lines = (tmp_path / "runs" / f"workers_{name}" /
                 "train_log.jsonl").read_text().splitlines()
        assert len(lines) == 1, name
        entries[name] = json.loads(lines[0])
    for key in ("train_loss", "val_loss", "train_grad_norm"):
        assert math.isfinite(entries["dp"][key])
        np.testing.assert_allclose(entries["dp"][key], entries["single"][key],
                                   rtol=1e-5, err_msg=key)
