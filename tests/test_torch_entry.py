"""The port's top-level entry points (rpg_ramnet_tpu_torch/entry.py) and its
data-parallel training entry point, against the JAX package's.

- ``entry()`` on the CPU against JAX ``__graft_entry__.entry()`` run on
  the same weights: the same package (numpy seed 0), and the flagship's
  package forward at B=2, 128x128 equals JAX's (the image prediction
  and every tensor of the new state, at the model parity tests' 2e-5);
- ``dryrun_multichip(2)`` passes on the CPU: two gloo ranks, the train
  step and the deferred-decode step on each rank's share, one model on
  both ranks after them, and a lane-mesh engine step with reset masks;
- ``python -m rpg_ramnet_tpu_torch.train`` as a world of two gloo ranks
  (torchrun's environment, --device cpu) for one epoch: rank 0 alone
  writes (one JSONL line per epoch, one TensorBoard event file, the
  checkpoint), and its logged training and validation losses are those
  of ``--no_mesh`` (one process on the whole global batches, under the
  same environment) within rtol 1e-5.
"""
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jentry

from rpg_ramnet_tpu_torch import entry as tentry
from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.data import generate_split

from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel

from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_F32 = 2e-5


def test_entry_matches_graft_entry(monkeypatch, started):
    # (``started``: the subprocesses of the tests below run meanwhile)
    fn, (model, state, pkg) = tentry.entry(device="cpu")
    # JAX's entry() on the port's seeded weights, crossed into its tree
    # (its own init compiles for ~20 s here); they load back unchanged
    tree = _jax_tree(model)
    monkeypatch.setattr(JaxModel, "init_params",
                        staticmethod(lambda key, cfg: tree))
    jfn, (params, jstate, jpkg) = jentry.entry()
    want_img, want_state = jax.jit(jfn)(params, jstate, jpkg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params_from_jax(model, jax.tree_util.tree_map(np.asarray, params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k in ("events", "image"):
        np.testing.assert_array_equal(pkg[k].numpy(), np.asarray(jpkg[k]))
    img, new_state = fn(model, state, pkg)
    assert img.shape == (2, 128, 128, 1)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img),
                               atol=ATOL_F32)
    got = [t for t in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), new_state,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))]
    want = jax.tree_util.tree_leaves(want_state)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL_F32)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


SPLIT = {"every_x_rgb_frame": 2, "step_size": 1, "clip_distance": 80.0,
         "reg_factor": 3.70378}


def _config(save_dir, name):
    return {
        "name": name, "arch": "ERGB2DepthRecurrent",
        "data_loader": {"train": {"base_folder": "train", **SPLIT},
                        "validation": {"base_folder": "val", **SPLIT},
                        "batch_size": 2, "num_workers": 1, "crop_size": 24},
        "optimizer_type": "Adam", "optimizer": {"lr": 3e-4},
        "loss": {"type": "scale_invariant_loss",
                 "config": {"weight": 1.0, "n_lambda": 1.0}},
        "grad_loss": {"weight": 0.25},
        "trainer": {"epochs": 1, "sequence_length": 2, "save_dir": save_dir,
                    "save_freq": 1, "loss_composition": ["image", "events1"],
                    "loss_weights": [1, 1]},
        "model": {"recurrent_block_type": "conv",
                  "state_combination": "convgru", "num_encoders": 2,
                  "base_num_channels": 4, "num_residual_blocks": 1,
                  "norm": "none"}}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The dry run's two ranks (on a thread) and the training entry's
    three processes, started together so that their waits overlap:
    (the dry run's future, the training processes, the run root)."""
    tmp_path = tmp_path_factory.mktemp("entry")
    pool = ThreadPoolExecutor(1)
    dryrun = pool.submit(tentry.dryrun_multichip, 2, device="cpu",
                         timeout_s=180)
    # two sequences of equal length a split: whole global batches of 2
    for split, seed in (("train", 0), ("val", 5)):
        generate_split(str(tmp_path / "data" / split), n_sequences=2,
                       n_frames=8, height=28, width=26, seed=seed)
    runs = tmp_path / "runs"
    cfgs = {}
    for name in ("dp", "single"):
        cfgs[name] = tmp_path / f"{name}.json"
        cfgs[name].write_text(json.dumps(_config(str(runs), name)))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "PREPROCESSED_DATASETS_FOLDER": str(tmp_path / "data"),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2"}
    cmd = [sys.executable, "-m", "rpg_ramnet_tpu_torch.train", "--device",
           "cpu", "-c"]
    procs = [subprocess.Popen(
        cmd + [str(cfgs["dp"])], cwd=tmp_path,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    procs.append(subprocess.Popen(
        cmd + [str(cfgs["single"]), "--no_mesh"], cwd=tmp_path,
        env={**env, "RANK": "1", "LOCAL_RANK": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        yield dryrun, procs, runs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        pool.shutdown()


def test_dryrun_multichip_two_gloo_ranks(started):
    out = started[0].result(timeout=240)
    assert np.isfinite(out["loss"]) and np.isfinite(out["loss_deferred"])
    assert out["param_sum_spread"] == 0.0 and out["lane_finite"]


def test_train_entry_world_of_two_writes_from_rank_zero(started):
    _, procs, runs = started
    logs = [p.communicate(timeout=180)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    entries = {}
    for name in ("dp", "single"):
        run = runs / name
        lines = (run / "train_log.jsonl").read_text().splitlines()
        assert len(lines) == 1, name          # one writer, one epoch
        entries[name] = json.loads(lines[0])
        assert (run / "config.json").exists()
        assert (run / "checkpoint-epoch0").is_dir()
        tb = run / "tensorboard"
        if tb.is_dir():
            assert len(os.listdir(tb)) == 1, os.listdir(tb)
    for key in ("train_loss", "val_loss", "train_grad_norm"):
        assert np.isfinite(entries["dp"][key])
        np.testing.assert_allclose(entries["dp"][key], entries["single"][key],
                                   rtol=1e-5, err_msg=key)
