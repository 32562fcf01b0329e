"""The port's parallel package against the JAX package's, in one process.

- ``shard_sequence_folders`` and ``per_host_batch_size`` against JAX's
  with an explicit process index and count;
- ``shard_batch``'s shares against the shards JAX's ``shard_batch`` puts
  on each device of a 2- and a 4-device mesh (the conftest's virtual CPU
  devices), key by key (time-leading keys on dim 1);
- ``local_batch`` under grad_accum against JAX's micro-batch split
  (train_step.py:49-56) followed by the data shard; the loader's shard;
- the lane engines over a 2-device CPU mesh (two replicas on the CPU)
  against JAX's engines over a 2-device mesh, per step with mid-stream
  resets (per package: the flagship and the phased recipe; chunked) and
  against the port's own single-device engine; JAX's ValueError where
  the lanes do not divide over the mesh;
- ``device_voxelize_prefetch(sharding=)``: each share's grids are that
  share of the unsharded batch's;
- the eval entry point's ``--mesh 2 --lanes 2`` against ``--lanes 2``,
  ``--mesh 3 --lanes 1`` (spatial) refused where the crop's height does
  not split into 3 bands of a multiple of 2**num_encoders rows, and
  ``--mesh N`` with fewer than N GPUs refused with JAX's SystemExit;
- no fallback: NCCL without a GPU and a CUDA mesh without a GPU raise.

Float32 at atol 1e-5, rtol 1e-5 (tests/test_parallel.py); the phased
recipe against JAX at tests/test_torch_phased.py's 2e-3 / 1e-3 (the time
gate's fmod), and against the port's single device at 1e-5.
"""
import json

import numpy as np
import pytest
import torch

import jax

from rpg_ramnet_tpu.eval import inference as jinference
from rpg_ramnet_tpu.parallel import input_pipeline as jpipe
from rpg_ramnet_tpu.parallel import make_mesh as jax_make_mesh
from rpg_ramnet_tpu.parallel import mesh as jmesh

from rpg_ramnet_tpu_torch.core.config import Config, MeshConfig
from rpg_ramnet_tpu_torch.data import generate_split
from rpg_ramnet_tpu_torch.data import raw_pipeline as rp
from rpg_ramnet_tpu_torch.data.loader import BatchLoader
from rpg_ramnet_tpu_torch.eval import inference
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.parallel import (distributed, make_global_batch,
                                           make_mesh, per_host_batch_size,
                                           shard_batch, shard_sequence_folders,
                                           sharded_prefetch)
from rpg_ramnet_tpu_torch.parallel.input_pipeline import (local_batch,
                                                          local_indices)
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar

from test_torch_lanes import (H, K, W, _check_same, _collect, _Dataset,
                              _models, _one_thread, _tol)  # noqa: F401
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
ATOL = RTOL = 1e-5


def _cpu_mesh(n=2):
    return make_mesh(MeshConfig(data=n, model=1), [CPU] * n)


# ------------------------------------------------------------ input sharding

@pytest.mark.parametrize("pi,pc", [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3),
                                   (2, 3)])
def test_shard_sequence_folders_matches_jax(pi, pc):
    folders = [f"seq{i:02d}" for i in (4, 0, 6, 2, 1, 5, 3)]
    assert shard_sequence_folders(folders, pi, pc) == \
        jpipe.shard_sequence_folders(folders, pi, pc)


def test_per_host_batch_size_matches_jax():
    for b, pc in ((8, 4), (8, 1), (6, 2), (16, 8)):
        assert per_host_batch_size(b, pc) == jpipe.per_host_batch_size(b, pc)
    with pytest.raises(ValueError):
        per_host_batch_size(7, 2)
    assert per_host_batch_size(8) == 8     # no process group: one rank


def _keyed_batch(b=8, t=3, seed=0):
    rng = np.random.RandomState(seed)
    batch = {k: rng.rand(b, t, 2).astype(np.float32)
             for k in ("events", "image", "depth_image")}
    batch.update({k: rng.rand(t, b, 2).astype(np.float32)
                  for k in ("events_tcf", "depth_image_t", "reset_t")})
    return batch


@pytest.mark.parametrize("count", [2, 4])
def test_shard_batch_cuts_every_key_as_jax(count):
    batch = _keyed_batch()
    mesh = jax_make_mesh(devices=jax.devices()[:count])
    sharded = jmesh.shard_batch(batch, mesh)
    devices = list(mesh.devices[:, 0])
    for k, arr in sharded.items():
        index = arr.sharding.devices_indices_map(arr.shape)
        for i, d in enumerate(devices):
            want = np.asarray(batch[k][index[d]])
            np.testing.assert_array_equal(shard_batch(batch, i, count)[k],
                                          want, err_msg=k)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert torch.equal(shard_batch(tensors, 1, count)["reset_t"],
                       tensors["reset_t"][:, 8 // count:2 * 8 // count])


def _jax_split_then_shard(batch, accum, world, rank):
    """JAX's grad_accum split (train_step.py:49-56: the i-th contiguous
    micro-batch of the global batch, dim 1 for the time-leading keys),
    then each micro-batch sharded over a data mesh of ``world`` devices:
    rank's shards, micro-batch after micro-batch."""
    mesh = jax_make_mesh(devices=jax.devices()[:world])
    dev = mesh.devices[rank, 0]
    out = {}
    for i in range(accum):
        mb = {}
        for k, v in batch.items():
            dim = 1 if k.endswith("_tcf") or k.endswith("_t") else 0
            size = v.shape[dim] // accum
            mb[k] = jax.lax.dynamic_slice_in_dim(v, i * size, size, axis=dim)
        for k, arr in jmesh.shard_batch(mb, mesh).items():
            part = np.asarray(arr[arr.sharding.devices_indices_map(
                arr.shape)[dev]])
            out.setdefault(k, []).append(part)
    return {k: np.concatenate(v, axis=1 if k in jmesh.TIME_LEADING_KEYS
                              else 0) for k, v in out.items()}


@pytest.mark.parametrize("accum,world", [(1, 2), (2, 2), (4, 2), (2, 4)])
def test_local_batch_matches_jax_split_then_shard(accum, world):
    batch = _keyed_batch()
    for rank in range(world):
        want = _jax_split_then_shard(batch, accum, world, rank)
        got = local_batch(batch, rank, world, accum)
        got_t = local_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                            rank, world, accum)
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got_t[k].numpy(), want[k],
                                          err_msg=k)
    with pytest.raises(ValueError):
        local_indices(6, 0, 2, 2)


class _Items:
    """A dataset whose item i is {'x': [i]} (the loader's contract)."""

    def __len__(self):
        return 12

    def get(self, i, seed=None):
        return {"x": np.array([i])}, 0


@pytest.mark.parametrize("accum", [1, 2])
def test_loader_shard_is_the_ranks_items_of_one_global_order(accum):
    whole = [b["x"][:, 0] for b in BatchLoader(_Items(), 4, seed=3)]
    ranks = [[b["x"][:, 0] for b in
              BatchLoader(_Items(), 4, seed=3, shard=(r, 2, accum))]
             for r in (0, 1)]
    for i, b in enumerate(whole):
        for r in (0, 1):
            np.testing.assert_array_equal(ranks[r][i],
                                          b[local_indices(4, r, 2, accum)])
    # sharded_prefetch takes the same share of host batches
    got = [t["x"][:, 0].numpy() for t in sharded_prefetch(
        iter({"x": b[:, None]} for b in whole), CPU, rank=1, world=2,
        grad_accum=accum)]
    for g, b in zip(got, whole):
        np.testing.assert_array_equal(g, b[local_indices(4, 1, 2, accum)])
    assert make_global_batch({"x": torch.ones(2)})["x"].shape == (2,)


# ------------------------------------------------------------- lane meshes

def _pkgs(recipe, n, steps, seed):
    rng = np.random.RandomState(seed)
    t0 = np.zeros((n, 1), np.float32)
    out = []
    for _ in range(steps):
        pkg = {"events": rng.randn(n, K, H, W, 5).astype(np.float32),
               "image": rng.rand(n, H, W, 1).astype(np.float32)}
        if recipe == "phased":
            te = (t0 + np.cumsum(rng.uniform(0.01, 0.1, (n, K)), 1)
                  ).astype(np.float32)
            pkg["times_events"] = te
            pkg["times_image"] = (te[:, -1] + 0.005).astype(np.float32)
            t0 = pkg["times_image"][:, None]
        out.append(pkg)
    resets = [np.ones(n, bool), rng.rand(n) < 0.4, np.zeros(n, bool)]
    return out, resets


@pytest.mark.parametrize("recipe", ["flagship", "phased"])
def test_mesh_batched_streaming_engine_matches_jax_mesh(recipe):
    jcfg, params, model = _models(recipe)
    n = 4
    pkgs, resets = _pkgs(recipe, n, 3, seed=1)
    jeng = jinference.BatchedStreamingInference(
        params, jcfg, n, H, W, mesh=jax_make_mesh(devices=jax.devices()[:2]))
    eng = inference.BatchedStreamingInference(model, n, H, W,
                                              mesh=_cpu_mesh())
    single = inference.BatchedStreamingInference(model, n, H, W)
    assert len(eng.replicas) == 2 and eng.replicas[0] is not model
    atol, rtol = _tol(recipe)
    for t, (pkg, rm) in enumerate(zip(pkgs, resets)):
        want = jeng.step(pkg, rm)
        got = eng.step(pkg, rm)
        ref = single.step(pkg, rm)
        for k in want:
            assert got[k].shape == (n, H, W, 1)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=atol, rtol=rtol,
                                       err_msg=f"step {t} {k}")
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {t} {k}")


@pytest.mark.parametrize("pre", [True, False], ids=["precompute", "plain"])
def test_mesh_batched_chunked_streaming_matches_jax_mesh(pre):
    jcfg, params, model = _models("flagship")
    ds = _Dataset((5, 2, 3, 4), seed=6)
    jax_mesh = jax_make_mesh(devices=jax.devices()[:2])
    got, want, single = [], [], []
    inference.run_batched_chunked_streaming(
        ds, model, n_lanes=4, chunk=2, precompute_x=pre, mesh=_cpu_mesh(),
        on_prediction=_collect(got))
    jinference.run_batched_chunked_streaming(
        ds, params, jcfg, n_lanes=4, chunk=2, precompute_x=pre,
        mesh=jax_mesh, on_prediction=_collect(want))
    inference.run_batched_chunked_streaming(
        ds, model, n_lanes=4, chunk=2, precompute_x=pre,
        on_prediction=_collect(single))
    assert len(got) == len(ds)
    _check_same(got, want, ATOL, RTOL)
    _check_same(got, single, ATOL, RTOL)


def test_mesh_batched_streaming_runner_matches_single_device():
    _, _, model = _models("flagship")
    ds = _Dataset((3, 1, 2, 2), seed=7)
    got, single = [], []
    inference.run_batched_streaming(ds, model, n_lanes=4, mesh=_cpu_mesh(),
                                    on_prediction=_collect(got))
    inference.run_batched_streaming(ds, model, n_lanes=4,
                                    on_prediction=_collect(single))
    _check_same(got, single, ATOL, RTOL)


def test_lanes_must_divide_over_the_mesh_as_in_jax():
    jcfg, params, model = _models("flagship")
    with pytest.raises(ValueError) as want:
        jinference.BatchedStreamingInference(
            params, jcfg, 3, H, W,
            mesh=jax_make_mesh(devices=jax.devices()[:2]))
    with pytest.raises(ValueError) as got:
        inference.BatchedStreamingInference(model, 3, H, W, mesh=_cpu_mesh())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must divide evenly"):
        inference.run_batched_chunked_streaming(_Dataset((2,)), model,
                                                n_lanes=3, mesh=_cpu_mesh())


def test_make_mesh_rules_and_no_device_fallback():
    m = make_mesh(MeshConfig(data=-1, model=2), [CPU] * 4)
    assert m.shape == {"data": 2, "model": 2}
    assert m.devices == ((CPU, CPU), (CPU, CPU))
    assert make_mesh(devices=[CPU] * 3).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=-1, model=2), [CPU] * 3)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(data=4, model=1), [CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="nccl"):
            distributed.init_from_env("nccl")
    assert not distributed.syncing() and distributed.world() == 1


# ------------------------------------------------------------ raw pipeline

def _raw_batch(b=4, seed=0, n_max=64, h=12, w=10):
    rng = np.random.RandomState(seed)
    L, k = 2, 2
    ev = np.zeros((b, L, k, n_max, 4), np.float32)
    counts = rng.randint(5, n_max, (b, L, k)).astype(np.int32)
    for idx in np.ndindex(b, L, k):
        n = counts[idx]
        ev[idx][:n, 0] = np.sort(rng.rand(n))
        ev[idx][:n, 1] = rng.randint(0, w, n)
        ev[idx][:n, 2] = rng.randint(0, h, n)
        ev[idx][:n, 3] = rng.choice([-1.0, 1.0], n)
    return {"events_raw": ev, "events_count": counts,
            "image": rng.rand(b, L, h, w, 1).astype(np.float32)}


@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (1, 2, 2), (3, 4)])
def test_device_voxelize_prefetch_shares(shard):
    batches = [_raw_batch(seed=s) for s in range(2)]
    kw = dict(num_bins=3, height=12, width=10, device=CPU)
    whole = list(rp.device_voxelize_prefetch(iter(batches), **kw))
    parts = list(rp.device_voxelize_prefetch(iter(batches), sharding=shard,
                                             **kw))
    assert len(parts) == len(whole) == 2
    for got, full in zip(parts, whole):
        want = local_batch(full, *shard)
        assert sorted(got) == sorted(want) == ["events", "image"]
        assert got["events"].shape[0] == 4 // shard[1]
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)


# -------------------------------------------------------- the eval entry

CLI_K, CROP = 2, (32, 64)
CLI_SPLIT = {"every_x_rgb_frame": CLI_K, "step_size": 1,
             "clip_distance": 80.0, "reg_factor": 3.70378}
CLI_CONFIG = {
    "name": "tiny_mesh", "arch": "ERGB2DepthRecurrent",
    "data_loader": {"train": dict(CLI_SPLIT), "validation": dict(CLI_SPLIT),
                    "batch_size": 1},
    "model": {"recurrent_block_type": "conv", "state_combination": "convgru",
              "num_encoders": 2, "base_num_channels": 8,
              "num_residual_blocks": 1, "norm": "none"}}


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    generate_split(str(root / "data/test"), n_sequences=3, n_frames=8,
                   height=40, width=70, events_per_frame=300)
    (root / "config.json").write_text(json.dumps(CLI_CONFIG))
    cfg = Config.from_dict(CLI_CONFIG)
    model = ERGB2DepthRecurrent(cfg.model,
                                generator=torch.Generator().manual_seed(4))
    export_pth_tar(str(root / "model.pth.tar"), model, cfg.arch, CLI_CONFIG)
    return root


def _cli(root, *extra):
    return ["--path_to_model", str(root / "model.pth.tar"), "--config",
            str(root / "config.json"), "--data_folder", "test", "--crop",
            ",".join(map(str, CROP)), *extra]


@pytest.mark.parametrize("chunk", [0, 3], ids=["per_package", "chunked"])
def test_eval_entry_mesh_lanes_match_lanes(cli_root, monkeypatch, chunk):
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(cli_root / "data"))
    extra = ("--scan_chunk", str(chunk)) if chunk else ()
    got, want = {}, {}
    eval_main(_cli(cli_root, "--lanes", "4", "--mesh", "2", "--device", "cpu",
                   *extra), on_prediction=got.__setitem__)
    eval_main(_cli(cli_root, "--lanes", "4", "--device", "cpu", *extra),
              on_prediction=want.__setitem__)
    assert sorted(got) == sorted(want) and len(got) > 0
    for idx in want:
        for k in want[idx]:
            np.testing.assert_allclose(got[idx][k], want[idx][k], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{idx} {k}")


def test_eval_entry_mesh_refusals(cli_root, monkeypatch):
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(cli_root / "data"))
    with pytest.raises(ValueError, match="multiple of 2\\*\\*num_encoders"):
        eval_main(_cli(cli_root, "--mesh", "3", "--device", "cpu"))
    engine = inference.StreamingInference(
        ERGB2DepthRecurrent(Config.from_dict(CLI_CONFIG).model),
        spatial_mesh=make_mesh(MeshConfig(data=1, model=3), [CPU] * 3))
    with pytest.raises(ValueError, match="multiple of 2\\*\\*num_encoders"):
        engine.reset(1, *CROP)
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit,
                       match=f"--mesh {n + 1}: only {n} devices available"):
        eval_main(_cli(cli_root, "--mesh", str(n + 1), "--lanes", "2"))


def test_replicate_copies_are_ordinary_tensors_under_inference_mode():
    """The lane engines replicate under inference_mode; the kernels' weight
    folds read the replicas' version counters, which inference tensors
    lack."""
    _, _, model = _models("flagship")
    with torch.inference_mode():
        replicas, _ = inference._lane_replicas(model, 4, _cpu_mesh())
    for r in replicas:
        assert r is not model
        for (name, p), q in zip(r.named_parameters(), model.parameters()):
            assert not p.is_inference() and p._version >= 0, name
            assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()
