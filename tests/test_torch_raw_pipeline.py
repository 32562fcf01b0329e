"""The port's raw-event device data path (data/raw_pipeline.py) against the
JAX package's, on the CPU.

One synthetic split at 24x32 (K=3 windows per package, the tiny training
config's), from a seed: the bucketing, padding and the dataset's items bit
for bit; ``voxelize_batch`` with every backend against JAX's
``voxelize_batch(backend='scatter')`` within 1e-5; the prefetch stage key
for key against JAX's; and one training window from the raw batch: the
sequence loss and every parameter gradient against JAX's on the same
weights (crossed by ``params_to_state_dict``), at the tolerance of
tests/test_torch_train.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.data import augmentation as jaug
from rpg_ramnet_tpu.data import raw_pipeline as jrp
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core import config as tconfig
from rpg_ramnet_tpu_torch.data import BatchLoader, ConcatSequenceDataset, generate_split
from rpg_ramnet_tpu_torch.data import augmentation as taug
from rpg_ramnet_tpu_torch.data import raw_pipeline as rp
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train.train_step import make_grad_fn

from test_train import tiny_config

H, W, K, L, NB = 24, 32, 3, 2, 5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (tests/test_torch_lanes.py::_one_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("rawpipe") / "train"
    generate_split(str(root), n_sequences=1, n_frames=30, height=H, width=W,
                   events_per_frame=700)
    return str(root / "seq00")


def _datasets(seq, n_max=None, **kw):
    args = dict(sequence_length=L, step_size=1, clip_distance=80.0,
                every_x_rgb_frame=K, reg_factor=3.70378, n_max=n_max, **kw)
    return (rp.RawEventSequenceDataset(seq, "events/voxels", **args),
            jrp.RawEventSequenceDataset(seq, "events/voxels", **args))


def _windows(seed, sizes):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        t = np.sort(rng.uniform(0, 0.01, n))
        out.append(np.stack([t, rng.randint(0, W, n), rng.randint(0, H, n),
                             rng.randint(0, 2, n)], 1).astype(np.float32))
    return out


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 8192, 32768, 32769,
                               524288, 524289, 600000, 1048577])
def test_bucket_size_matches_jax(n):
    assert rp.bucket_size(n) == jrp.bucket_size(n)


@pytest.mark.parametrize("n_max", [None, 4096])
@pytest.mark.parametrize("sizes", [(5, 0, 700, 2100), (1,), ()],
                         ids=["ragged", "one", "none"])
def test_pad_event_windows_bitwise(sizes, n_max):
    wins = _windows(0, sizes)
    got, want = rp.pad_event_windows(wins, n_max), jrp.pad_event_windows(wins, n_max)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("n_max", [None, 8192])
def test_dataset_items_bitwise(split, n_max):
    port, ref = _datasets(split, n_max)
    assert len(port) == len(ref) > 3
    for i in (0, len(ref) - 1):
        got, want = port[i], ref[i]
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        assert got["events_raw"].shape == (L, K, n_max or 2048, 4)


def test_dataset_refuses_a_cropping_transform(split):
    with pytest.raises(ValueError, match="cannot be cropped"):
        rp.RawEventSequenceDataset(split, "events/voxels", sequence_length=L,
                                   every_x_rgb_frame=K,
                                   transform=taug.CenterCrop(16))
    # a flip keeps the size: frames and depth flipped, the grids not (JAX)
    flip = dict(sequence_length=L, step_size=1, clip_distance=80.0,
                every_x_rgb_frame=K, reg_factor=3.70378, n_max=2048)
    got = rp.RawEventSequenceDataset(
        split, "events/voxels", transform=taug.RandomRotationFlip(0.0, 1.0, 0.0),
        **flip).__getitem__(1, seed=3)
    want = jrp.RawEventSequenceDataset(
        split, "events/voxels", transform=jaug.RandomRotationFlip(0.0, 1.0, 0.0),
        **flip).__getitem__(1, seed=3)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("backend", ["auto", "scatter", "sortseg", "pallas",
                                     "matmul"])
def test_voxelize_batch_matches_jax(backend, normalize):
    """Windows of every size from empty to a full bucket, padded rows
    zero, as [2, 3, N, 4] + [2, 3]; the empty window stays zero."""
    wins = _windows(1, (900, 0, 1, 2048, 37, 1500))
    padded, counts = rp.pad_event_windows(wins)
    ev, n = padded.reshape(2, 3, -1, 4), counts.reshape(2, 3)
    got = rp.voxelize_batch(torch.from_numpy(ev), torch.from_numpy(n),
                            num_bins=NB, height=H, width=W, backend=backend,
                            normalize=normalize)
    want = np.asarray(jrp.voxelize_batch(
        jnp.asarray(ev), jnp.asarray(n), num_bins=NB, height=H, width=W,
        backend="scatter", normalize=normalize))
    assert got.shape == want.shape == (2, 3, H, W, NB)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert not got[0, 1].any()


def _batches(split, n=2, B=2):
    port, _ = _datasets(split, 2048)
    return list(BatchLoader(ConcatSequenceDataset([port]), B, shuffle=False,
                            num_workers=1))[:n]


@pytest.mark.parametrize("size", [1, 2])
def test_device_voxelize_prefetch_matches_jax(split, size):
    batches = _batches(split, n=3)
    got = list(rp.device_voxelize_prefetch(iter(batches), num_bins=NB,
                                           height=H, width=W, size=size,
                                           device=CPU))
    want = list(jrp.device_voxelize_prefetch(iter(batches), num_bins=NB,
                                             height=H, width=W, size=size))
    assert len(got) == len(want) == len(batches)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["events"].shape == (2, L, K, H, W, NB)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5 if k == "events" else 0, rtol=0,
                                       err_msg=k)


def test_prefetch_refuses_sharding():
    with pytest.raises(NotImplementedError, match="item 15"):
        next(rp.device_voxelize_prefetch(iter([]), num_bins=NB, height=H,
                                         width=W, sharding=object(),
                                         device=CPU))


def test_train_window_on_raw_batch_matches_jax(split):
    """The flagship recipe's step, cut to the tiny config: precompute_x,
    deferred decode, remat; one raw batch voxelized by each package's
    prefetch stage."""
    raw = tiny_config().raw
    raw = {**raw, "trainer": {**raw["trainer"], "deferred_decode": True,
                              "precompute_x": True}}
    jcfg = jconfig.Config.from_dict(raw)
    cfg = tconfig.Config.from_dict(raw)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg.model)
    model = ERGB2DepthRecurrent(cfg.model)
    params_from_jax(model, params)
    [batch] = _batches(split, n=1)
    [tb] = rp.device_voxelize_prefetch(iter([batch]), num_bins=NB, height=H,
                                       width=W, device=CPU)
    [jb] = jrp.device_voxelize_prefetch(iter([batch]), num_bins=NB, height=H,
                                        width=W)
    (j_loss, _), j_grads = jax.value_and_grad(jax_loss(jcfg, remat=True),
                                              has_aux=True)(
        params, JaxModel.init_state(jcfg.model, 2, H, W), jb)
    aux = make_grad_fn(cfg, model)(tb)
    np.testing.assert_allclose(aux["loss"].item(), float(j_loss), rtol=1e-5)
    want = params_to_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=5e-5, rtol=1e-3, err_msg=name)
