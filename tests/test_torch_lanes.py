"""Lane-batched streaming in the port against the JAX package.

Three tiny recipes (the flagship ConvGRU state combination with conv
encoders, the ConvLSTM state combination, and the phased regime with its
timestamps; 2 encoders, base 8, K=2, 16x32, as tests/test_torch_phased.py),
both packages on one seeded port model's weights (crossed into a JAX
param tree, and back by ``params_from_jax``), on in-memory datasets of
sequences of unequal lengths made from a numpy seed:

- the per-lane reset mask of every model entry that takes one, with the
  lanes resetting mid-chunk, against the JAX entry of the same name;
- ``_round_robin_lanes`` against JAX's;
- ``run_batched_streaming`` and ``run_batched_chunked_streaming`` against
  the JAX engines of the same name per item (predictions, sequence
  positions and the callbacks' order), with the x side precomputed and
  not, chunk 2, 3 and 4, lanes 2 and 3, and fewer sequences than lanes;
  and against the port's own single-lane engines;
- the eval entry point with --lanes 2, with and without --scan_chunk,
  against the JAX test.py's output tree.

Float32 at 1e-5 (2e-3 / 1e-3 where the phased time gate's fmod enters,
as tests/test_torch_phased.py); bf16, with the port's plain version of
K1 on the CPU and the JAX kernel in interpret mode, at 5e-2.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.eval import inference as jinference
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import Config, MeshConfig, ModelConfig
from rpg_ramnet_tpu_torch.data.synthetic import generate_eventscape_sequence
from rpg_ramnet_tpu_torch.eval import inference
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.parallel import make_mesh
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_F32 = 1e-5
ATOL_PHASED, RTOL_PHASED = 2e-3, 1e-3
SLICE_TOL = 5e-2
H, W, K = 16, 32, 2
BASE = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
            num_encoders=2, base_num_channels=8, num_residual_blocks=1,
            norm="none", use_upsample_conv=True, every_x_rgb_frame=K,
            baseline=False)
RECIPES = {
    "flagship": dict(BASE, recurrent_block_type="conv",
                     state_combination="convgru"),
    "lstm_comb": dict(BASE, recurrent_block_type="conv",
                      state_combination="convlstm"),
    "phased": dict(BASE, recurrent_block_type="convlstm",
                   state_combination="convlstm", use_phased_arch=True,
                   spatial_resolution=[H, W]),
}


def _jax_tree(model):
    """The port model's weights as a JAX param tree: the inverse of
    ``params_to_state_dict`` (nested dicts, lists for indexed children,
    HWIO conv weights, (kh, kw, in, out) transposed-conv ones).  It spares
    the JAX init's per-shape compiles; test_params_cross_both_ways holds
    it to JAX's own init tree."""
    tree = {}
    for name, v in model.state_dict().items():
        parts = name.split(".")[1:]
        a = v.float().numpy()
        if a.ndim == 4:
            a = a.transpose((2, 3, 0, 1) if parts[-2] == "transposed_conv2d"
                            else (2, 3, 1, 0))
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(tree)


@functools.lru_cache(maxsize=None)
def _params(recipe):
    """A seeded port model's weights as a JAX param tree, once per recipe
    (the float32 masters do not depend on the compute dtype or the
    policies)."""
    return _jax_tree(ERGB2DepthRecurrent(ModelConfig.from_dict(RECIPES[recipe])))


def _models(recipe, **over):
    """(JAX config, JAX params, a new port model with those weights)."""
    d = {**RECIPES[recipe], **over}
    params = _params(recipe)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    params_from_jax(model, params)
    return JaxModelConfig.from_dict(d), params, model


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_params_cross_both_ways(recipe):
    """_jax_tree gives the JAX init's tree structure and shapes, and loads
    back into the port unchanged."""
    jcfg, params, model = _models(recipe)
    # traced, not run: the tree and shapes without the init's compiles
    ref = jax.eval_shape(lambda k: JaxModel.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(ref))
    assert [np.shape(a) for a in jax.tree_util.tree_leaves(params)] == \
        [np.shape(a) for a in jax.tree_util.tree_leaves(ref)]
    other = ERGB2DepthRecurrent(model.cfg,
                                generator=torch.Generator().manual_seed(7))
    params_from_jax(other, params)
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the shapes are tiny, and the suite's
    parallel workers then do not oversubscribe the cores (torch's spinning
    threads made these tests 10-17x slower in a full run than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tol(recipe):
    return ((ATOL_PHASED, RTOL_PHASED) if recipe == "phased"
            else (ATOL_F32, 0.0))


class _Sequence:
    """One recorded sequence: item i is {'events': [1, K, H, W, 5],
    'image': [1, H, W, 1]} and with times 'times_events' [1, K] and
    'times_image' [1], irregular increasing stamps."""

    def __init__(self, n, rng, times):
        self.events = rng.randn(n, K, H, W, 5).astype(np.float32)
        self.image = rng.rand(n, H, W, 1).astype(np.float32)
        t = np.cumsum(rng.uniform(0.01, 0.2, n * K)).astype(np.float32)
        self.times = t.reshape(n, K) if times else None

    def __len__(self):
        return len(self.events)

    def __getitem__(self, i):
        item = {"events": self.events[i:i + 1], "image": self.image[i:i + 1]}
        if self.times is not None:
            item["times_events"] = self.times[i:i + 1]
            item["times_image"] = self.times[i:i + 1, -1] + 0.005
        return item


class _Dataset:
    """A ConcatSequenceDataset-like set of sequences: ``datasets``, and
    dataset[g] = (item, sequence index)."""

    def __init__(self, lengths, seed=0, times=False):
        rng = np.random.RandomState(seed)
        self.datasets = [_Sequence(n, rng, times) for n in lengths]
        self._index = [(s, i) for s, n in enumerate(lengths)
                       for i in range(n)]

    def __len__(self):
        return len(self._index)

    def __getitem__(self, g):
        s, i = self._index[g]
        return self.datasets[s][i], s


def _collect(log):
    """An on_prediction that records (global index, seq_pos, predictions)
    in call order."""
    return lambda g, p, item, pos: log.append(
        (g, pos, {k: np.asarray(v, np.float32) for k, v in p.items()}))


def _check_same(got, want, atol, rtol=0.0, order=True):
    """Two logs of _collect: the same items (in the same order), the same
    sequence positions, predictions within tolerance."""
    if order:
        assert [g for g, _, _ in got] == [g for g, _, _ in want]
    got_d = {g: (pos, p) for g, pos, p in got}
    want_d = {g: (pos, p) for g, pos, p in want}
    assert len(got_d) == len(got) and sorted(got_d) == sorted(want_d)
    for g, (pos, p) in want_d.items():
        assert got_d[g][0] == pos, g
        assert sorted(got_d[g][1]) == sorted(p)
        for k in p:
            assert got_d[g][1][k].shape == (H, W, 1)
            np.testing.assert_allclose(got_d[g][1][k], p[k], atol=atol,
                                       rtol=rtol, err_msg=f"item {g} {k}")


# --------------------------------------------------------------- the model


def _batch(recipe, B, L, seed):
    """[B, L, ...] inputs, timestamps for the phased recipe."""
    rng = np.random.RandomState(seed)
    seq = {"events": rng.randn(B, L, K, H, W, 5).astype(np.float32),
           "image": rng.rand(B, L, H, W, 1).astype(np.float32)}
    if recipe == "phased":
        t = np.cumsum(rng.uniform(0.01, 0.2, (B, L * K)), 1).astype(np.float32)
        seq["times_events"] = t.reshape(B, L, K)
        seq["times_image"] = seq["times_events"][:, :, -1] + 0.005
    return seq


# from the zero state, lane 0 resets at the chunk's second package, lane 1
# at its third, lane 2 never: boundaries mid-chunk, after a non-zero state
RESET = np.array([[False, True, False], [False, False, True],
                  [False, False, False]])
ENTRIES = {
    "flagship": ("forward_package", "forward_package_batched_decode",
                 "forward_sequence", "forward_sequence_batched_decode",
                 "package_precompute", "forward_sequence_precomputed"),
    "lstm_comb": ("forward_package", "forward_sequence_batched_decode",
                  "package_precompute", "forward_sequence_precomputed"),
    "phased": ("forward_package", "forward_package_batched_decode",
               "forward_sequence_batched_decode"),
}


def _run_entry(entry, fwd_pkg, fwd_seq, state, seq):
    """One chunk through an entry: the per-package entries package by
    package, the reset column of each package in it; returns (state,
    {key: [L, B, H, W, 1]})."""
    if entry not in ("forward_package", "forward_package_batched_decode"):
        return fwd_seq(state, seq)
    preds = []
    for t in range(seq["image"].shape[1]):
        state, p = fwd_pkg(state, {k: v[:, t] for k, v in seq.items()})
        preds.append(p)
    return state, {k: np.stack([np.asarray(p[k], np.float32) for p in preds])
                   for k in preds[0]}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy()]
    if isinstance(tree, (tuple, list)):
        return [a for s in tree for a in _leaves(s)]
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("recipe,entry", [(r, e) for r in ENTRIES
                                          for e in ENTRIES[r]])
def test_reset_mask_matches_jax(recipe, entry):
    """A chunk whose mask resets lanes mid-chunk, through the port's entry
    and the JAX one: predictions and the final state.  The mask is live:
    without it the outputs of the reset lanes differ."""
    jcfg, params, model = _models(recipe)
    chunk = _batch(recipe, 3, 3, 1)
    chunk["reset"] = RESET
    kw = {"package_precompute": dict(package_precompute=True)}.get(entry, {})
    name = ("forward_sequence_batched_decode" if entry == "package_precompute"
            else entry)
    jfn, tfn = getattr(JaxModel, name), getattr(model, name)
    jpkg = jax.jit(lambda p, s, x: jfn(p, jcfg, s, x))
    jseq = jax.jit(lambda p, s, x: jfn(p, jcfg, s, x, **kw))

    def as_jax(x):
        return {k: jnp.asarray(v) for k, v in x.items()}

    def as_torch(x):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in x.items()}

    def run_jax(state, x):
        return _run_entry(entry, lambda s, p: jpkg(params, s, as_jax(p)),
                          lambda s, q: jseq(params, s, as_jax(q)), state, x)

    def run_port(state, x):
        with torch.inference_mode():
            return _run_entry(entry, lambda s, p: tfn(s, as_torch(p)),
                              lambda s, q: tfn(s, as_torch(q), **kw), state, x)

    j_state, want = run_jax(JaxModel.init_state(jcfg, 3, H, W), chunk)
    t_state, got = run_port(model.init_state(3, H, W), chunk)
    unmasked = run_port(model.init_state(3, H, W),
                        {k: v for k, v in chunk.items() if k != "reset"})[1]
    outs = {}
    atol, rtol = _tol(recipe)
    assert sorted(got) == sorted(want) == ["events0", "events1", "image"]
    for k in want:
        got_k = np.asarray(got[k], np.float32)
        assert got_k.shape == (3, 3, H, W, 1)
        np.testing.assert_allclose(got_k, np.asarray(want[k], np.float32),
                                   atol=atol, rtol=rtol, err_msg=k)
        outs[k] = got_k
    t_leaves, j_leaves = _leaves(t_state), _leaves(j_state)
    assert len(t_leaves) == len(j_leaves) > 0
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
    # lanes 0 and 1 reset (from their reset step on), lane 2 did not
    diff = np.abs(np.asarray(unmasked["image"], np.float32) - outs["image"])
    assert diff[1:, 0].max() > 1e-4 and diff[2:, 1].max() > 1e-4
    assert diff[0].max() == diff[:2, 1].max() == diff[:, 2].max() == 0.0


def test_reset_mask_refused_where_jax_refuses():
    """chunk_cells and stream_cells take no reset mask and no batch > 1,
    as in JAX."""
    _, _, model = _models("flagship", compute_dtype="bfloat16")
    seq = {k: torch.from_numpy(v) for k, v in _batch("flagship", 1, 2, 0).items()}
    masked = dict(seq, reset=torch.zeros(1, 2, dtype=torch.bool))
    wide = {k: v.repeat(2, *([1] * (v.dim() - 1))) for k, v in seq.items()}
    for kw in (dict(chunk_cells=True), dict(stream_cells=True)):
        name = next(iter(kw))
        for s, b in ((masked, 1), (wide, 2)):
            with pytest.raises(ValueError, match=name):
                model.forward_sequence_precomputed(model.init_state(b, H, W),
                                                   s, **kw)


# ------------------------------------------------------------- the engines


@pytest.mark.parametrize("sizes,n_lanes", [
    ((5,), 2), ((3, 2, 4), 2), ((1, 1, 1, 1, 1), 3), ((4, 0, 3, 1), 3),
    ((2, 6), 4), ((), 2)])
def test_round_robin_lanes_matches_jax(sizes, n_lanes):
    ds = _Dataset(sizes)
    got = inference._round_robin_lanes(ds, n_lanes)
    want = jinference._round_robin_lanes(ds, n_lanes)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[2]) == list(want[2])


@pytest.mark.parametrize("recipe,sizes,n_lanes", [
    ("flagship", (4, 2, 3), 2), ("flagship", (3, 1), 3),
    ("lstm_comb", (3, 2, 2), 2), ("phased", (3, 1, 2), 2)],
    ids=["flagship_l2", "flagship_l3_two_seqs", "lstm_comb_l2", "phased_l2"])
def test_batched_streaming_matches_jax(recipe, sizes, n_lanes):
    jcfg, params, model = _models(recipe)
    ds = _Dataset(sizes, seed=2, times=recipe == "phased")
    got, want = [], []
    inference.run_batched_streaming(ds, model, n_lanes=n_lanes,
                                    on_prediction=_collect(got))
    jinference.run_batched_streaming(ds, params, jcfg, n_lanes=n_lanes,
                                     on_prediction=_collect(want))
    assert len(got) == sum(sizes)
    _check_same(got, want, *_tol(recipe))


CHUNKED = {
    "flagship_pre_c2_l2": ("flagship", (5, 2, 3), 2, 2, True),
    "flagship_nopre_c4_l2": ("flagship", (5, 2, 3), 2, 4, False),
    "flagship_pre_c4_l3_two_seqs": ("flagship", (5, 2), 3, 4, True),
    "flagship_nopre_c2_l3": ("flagship", (3, 1, 4, 2), 3, 2, False),
    "lstm_comb_pre_c3_l2": ("lstm_comb", (4, 2, 3), 2, 3, True),
    "phased_c2_l3_two_seqs": ("phased", (3, 4), 3, 2, None),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_batched_chunked_streaming_matches_jax(case):
    recipe, sizes, n_lanes, chunk, pre = CHUNKED[case]
    jcfg, params, model = _models(recipe)
    ds = _Dataset(sizes, seed=3, times=recipe == "phased")
    got, want = [], []
    inference.run_batched_chunked_streaming(
        ds, model, n_lanes=n_lanes, chunk=chunk, precompute_x=pre,
        on_prediction=_collect(got))
    jinference.run_batched_chunked_streaming(
        ds, params, jcfg, n_lanes=n_lanes, chunk=chunk, precompute_x=pre,
        on_prediction=_collect(want))
    assert len(got) == sum(sizes)
    _check_same(got, want, *_tol(recipe))


def test_batched_chunked_bf16_matches_jax_kernels(monkeypatch):
    """bf16 on the precomputed path (auto): the port's K1 plain version
    through its wrapper on every cell against the JAX h-side kernel in
    interpret mode (fused_gru='on' there), lanes reset mid-chunk, and
    decode_keys."""
    jcfg, params, model = _models("flagship", compute_dtype="bfloat16",
                                  fused_gru="on")
    model.cfg = ModelConfig.from_dict({**RECIPES["flagship"],
                                       "compute_dtype": "bfloat16"})
    calls = []
    real = gru_hside.conv_gru_hside
    monkeypatch.setattr(gru_hside, "conv_gru_hside",
                        lambda *a, **kw: calls.append(a[0].shape[0])
                        or real(*a, **kw))
    monkeypatch.setattr(jax_gru_hside, "_INTERPRET", True)
    ds = _Dataset((3, 2, 2), seed=4)
    got, want = [], []
    for fn, args, log in ((inference.run_batched_chunked_streaming,
                           (ds, model), got),
                          (jinference.run_batched_chunked_streaming,
                           (ds, params, jcfg), want)):
        fn(*args, n_lanes=2, chunk=2, decode_keys=("events1", "image"),
           on_prediction=_collect(log))
    # 2 scales x (K+1) steps per package; lane 0 holds 3 + 2 packages,
    # so 3 chunks of 2 packages, batch 2
    assert calls == [2] * 2 * (K + 1) * 6
    assert real.launches == 0
    assert all(sorted(p) == ["events1", "image"] for _, _, p in got)
    _check_same(got, want, SLICE_TOL)


@pytest.mark.parametrize("recipe", ["flagship", "phased"])
def test_lane_engines_match_single_lane(recipe):
    """Each lane engine per item against the port's own single-lane
    engine: per package (StreamingInference, state reset at each
    sequence) and chunked (run_chunked_streaming).  No padded package
    reaches the callback."""
    _, _, model = _models(recipe)
    sizes = (4, 1, 3, 2)
    ds = _Dataset(sizes, seed=5, times=recipe == "phased")
    single = []
    engine = inference.StreamingInference(model)
    for g in range(len(ds)):
        item, s = ds[g]
        pos = g - ds._index.index((s, 0))
        if pos == 0:
            engine.reset(1, H, W)
        pkg = {k: v[0] for k, v in item.items()}
        single.append((g, pos, engine.step(pkg)))
    lanes = []
    inference.run_batched_streaming(ds, model, n_lanes=3,
                                    on_prediction=_collect(lanes))
    _check_same(lanes, single, *_tol(recipe), order=False)
    chunked_single, chunked_lanes = [], []
    inference.run_chunked_streaming(ds, model, chunk=3,
                                    on_prediction=_collect(chunked_single))
    inference.run_batched_chunked_streaming(
        ds, model, n_lanes=3, chunk=3, on_prediction=_collect(chunked_lanes))
    _check_same(chunked_lanes, chunked_single, *_tol(recipe), order=False)
    _check_same(chunked_lanes, single, *_tol(recipe), order=False)


def test_lane_engines_refuse_mesh_and_tolerate_empty():
    """A mesh whose model axis is above 1 (spatial partitioning, not
    ported) is refused; lanes over a data mesh are
    tests/test_torch_parallel.py's."""
    _, _, model = _models("flagship")
    ds = _Dataset((2,))
    spatial = make_mesh(MeshConfig(data=1, model=2),
                        [torch.device("cpu")] * 2)
    for fn in (inference.run_batched_streaming,
               inference.run_batched_chunked_streaming):
        with pytest.raises(NotImplementedError, match="item 15"):
            fn(ds, model, mesh=spatial)
        log = []
        fn(_Dataset(()), model, on_prediction=_collect(log))
        assert log == []
    with pytest.raises(NotImplementedError, match="item 15"):
        inference.BatchedStreamingInference(model, 2, H, W, mesh=spatial)


# ---------------------------------------------------------- the entry point

CLI_K, CLI_CROP = 2, (32, 64)
CLI_SPLIT = {"every_x_rgb_frame": CLI_K, "step_size": 1,
             "clip_distance": 80.0, "reg_factor": 3.70378}
CLI_CONFIG = {
    "name": "tiny_lanes", "arch": "ERGB2DepthRecurrent",
    "data_loader": {"train": dict(CLI_SPLIT), "validation": dict(CLI_SPLIT),
                    "batch_size": 1},
    "model": {"recurrent_block_type": "conv", "state_combination": "convgru",
              "num_encoders": 2, "base_num_channels": 8,
              "num_residual_blocks": 1, "norm": "none"}}


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def cli_jax_tree(tmp_path_factory):
    """Three sequences of unequal lengths (5, 3 and 4 packages), the config,
    a .pth.tar of seeded random weights, and the JAX test.py's tree of
    them with --lanes 2."""
    root = tmp_path_factory.mktemp("lanes_cli")
    for s, n in enumerate((5, 3, 4)):
        generate_eventscape_sequence(str(root / "data/test" / f"s{s}"),
                                     n_frames=CLI_K * n, height=40, width=70,
                                     events_per_frame=300, seed=s)
    (root / "config.json").write_text(json.dumps(CLI_CONFIG))
    cfg = Config.from_dict(CLI_CONFIG)
    model = ERGB2DepthRecurrent(cfg.model,
                                generator=torch.Generator().manual_seed(3))
    export_pth_tar(str(root / "model.pth.tar"), model, cfg.arch, CLI_CONFIG)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2",
           "PREPROCESSED_DATASETS_FOLDER": str(root / "data")}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "test.py"), *_cli_args(root),
         "--output_path", str(root / "out_jax"), "--lanes", "2"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, proc.stdout


def _cli_args(root):
    return ["--path_to_model", str(root / "model.pth.tar"), "--config",
            str(root / "config.json"), "--data_folder", "test", "--crop",
            ",".join(map(str, CLI_CROP))]


@pytest.mark.parametrize("extra", [(), ("--scan_chunk", "3")],
                         ids=["lanes2", "lanes2_chunk3"])
def test_eval_entry_lanes_matches_test_py(cli_jax_tree, extra, monkeypatch,
                                          capsys):
    """The port's entry with --lanes 2 (and --scan_chunk 3) writes the JAX
    test.py --lanes 2 tree, file for file, the saved arrays within 1e-5,
    and prints its scale and metric lines."""
    root, jax_stdout = cli_jax_tree
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(root / "data"))
    out = root / ("out_port_" + "_".join(extra or ("lanes",)))
    seen = []
    eval_main([*_cli_args(root), "--output_path", str(out), "--lanes", "2",
               "--device", "cpu", *extra],
              on_prediction=lambda g, p: seen.append(g))
    printed = capsys.readouterr().out
    for line in ("total scale: ", "min scale: ", "max scale: ",
                 "total metrics: "):
        assert line in printed and line in jax_stdout, line
    assert sorted(seen) == list(range(12)) and seen != sorted(seen)
    names = _tree(out)
    assert names == _tree(root / "out_jax")
    npys = [n for n in names if n.endswith(".npy")]
    # kept from each sequence's third package on: 3 + 1 + 2 items, each
    # with a prediction, a ground truth and a label per key
    assert len(npys) == (3 + 1 + 2) * 3 * (CLI_K + 1)
    for n in npys:
        np.testing.assert_allclose(np.load(out / n),
                                   np.load(root / "out_jax" / n),
                                   atol=ATOL_F32, err_msg=n)


def test_eval_entry_lanes_without_matplotlib(cli_jax_tree, monkeypatch):
    """Where matplotlib is absent (the card's machine) the entry still
    writes the tree's arrays and grey frames, the same arrays as the JAX
    test.py's, and no color map."""
    root, _ = cli_jax_tree
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(root / "data"))
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = root / "out_port_no_matplotlib"
    with pytest.warns(UserWarning, match="matplotlib"):
        eval_main([*_cli_args(root), "--output_path", str(out), "--lanes", "2",
                   "--scan_chunk", "2", "--device", "cpu"])
    names = _tree(out)
    want = _tree(root / "out_jax")
    assert not any("color_map" in n for n in names)
    assert set(names) == {n for n in want if "color_map" not in n
                          and not n.startswith(("video/predictions",
                                                "video/gt"))}
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_allclose(np.load(out / n),
                                       np.load(root / "out_jax" / n),
                                       atol=ATOL_F32, err_msg=n)

