"""The paper's recurrent baselines in the port against the JAX package.

The baselines are ERGB2DepthRecurrent with ``baseline`` set (the image
branch alone, its ConvGRU output feeding the next encoder): 'rgb', 'e'
(no event steps when loss_composition is a list, K-1 when it is the
string 'image'), 'ergb' and 'ergb0' (K-1 event steps of voxel grid and
previous frame), and a phased 'rgb' (phased ConvLSTM encoders, the ConvGRU
combination).  Both packages run one seeded port model's weights (crossed
into a JAX param tree) on numpy-seeded inputs at small size (2 encoders,
base 4, K=3, 16x32, B=2):

- ``event_loop_range``/``prediction_keys`` and what ``check_supported``
  accepts (the four shipped baseline configs, and on 'ergb0' each option
  of the model zoo, against JAX's first packages) and refuses (the
  ConvLSTM-combination baseline, on which the JAX reference itself
  raises);
- ``forward_package`` and ``forward_sequence_batched_decode``: every
  prediction and the final super states;
- the baseline packing of ``SynchronizedFramesEventsDataset`` on a tiny
  on-disk split, key for key;
- the first step's loss and every gradient (``make_sequence_loss``) for
  baseline 'e' as shipped (the in-scan decode path) and 'ergb0' with
  deferred decode;
- the eval entry point against ``test.py`` (output tree, saved maps) and
  the stream entry point against ``depth_stream.py`` on a baseline;
- ``.pth.tar`` round trips under ``statenetphasedrecurrent.``.

Float32 at ATOL_F32 = 2e-5 with rtol 1e-4 (tests/test_torch_model.py);
gradients at the JAX package's own training tolerance (atol 5e-5, rtol
1e-3, tests/test_torch_train.py).
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu import data as jdata
from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict as jax_to_sd
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.models import model as jmodel
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss

from rpg_ramnet_tpu_torch import data as tdata
from rpg_ramnet_tpu_torch import stream
from rpg_ramnet_tpu_torch.compat import load_reference_checkpoint, params_from_jax
from rpg_ramnet_tpu_torch.core.config import Config, ModelConfig
from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
from rpg_ramnet_tpu_torch.models import (ERGB2DepthRecurrent, build_model,
                                         event_loop_range, prediction_keys,
                                         statenet)
from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar, load_any
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss

from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_F32, RTOL_F32 = 2e-5, 1e-4
ATOL_GRAD, RTOL_GRAD = 5e-5, 1e-3
XLA_ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")
B, L, K, H, W = 2, 2, 3, 16, 32
SHIPPED = {n: os.path.join(REPO, "configs",
                           f"train_e2depth_si_grad_loss_statenet_{n}.json")
           for n in ("baseline_e", "baseline_rgb", "baseline_ergb",
                     "baseline_ergb_no_recurrent")}
BASE = dict(num_bins_events=5, skip_type="sum", num_encoders=2,
            base_num_channels=4, num_residual_blocks=1, norm="none",
            use_upsample_conv=True, every_x_rgb_frame=K,
            recurrent_block_type="conv", state_combination="convgru",
            loss_composition=["image"])
KINDS = {
    "rgb": dict(BASE, baseline="rgb", num_bins_rgb=1),
    "e": dict(BASE, baseline="e", num_bins_rgb=5),
    "e_image": dict(BASE, baseline="e", num_bins_rgb=5,
                    loss_composition="image"),
    "ergb": dict(BASE, baseline="ergb", num_bins_rgb=6),
    "ergb0": dict(BASE, baseline="ergb0", num_bins_rgb=6),
    "phased_rgb": dict(BASE, baseline="rgb", num_bins_rgb=1,
                       recurrent_block_type="convlstm", use_phased_arch=True,
                       spatial_resolution=[H, W]),
}


def _models(kind):
    """(JAX config, JAX params, port model) on one seeded model's
    weights."""
    d = KINDS[kind]
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d),
                                generator=torch.Generator().manual_seed(5))
    return jconfig.ModelConfig.from_dict(d), _jax_tree(model), model


def _sequence(kind, seed=0, n=L):
    """{'events': [B, n, K', H, W, Cin], 'image': [B, n, H, W, Cin]} and
    the phased timestamps, K' = event_loop_range, Cin = num_bins_rgb (a
    baseline's events take the image branch)."""
    cfg = ModelConfig.from_dict(KINDS[kind])
    loop, c = event_loop_range(cfg), cfg.num_bins_rgb
    rng = np.random.RandomState(seed)
    seq = {"events": rng.randn(B, n, loop, H, W, c if loop else 0
                               ).astype(np.float32),
           "image": rng.rand(B, n, H, W, c).astype(np.float32)}
    if cfg.use_phased_arch:
        t = np.cumsum(rng.uniform(0.005, 0.02, (B, n * (loop + 1))), 1)
        t = t.reshape(B, n, loop + 1).astype(np.float32)
        seq["times_events"], seq["times_image"] = t[..., :loop], t[..., loop]
    return seq


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL_F32,
                               rtol=RTOL_F32, err_msg=err_msg)


# -- configuration ----------------------------------------------------------


@pytest.mark.parametrize("baseline,lc,want", [
    (False, ["image"], K), ("rgb", ["image"], 0), ("ergb", ["image"], 0),
    ("ergb0", ["image"], K - 1), ("e", ["image"], 0), ("e", "image", K - 1),
    ("e", False, 0)])
def test_event_loop_range_matches_jax(baseline, lc, want):
    """JAX compares loss_composition with the string 'image': a list such
    as the shipped ["image"] gives baseline 'e' no event steps."""
    d = dict(BASE, baseline=baseline, loss_composition=lc)
    cfg, jcfg = ModelConfig.from_dict(d), jconfig.ModelConfig.from_dict(d)
    assert event_loop_range(cfg) == jmodel.event_loop_range(jcfg) == want
    assert prediction_keys(cfg) == jmodel.prediction_keys(jcfg)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_baseline_configs_parse_and_build(name):
    """The shipped configs: the model inherits baseline, every_x_rgb_frame
    and loss_composition as JAX's Config does, check_supported accepts
    them, and build_model gives the arch's class with the upstream
    prefix."""
    with open(SHIPPED[name]) as f:
        raw = json.load(f)
    cfg, jcfg = Config.from_dict(raw), jconfig.Config.from_dict(raw)
    for field in ("baseline", "every_x_rgb_frame", "num_bins_rgb"):
        assert getattr(cfg.model, field) == getattr(jcfg.model, field)
    assert list(cfg.model.loss_composition) == list(jcfg.model.loss_composition)
    assert cfg.arch == jcfg.arch
    if cfg.arch == "ERGB2Depth":
        assert prediction_keys(cfg.model) == ("image",)
    else:
        assert event_loop_range(cfg.model) == jmodel.event_loop_range(jcfg.model)
        statenet.check_supported(cfg.model)
    small = {**raw, "model": {**raw["model"], "base_num_channels": 4,
                              "num_encoders": 2}}
    model = build_model(Config.from_dict(small))
    assert type(model).__name__ == cfg.arch
    prefix = "unet." if cfg.arch == "ERGB2Depth" else "statenetphasedrecurrent."
    assert all(k.startswith(prefix) for k in model.state_dict())


OPTIONS = {
    "BN": dict(norm="BN"),
    "IN": dict(norm="IN"),
    "conv_combination": dict(state_combination="conv"),
    "sum_combination": dict(state_combination="sum"),
    "concat_skip": dict(skip_type="concat"),
    "no_skip": dict(skip_type="no_skip"),
    "transposed_decoder": dict(use_upsample_conv=False),
    "fast_upsample": dict(fast_upsample=True),
    "convlstm_encoders": dict(recurrent_block_type="convlstm"),
    "convlstm_baseline": dict(state_combination="convlstm"),
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_check_supported_refuses_the_rest_of_item_12(case):
    """Item 12's options on a baseline ('ergb0'): each builds and its
    first two packages match JAX's, predictions and super states (float32
    tolerance above).  The one refusal left is the ConvLSTM-combination
    baseline, on which the JAX reference raises (ROADMAP queue 3)."""
    d = dict(KINDS["ergb0"], **OPTIONS[case])
    cfg = ModelConfig.from_dict(d)
    if case == "convlstm_baseline":
        with pytest.raises(NotImplementedError,
                           match="JAX reference raises") as err:
            ERGB2DepthRecurrent(cfg)
        assert "queue 3" in str(err.value)
        return
    statenet.check_supported(cfg)
    model = ERGB2DepthRecurrent(cfg, generator=torch.Generator().manual_seed(5))
    jcfg, params = jconfig.ModelConfig.from_dict(d), _jax_tree(model)
    seq = _sequence("ergb0")
    jstate, state = JaxModel.init_state(jcfg, B, H, W), model.init_state(B, H, W)
    for t in range(L):
        pkg = {k: v[:, t] for k, v in seq.items()}
        jstate, jpreds = JaxModel.forward_package(
            params, jcfg, jstate, {k: jnp.asarray(v) for k, v in pkg.items()})
        with torch.no_grad():
            state, preds = model.forward_package(
                state, {k: torch.from_numpy(v) for k, v in pkg.items()})
        for k in jpreds:
            _close(preds[k].numpy(), jpreds[k], err_msg=f"{t} {k}")
    for got, want in zip(state.super_states, jstate.super_states):
        _close(got.numpy(), want)


def test_convlstm_baseline_raises_in_jax_too():
    """The ConvLSTM-combination baseline is refused because the JAX
    reference cannot run it: its one-tensor super state goes into the
    ConvLSTM cell as a (hidden, cell) pair."""
    d = dict(KINDS["rgb"], state_combination="convlstm")
    jcfg = jconfig.ModelConfig.from_dict(d)
    # zeros of the init's shapes: the init's compiles are not the point
    params = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda k: JaxModel.init_params(k, jcfg),
                       jax.random.PRNGKey(0)))
    state = JaxModel.init_state(jcfg, 3, H, W)
    with pytest.raises((TypeError, ValueError)):
        JaxModel.forward_package(params, jcfg, state, {
            "events": jnp.zeros((3, 0, H, W, 0)),
            "image": jnp.ones((3, H, W, 1))})
    with pytest.raises(NotImplementedError, match="queue 3"):
        statenet.check_supported(ModelConfig.from_dict(d))


# -- the model --------------------------------------------------------------


def test_params_cross_both_ways():
    """A baseline's parameters: the JAX init's tree (no event branch) and
    shapes, and the JAX package's own state-dict names, which load into
    the port with strict=True."""
    for kind in ("ergb0", "phased_rgb"):
        jcfg, params, model = _models(kind)
        ref = jax.eval_shape(lambda k: JaxModel.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
        assert (jax.tree_util.tree_structure(params)
                == jax.tree_util.tree_structure(ref))
        assert set(jax_to_sd(params)) == set(model.state_dict())
        assert not any("events" in k for k in model.state_dict())
        other = ERGB2DepthRecurrent(model.cfg)
        params_from_jax(other, params)
        for a, b in zip(model.state_dict().values(),
                        other.state_dict().values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_package_matches_jax(kind):
    """Two packages, the state carried: every prediction key and the final
    super states."""
    jcfg, params, model = _models(kind)
    seq = _sequence(kind)
    keys = prediction_keys(model.cfg)
    fwd = jax.jit(lambda p, s, pkg: JaxModel.forward_package(p, jcfg, s, pkg))
    jstate = JaxModel.init_state(jcfg, B, H, W)
    state = model.init_state(B, H, W)
    with torch.no_grad():
        for t in range(L):
            pkg = {k: v[:, t] for k, v in seq.items()}
            jstate, jpreds = fwd(params, jstate, {k: jnp.asarray(v)
                                                  for k, v in pkg.items()})
            state, preds = model.forward_package(
                state, {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in pkg.items()})
            assert tuple(preds) == keys and set(jpreds) == set(keys)
            for k in keys:
                assert preds[k].shape == (B, H, W, 1)
                _close(preds[k].numpy(), jpreds[k], f"{kind} t={t} {k}")
    for s, js in zip(state.super_states, jstate.super_states):
        assert isinstance(s, torch.Tensor)
        _close(s.numpy(), js, f"{kind} super state")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_decode_matches_jax(kind):
    """forward_sequence_batched_decode (the training and chunked route of a
    baseline) against JAX's, and forward_package_batched_decode against
    the port's forward_package."""
    jcfg, params, model = _models(kind)
    seq = _sequence(kind, seed=1)
    jstate, jpreds = jax.jit(
        lambda p, s, q: JaxModel.forward_sequence_batched_decode(
            p, jcfg, s, q))(params, JaxModel.init_state(jcfg, B, H, W),
                            {k: jnp.asarray(v) for k, v in seq.items()})
    tseq = {k: torch.from_numpy(v) for k, v in seq.items()}
    with torch.no_grad():
        state, preds = model.forward_sequence_batched_decode(
            model.init_state(B, H, W), tseq)
        pstate, ppreds = model.forward_package_batched_decode(
            model.init_state(B, H, W), {k: v[:, 0] for k, v in tseq.items()})
        _, want = model.forward_package(
            model.init_state(B, H, W), {k: v[:, 0] for k, v in tseq.items()})
    assert set(preds) == set(jpreds) == set(prediction_keys(model.cfg))
    for k in preds:
        assert preds[k].shape == (L, B, H, W, 1)
        _close(preds[k].numpy(), jpreds[k], f"{kind} {k}")
        torch.testing.assert_close(ppreds[k], want[k], atol=1e-6, rtol=0)
    for s, js in zip(state.super_states, jstate.super_states):
        _close(s.numpy(), js, f"{kind} super state")


def test_precomputed_paths_refuse_baselines():
    """forward_sequence_precomputed and package_precompute raise JAX's
    ValueError for a baseline (model.py:372-375, :426-429)."""
    _, _, model = _models("ergb0")
    tseq = {k: torch.from_numpy(v) for k, v in _sequence("ergb0").items()}
    assert not statenet.supports_x_precompute(model.cfg)
    with pytest.raises(ValueError, match="non-baseline"):
        model.forward_sequence_precomputed(model.init_state(B, H, W), tseq)
    with pytest.raises(ValueError, match="non-baseline"):
        model.forward_sequence_batched_decode(model.init_state(B, H, W), tseq,
                                              package_precompute=True)


# -- the dataset ------------------------------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline_split")
    jdata.synthetic.generate_split(str(root), seed=4, n_sequences=1,
                                   n_frames=12, height=30, width=28,
                                   events_per_frame=400)
    return str(root)


PACKINGS = {"rgb": ("rgb", ["image"]), "e": ("e", ["image"]),
            "e_image": ("e", "image"), "ergb": ("ergb", ["image"]),
            "ergb0": ("ergb0", ["image"]), "phased_ergb0": ("ergb0", ["image"])}


@pytest.mark.parametrize("case", sorted(PACKINGS))
def test_baseline_packing_matches_jax(split, case):
    """Every package of a sequence (the first, whose ergb0 frame is the
    zero frame, included), with a random crop and flip, the semantic
    labels, and in one case the phased timestamps: the same keys in the
    same order and the same arrays."""
    baseline, lc = PACKINGS[case]
    items = []
    for lib in (tdata, jdata):
        transform = lib.Compose([lib.RandomRotationFlip(0.0, 0.5, 0.0),
                                 lib.RandomCrop(24)])
        ds = lib.SynchronizedFramesEventsDataset(
            base_folder=os.path.join(split, "seq00"),
            event_folder="events/voxels", depth_folder="depth/data",
            frame_folder="rgb/data", semantic_folder="semantic/data",
            clip_distance=80.0, every_x_rgb_frame=K, transform=transform,
            reg_factor=3.70378, load_semantic=True, baseline=baseline,
            loss_composition=lc, use_phased_arch=case.startswith("phased"))
        items.append([ds.__getitem__(i, seed=11 + i)
                      for i in range(ds.num_packages())])
    loop = event_loop_range(ModelConfig.from_dict(
        dict(BASE, baseline=baseline, loss_composition=lc)))
    for t_item, j_item in zip(*items):
        assert list(t_item) == list(j_item)
        assert t_item["events"].shape[0] == loop
        for k in t_item:
            np.testing.assert_array_equal(t_item[k], j_item[k], err_msg=k)
    if baseline == "ergb0":
        assert not items[0][0]["events"][..., -1].any()   # the zero frame
        assert items[0][1]["events"][..., -1].any()


# -- training ---------------------------------------------------------------


def _train_raw(kind, deferred):
    d = {k: v for k, v in KINDS[kind].items()
         if k not in ("every_x_rgb_frame", "baseline", "loss_composition")}
    split = {"every_x_rgb_frame": K, "baseline": KINDS[kind]["baseline"],
             "clip_distance": 80.0, "reg_factor": 3.70378}
    return {"name": "tiny", "arch": "ERGB2DepthRecurrent",
            "data_loader": {"train": split, "batch_size": B},
            "loss": {"type": "scale_invariant_loss",
                     "config": {"weight": 1.0, "n_lambda": 1.0}},
            "grad_loss": {"weight": 0.25},
            "trainer": {"sequence_length": L, "loss_composition": ["image"],
                        "loss_weights": [1], "deferred_decode": deferred},
            "model": d}


def _train_batch(cfg, seed=0):
    loop, c = event_loop_range(cfg.model), cfg.model.num_bins_rgb
    rng = np.random.RandomState(seed)
    return {"events": rng.randn(B, L, loop, H, W, c if loop else 0
                                ).astype(np.float32),
            "image": rng.rand(B, L, H, W, c).astype(np.float32),
            "depth_events": rng.rand(B, L, loop, H, W, 1).astype(np.float32),
            "depth_image": rng.rand(B, L, H, W, 1).astype(np.float32)}


@pytest.mark.parametrize("kind,deferred", [("e", False), ("ergb0", True)],
                         ids=["e_in_scan", "ergb0_deferred"])
def test_first_step_loss_and_every_gradient_match_jax(kind, deferred):
    """The loss terms and every parameter gradient of one window, each
    package checkpointed: baseline 'e' as shipped (no deferred_decode: the
    in-scan decode path, a decode per package) and 'ergb0' with deferred
    decode; the port's in-scan path against its deferred one:
    test_in_scan_decode_equals_deferred_decode."""
    raw = _train_raw(kind, deferred)
    cfg, jcfg = Config.from_dict(raw), jconfig.Config.from_dict(raw)
    model = ERGB2DepthRecurrent(cfg.model,
                                generator=torch.Generator().manual_seed(2))
    params = _jax_tree(model)
    batch = _train_batch(cfg)
    # JAX without remat (its compile is the test's cost; remat changes no
    # value), the port with each package checkpointed
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        jax_loss(jcfg, remat=False), has_aux=True)(
        params, JaxModel.init_state(jcfg.model, B, H, W),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, H, W),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(aux) == set(j_aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]),
                                   rtol=RTOL_F32, err_msg=k)
    want = jax_to_sd(j_grads)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=ATOL_GRAD, rtol=RTOL_GRAD,
                                   err_msg=name)


def test_in_scan_decode_equals_deferred_decode():
    """The two training routes of a window give one loss and one gradient:
    decodes never feed the state."""
    grads, losses = [], []
    for deferred in (False, True):
        cfg = Config.from_dict(_train_raw("ergb0", deferred))
        model = ERGB2DepthRecurrent(cfg.model,
                                    generator=torch.Generator().manual_seed(2))
        loss, _ = make_sequence_loss(cfg, remat=True)(
            model, model.init_state(B, H, W),
            {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()})
        loss.backward()
        losses.append(loss.item())
        grads.append([p.grad for p in model.parameters()])
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# -- checkpoints ------------------------------------------------------------


def test_pth_tar_round_trip_under_statenet_prefix(tmp_path):
    """A baseline's .pth.tar: the JAX tree's reference names load with
    strict=True, export and reload (load_reference_checkpoint, load_any)
    give the same weights, and the file's names are upstream's."""
    jcfg, params, model = _models("ergb0")
    ref = {k: torch.from_numpy(np.array(v, np.float32))
           for k, v in jax_to_sd(params).items()}
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": ref, "arch": "ERGB2DepthRecurrent"}, path)
    fresh = ERGB2DepthRecurrent(model.cfg,
                                generator=torch.Generator().manual_seed(9))
    load_reference_checkpoint(fresh, path)
    out = str(tmp_path / "out.pth.tar")
    export_pth_tar(out, fresh, "ERGB2DepthRecurrent", {})
    again = ERGB2DepthRecurrent(model.cfg,
                                generator=torch.Generator().manual_seed(10))
    load_any(out, again)
    sd = torch.load(out, map_location="cpu", weights_only=False)["state_dict"]
    assert set(sd) == set(ref)
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, ref[k], atol=0, rtol=0)


# -- the entry points -------------------------------------------------------


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A synthetic test split, the shipped ergb0 and e configs shrunk to
    base 4, 2 encoders, K=3, and a .pth.tar of seeded weights each."""
    root = tmp_path_factory.mktemp("baseline_cli")
    tdata.generate_split(str(root / "data/test"), n_sequences=2, n_frames=12,
                         height=20, width=36, events_per_frame=300)
    out = {}
    for name in ("baseline_ergb", "baseline_e"):
        with open(SHIPPED[name]) as f:
            raw = json.load(f)
        raw = copy.deepcopy(raw)
        raw["model"].update(base_num_channels=4, num_encoders=2,
                            num_residual_blocks=1)
        for s in ("train", "validation"):
            raw["data_loader"][s]["every_x_rgb_frame"] = K
        (root / f"{name}.json").write_text(json.dumps(raw))
        cfg = Config.from_dict(raw)
        model = build_model(cfg, generator=torch.Generator().manual_seed(3))
        export_pth_tar(str(root / f"{name}.pth.tar"), model, cfg.arch, raw)
        out[name] = model
    return root, out


def _env(root):
    """The JAX CLIs' environment: one thread each (the suite runs several
    test processes at once)."""
    return {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1", "XLA_FLAGS": XLA_ONE_THREAD,
            "PREPROCESSED_DATASETS_FOLDER": str(root / "data")}


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def ergb0_trees(cli):
    """The ergb0 baseline's output trees: test.py's (out_jax) and the
    port's eval entry point's (out_port), and the port's predictions
    by item for the per-package, --scan_chunk 3 and --lanes 2 runs."""
    root, _ = cli
    args = ["--path_to_model", str(root / "baseline_ergb.pth.tar"),
            "--config", str(root / "baseline_ergb.json"), "--data_folder",
            "test", "--crop", "16,32"]
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "test.py"), *args,
         "--output_path", str(root / "out_jax")],
        cwd=root, env=_env(root), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    old = os.environ.get("PREPROCESSED_DATASETS_FOLDER")
    os.environ["PREPROCESSED_DATASETS_FOLDER"] = str(root / "data")
    runs = {}
    try:
        for extra in ((), ("--scan_chunk", "3"), ("--lanes", "2")):
            got = {}
            out = (["--output_path", str(root / "out_port")]
                   if not extra else [])
            eval_main([*args, *out, *extra, "--device", "cpu"],
                      on_prediction=got.__setitem__)
            runs[extra] = got
    finally:
        if old is None:
            del os.environ["PREPROCESSED_DATASETS_FOLDER"]
        else:
            os.environ["PREPROCESSED_DATASETS_FOLDER"] = old
    return root, runs


def test_eval_entry_point_matches_test_py(ergb0_trees):
    """The ergb0 baseline through test.py and the port's eval entry point:
    the same output tree (events0..K-2 and image maps), the saved maps
    within ATOL_F32; --scan_chunk and --lanes 2 give the per-package
    maps."""
    root, runs = ergb0_trees
    names = _tree(root / "out_port")
    assert names == _tree(root / "out_jax")
    assert any("events1" in n for n in names)
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_allclose(np.load(root / "out_port" / n),
                                       np.load(root / "out_jax" / n),
                                       atol=ATOL_F32, rtol=RTOL_F32, err_msg=n)
    base = runs[()]
    assert len(base) == 8 and set(base[0]) == {"events0", "events1", "image"}
    for extra, got in runs.items():
        assert sorted(got) == sorted(base)
        for i in base:
            for k in base[i]:
                np.testing.assert_allclose(got[i][k], base[i][k], atol=1e-5,
                                           err_msg=f"{extra} {i} {k}")


@pytest.mark.parametrize("key", ["image", "events0", "events1"])
def test_evaluation_reads_baseline_maps(ergb0_trees, key):
    """The offline evaluation entry on the port's tree of a baseline (an
    ergb0 run writes events0..K-2 and image maps): the metrics of the JAX
    package's evaluation on test.py's tree."""
    from rpg_ramnet_tpu.eval import evaluation as jevaluation
    from rpg_ramnet_tpu_torch.eval import evaluation
    root, _ = ergb0_trees
    kw = dict(clip_distance=80.0, reg_factor=3.70378)
    got = evaluation.main([
        "--target_dataset", str(root / f"out_port/ground_truth/npy/depth_{key}"),
        "--predictions_dataset", str(root / f"out_port/npy/{key}"),
        "--clip_distance", "80", "--reg_factor", "3.70378"])
    want = jevaluation.evaluate_directories(
        str(root / f"out_jax/ground_truth/npy/depth_{key}"),
        str(root / f"out_jax/npy/{key}"), **kw)
    assert list(got) == list(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert np.isfinite(got["_abs_rel_diff"])


def test_stream_entry_point_matches_depth_stream(cli):
    """Baseline 'e' on the live path: each window's grid through the image
    branch, as depth_stream.py; the rgb baseline, whose image branch takes
    one channel, is refused."""
    root, _ = cli
    h, w = 14, 30
    rng = np.random.RandomState(0)
    n = 3 * int(h * w * 0.35) + 50
    t = np.sort(rng.uniform(100.0, 100.5, n))
    with open(root / "events.txt", "w") as f:
        f.write(f"{w} {h}\n")
        for row in zip(t, rng.randint(0, w, n), rng.randint(0, h, n),
                       rng.randint(0, 2, n)):
            f.write("%.9f %d %d %d\n" % row)
    args = ["-i", str(root / "events.txt"), "--path_to_model",
            str(root / "baseline_e.pth.tar"), "--config",
            str(root / "baseline_e.json"), "--height", str(h), "--width",
            str(w), "--save_numpy"]
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "depth_stream.py"), *args,
         "-o", str(root / "stream_jax")],
        cwd=root, env=_env(root), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    depths = {}
    windows = stream.main(args + ["-o", str(root / "stream_port"),
                                  "--device", "cpu"],
                          on_window=depths.__setitem__)
    assert windows == len(depths) == 4
    names = [n for n in _tree(root / "stream_port") if n.endswith(".npy")]
    assert names == [n for n in _tree(root / "stream_jax")
                     if n.endswith(".npy")] and len(names) == windows
    for n in names:
        np.testing.assert_allclose(np.load(root / "stream_port" / n),
                                   np.load(root / "stream_jax" / n),
                                   atol=ATOL_F32, rtol=RTOL_F32, err_msg=n)
    rgb = json.loads((root / "baseline_e.json").read_text())
    rgb["model"]["num_bins_rgb"] = 1
    (root / "rgb.json").write_text(json.dumps(rgb))
    with pytest.raises(ValueError, match="num_bins_events"):
        stream.main(["-i", str(root / "events.txt"), "--path_to_model",
                     str(root / "baseline_e.pth.tar"), "--config",
                     str(root / "rgb.json"), "--device", "cpu"])
