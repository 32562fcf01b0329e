"""Training the model zoo's options in the port against the JAX package.

The tiny config of tests/test_train.py (2 encoders, base 4, B=2, L=2,
16x16, float32) with K=2, one seeded port model crossed into a JAX param tree:

- one window's loss, every parameter gradient and the window's final
  running stats with training-mode BN and IN (JAX ``make_sequence_loss``,
  sequence_loss.py:124-173), with remat on and off: the port's stats
  equal the remat-off run's bit for bit (the checkpoint's recompute does
  not update them again) and JAX's;
- remat_chunk 2, the phased encoders' eval-mode norms in training, the
  UNet's training-mode norms (one update over the window);
- one Adam step under grad_accum 2 against JAX ``make_train_step``: the
  loss, the parameters and the running stats written back (the average of
  the micro-batches' final stats);
- the deferred-decode and precompute_x fallbacks with JAX's warnings, and
  the eval step's eval-mode norms;
- a BN model's ``.pth.tar``: JAX's names, a reference file loading with
  and without ``num_batches_tracked``, resume restoring the buffers bit
  for bit.

Losses at rtol 1e-5, gradients at the JAX package's training tolerance
(atol 5e-5, rtol 1e-3, tests/test_torch_train.py), running stats at atol
1e-6, parameters after one Adam step at 2 lr (an element whose gradient is
float noise in both can move by lr either way, tests/test_torch_train.py).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict as jax_to_sd
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import ERGB2Depth as JaxUNet
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss
from rpg_ramnet_tpu.train.train_step import make_train_step as jax_train_step

from rpg_ramnet_tpu_torch.compat import load_reference_checkpoint
from rpg_ramnet_tpu_torch.core import config as tconfig
from rpg_ramnet_tpu_torch.models import build_model
from rpg_ramnet_tpu_torch.models.layers import extract_norm_stats
from rpg_ramnet_tpu_torch.train import checkpoint
from rpg_ramnet_tpu_torch.train.optim import make_optimizer
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
from rpg_ramnet_tpu_torch.train.train_step import (make_eval_step,
                                                   make_train_step)

from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from test_train import tiny_config
from torch_threads import one_thread  # noqa: F401

ATOL_GRAD, RTOL_GRAD = 5e-5, 1e-3
ATOL_STATS = 1e-6
LR = 3e-4
B, L, K, H, W = 2, 2, 2, 16, 16
NORMED = {
    "BN": dict(norm="BN", skip_type="concat", use_upsample_conv=False),
    "IN": dict(norm="IN", recurrent_block_type="convlstm",
               skip_type="no_skip", fast_upsample=True),
}


def _raw(trainer=None, **model_over):
    """tiny_config with K=2 event steps and the trainer's overrides."""
    raw = tiny_config(**model_over).raw
    loader = raw["data_loader"]
    return {**raw, "data_loader": {**loader, "train": {
                **loader["train"], "every_x_rgb_frame": K}},
            "trainer": {**raw["trainer"], "loss_composition":
                        ["image", "events1"], **(trainer or {})}}


def _batch(seed=0, c_image=1, c_events=5, k=K):
    rng = np.random.RandomState(seed)
    return {"events": rng.randn(B, L, k, H, W, c_events).astype(np.float32),
            "image": rng.rand(B, L, H, W, c_image).astype(np.float32),
            "depth_events": rng.rand(B, L, k, H, W, 1).astype(np.float32),
            "depth_image": rng.rand(B, L, H, W, 1).astype(np.float32)}


def _models(raw, seed=2):
    jcfg, cfg = jconfig.Config.from_dict(raw), tconfig.Config.from_dict(raw)
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    return jcfg, cfg, model, _jax_tree(model)


def _jax_window(jcfg, params, batch, training=True, grad=True):
    """JAX's loss (remat off: the same values, a cheaper trace), with its
    gradients when ``grad``."""
    model = JaxModel if jcfg.arch == "ERGB2DepthRecurrent" else JaxUNet
    state0 = (model.init_state(jcfg.model, B, H, W)
              if jcfg.arch == "ERGB2DepthRecurrent" else ())
    fn = jax_loss(jcfg, remat=False, training=training)
    if grad:
        fn = jax.value_and_grad(fn, has_aux=True)
    return fn(params, state0, {k: jnp.asarray(v) for k, v in batch.items()})


def _stats_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(
                got[k][name].numpy(), np.asarray(want[k][name]),
                atol=ATOL_STATS, rtol=0, err_msg=f"{k}.{name}")


def _grads_close(model, j_grads, arch="ERGB2DepthRecurrent"):
    """Every gradient; a parameter with none (the scale-0 combination
    under no_skip: its state reaches no decoder) has JAX's zeros."""
    want = jax_to_sd(j_grads, arch)
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]),
                                   atol=ATOL_GRAD, rtol=RTOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("norm", sorted(NORMED))
def test_first_window_loss_gradients_and_stats_match_jax(norm):
    """Training-mode norms: batch statistics in the forward, the running
    stats carried through the window (the event encoders' K calls per
    package each move them).  Under remat every package runs its forward
    twice; the stats come out of the first run only, so they equal the
    remat-off run's bit for bit, and JAX's."""
    jcfg, cfg, model, params = _models(_raw(**NORMED[norm]))
    batch = _batch()
    (j_loss, j_aux), j_grads = _jax_window(jcfg, params, batch)
    out = {}
    for remat in (True, False):
        model.zero_grad()
        loss, aux = make_sequence_loss(cfg, remat=remat)(
            model, model.init_state(B, H, W),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
        _grads_close(model, j_grads)
        _stats_close(aux["norm_stats"], j_aux["norm_stats"])
        out[remat] = aux["norm_stats"]
    for k in out[True]:
        for name in ("running_mean", "running_var"):
            assert torch.equal(out[True][k][name], out[False][k][name])
    # the buffers are untouched by the loss: the train step writes them
    for k, s in extract_norm_stats(model).items():
        assert torch.equal(s["running_var"], torch.ones_like(s["running_var"]))


def test_remat_chunk_and_the_phased_encoders_eval_norms_match_jax():
    """remat_chunk 2 checkpoints both packages as one group; the phased
    encoders' norms stay in eval mode while the decoder's train (JAX
    passes the phased layers no ctx), so their stats are not in the
    window's output."""
    raw = _raw({"remat_chunk": 2}, norm="BN", recurrent_block_type="convlstm",
               state_combination="convlstm", spatial_resolution=[H, W])
    raw = {**raw, "use_phased_arch": True,
           "model": {**raw["model"], "use_phased_arch": True}}
    jcfg, cfg, model, params = _models(raw)
    batch = _batch(1)
    t = np.cumsum(np.random.RandomState(2).uniform(0.01, 0.02,
                                                  (B, L * (K + 1))), 1)
    t = t.reshape(B, L, K + 1).astype(np.float32)
    batch["times_events"], batch["times_image"] = t[..., :K], t[..., K]
    (j_loss, j_aux), j_grads = _jax_window(jcfg, params, batch)
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, H, W),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _grads_close(model, j_grads)
    # JAX carries every norm's stats, the phased ones unchanged
    enc = {k for k in j_aux["norm_stats"] if k.startswith("encoders_")}
    assert enc
    for k in enc:
        assert k not in aux["norm_stats"] or torch.equal(
            aux["norm_stats"][k]["running_mean"],
            extract_norm_stats(model)[k]["running_mean"])
    _stats_close({k: v for k, v in aux["norm_stats"].items() if k not in enc},
                 {k: v for k, v in j_aux["norm_stats"].items()
                  if k not in enc})


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_unet_training_mode_norms_match_jax(norm):
    """ERGB2Depth folds the window into the batch: one update of each
    norm's stats over the L*B maps (JAX model.py:710-745)."""
    raw = _raw(norm=norm, skip_type="concat", baseline="ergb", num_bins_rgb=6)
    raw = {**raw, "arch": "ERGB2Depth"}
    jcfg, cfg, model, params = _models(raw)
    batch = _batch(3, c_image=6, c_events=0, k=0)
    (j_loss, j_aux), j_grads = _jax_window(jcfg, params, batch)
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, H, W),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    _grads_close(model, j_grads, "ERGB2Depth")
    _stats_close(aux["norm_stats"], j_aux["norm_stats"])


def test_adam_step_under_grad_accum_matches_jax_train_step():
    """grad_accum 2: each micro-batch starts from the same stats, and the
    stats written back are the average of the two micro-batches' final
    stats (JAX averages its aux), not two updates in a row."""
    raw = _raw({"grad_accum": 2, "remat": True}, **NORMED["BN"])
    jcfg, cfg, model, params = _models(raw)
    jopt = jax_make_optimizer(jcfg)
    batch = _batch(4)
    new_params, _, j_aux = jax_train_step(jcfg, jopt, donate=False)(
        params, jopt.init(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    start = {k: {n: v.clone() for n, v in s.items()}
             for k, s in extract_norm_stats(model).items()}
    aux = make_train_step(cfg, model, make_optimizer(cfg, model.parameters()))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(aux["loss"], float(j_aux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(aux["grad_norm"], float(j_aux["grad_norm"]),
                               rtol=1e-3)
    want = jax_to_sd(new_params)
    for name, t in model.state_dict().items():
        atol = ATOL_STATS if ".running_" in name else 2 * LR
        np.testing.assert_allclose(t.numpy(), np.asarray(want[name]),
                                   atol=atol, rtol=0, err_msg=name)
    # not the stats of two updates in a row
    stats = extract_norm_stats(model)
    key = sorted(stats)[0]
    assert not torch.equal(stats[key]["running_mean"],
                           start[key]["running_mean"])


def test_deferred_decode_and_precompute_give_way_with_jax_warnings():
    """Training-mode norms need the per-step statistics: deferred_decode
    gives way to the in-scan path and precompute_x is ignored, each with
    JAX's warning, and the loss is the in-scan one."""
    raw = _raw({"deferred_decode": True, "precompute_x": True},
               **NORMED["BN"])
    jcfg, cfg, model, params = _models(raw)
    with pytest.warns(UserWarning) as rec:
        loss_fn = make_sequence_loss(cfg, remat=False)
    msgs = [str(r.message) for r in rec]
    assert any("deferred_decode is incompatible with training-mode" in m
               for m in msgs)
    assert any("precompute_x requires" in m for m in msgs)
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        jax_loss(jcfg)
    assert sorted(str(r.message) for r in jrec) == sorted(msgs)
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    loss, aux = loss_fn(model, model.init_state(B, H, W), batch)
    in_scan = make_sequence_loss(tconfig.Config.from_dict(_raw(
        **NORMED["BN"])))
    want, want_aux = in_scan(model, model.init_state(B, H, W), batch)
    assert loss.item() == want.item()
    _stats_close(aux["norm_stats"], want_aux["norm_stats"])


def test_eval_step_runs_the_norms_in_eval_mode():
    jcfg, cfg, model, params = _models(_raw(**NORMED["IN"]))
    with torch.no_grad():
        for s in extract_norm_stats(model).values():
            s["running_mean"].uniform_(-0.5, 0.5)
    params = _jax_tree(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(6)
    j_loss, j_aux = _jax_window(jcfg, params, batch, training=False,
                                grad=False)
    aux = make_eval_step(cfg, model)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert "norm_stats" not in j_aux and "norm_stats" not in aux
    np.testing.assert_allclose(aux["loss"], float(j_loss), rtol=1e-5)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- checkpoints --------------------------------------------------------------


def _bn_model():
    raw = _raw(**NORMED["BN"])
    cfg = tconfig.Config.from_dict(raw)
    model = build_model(cfg, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for s in extract_norm_stats(model).values():
            s["running_mean"].uniform_(-1, 1)
            s["running_var"].uniform_(0.5, 1.5)
    return raw, cfg, model


def test_pth_tar_export_carries_the_stats_under_jax_names(tmp_path):
    raw, cfg, model = _bn_model()
    jcfg = jconfig.Config.from_dict(raw)
    ref = jax.eval_shape(lambda k: JaxModel.init_params(k, jcfg.model),
                         jax.random.PRNGKey(0))
    path = str(tmp_path / "m.pth.tar")
    checkpoint.export_pth_tar(path, model, cfg.arch, raw)
    sd = torch.load(path, weights_only=False)["state_dict"]
    assert set(sd) == set(jax_to_sd(ref))
    assert any(k.endswith("norm_layer.running_var") for k in sd)
    assert any(k.endswith("bn1.running_mean") for k in sd)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("tracked", [False, True],
                         ids=["jax_names", "with_num_batches_tracked"])
def test_reference_checkpoint_loads_strictly(tmp_path, tracked):
    """A reference .pth.tar of a BN model loads with strict=True whether
    or not it has torch's num_batches_tracked (upstream's BatchNorm2d
    writes it; the port's norms have no such buffer)."""
    raw, cfg, model = _bn_model()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if tracked:
        for k in list(sd):
            if k.endswith(".running_mean"):
                sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.tensor(7)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"arch": cfg.arch, "state_dict": sd}, path)
    fresh = build_model(cfg, generator=torch.Generator().manual_seed(9))
    load_reference_checkpoint(fresh, path)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_resume_restores_the_buffers_bitwise(tmp_path):
    raw, cfg, model = _bn_model()
    opt = make_optimizer(cfg, model.parameters())
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"))
    path = mgr.save("checkpoint-epoch0", model, opt, epoch=0,
                    monitor_best=1.0, config=raw)
    fresh = build_model(cfg, generator=torch.Generator().manual_seed(9))
    checkpoint.restore(path, fresh, make_optimizer(cfg, fresh.parameters()))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
