"""The port's training path against the JAX package's.

The tiny config of tests/test_train.py (2 encoders, base 4, K=3, B=2,
L=2, 16x16, float32): the sequence loss and every parameter gradient
against JAX ``make_sequence_loss`` at the tolerance of the JAX package's
own fused-vs-unfused check (tests/test_train.py:471: atol 5e-5, rtol
1e-3), with precompute_x and the fused cell (the JAX Pallas kernels in
interpret mode, the port's ConvGRUHside on its plain versions) and
without; three Adam steps against the JAX train step; the configuration
defaults; the float32 masters under a bf16 config; training-mode BN/IN
building; and the refusal that remains (an unknown optimizer).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside
from rpg_ramnet_tpu.train.optim import lr_at_epoch as jax_lr_at_epoch
from rpg_ramnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss
from rpg_ramnet_tpu.train.train_step import make_train_step as jax_train_step

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core import config as tconfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.train.optim import lr_at_epoch, make_optimizer
from rpg_ramnet_tpu_torch.train.sequence_loss import (make_sequence_loss,
                                                      supervised_keys)
from rpg_ramnet_tpu_torch.train.train_step import make_train_step

from test_train import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, K, H, W = 2, 2, 3, 16, 16


def _raw(precompute_x=True, **model_over):
    raw = tiny_config(**model_over).raw
    return {**raw, "trainer": {**raw["trainer"], "deferred_decode": True,
                               "precompute_x": precompute_x}}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"events": rng.randn(B, L, K, H, W, 5).astype(np.float32),
            "image": rng.rand(B, L, H, W, 1).astype(np.float32),
            "depth_events": rng.rand(B, L, K, H, W, 1).astype(np.float32),
            "depth_image": rng.rand(B, L, H, W, 1).astype(np.float32)}


def _models(raw):
    jcfg = jconfig.Config.from_dict(raw)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg.model)
    cfg = tconfig.Config.from_dict(raw)
    model = ERGB2DepthRecurrent(cfg.model)
    params_from_jax(model, params)
    return jcfg, params, cfg, model


def _admit_f32(monkeypatch):
    """Let both packages take their fused cells for float32 states of the
    tiny shapes, as tests/test_train.py:430-438 does for JAX: the JAX
    kernels in interpret mode, the port's Function on its plain versions
    (counted, so the test sees that they ran)."""
    real_pick = jax_gru_hside._pick_tile_h

    def fake_supports(prev_state, lstm=False):
        _, h, w, c = prev_state.shape
        budget = 256 * 1024 if lstm else 512 * 1024
        return (real_pick(h, w, c, 4, budget=budget) > 0
                and w % 8 == 0 and c % 8 == 0)

    monkeypatch.setattr(jax_gru_hside, "supports", fake_supports)
    monkeypatch.setattr(jax_gru_hside, "_INTERPRET", True)
    monkeypatch.setattr(gru_hside, "supports",
                        lambda h: h.dim() == 4 and h.shape[-1] % 8 == 0)
    calls = {"res": 0, "bwd": 0}
    for name, key in (("conv_gru_hside_res_plain", "res"),
                      ("conv_gru_hside_bwd_plain", "bwd")):
        real = getattr(gru_hside, name)

        def counted(*args, _real=real, _key=key):
            calls[_key] += 1
            return _real(*args)

        monkeypatch.setattr(gru_hside, name, counted)
    return calls


@pytest.mark.parametrize("precompute_x", [True, False],
                         ids=["precompute_x_fused", "full_cell"])
def test_sequence_loss_and_every_gradient_match_jax(monkeypatch,
                                                    precompute_x):
    calls = _admit_f32(monkeypatch)
    raw = _raw(precompute_x)
    if precompute_x:
        raw = {**raw, "model": {**raw["model"], "fused_gru": "on"}}
    jcfg, params, cfg, model = _models(raw)
    # the port's 'on' needs CUDA; 'auto' takes the Function on the CPU
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fused_gru="auto"))
    model.cfg = cfg.model
    batch = _batch()
    (j_loss, j_aux), j_grads = jax.value_and_grad(
        jax_loss(jcfg, remat=True), has_aux=True)(
        params, JaxModel.init_state(jcfg.model, B, H, W),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, H, W),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(aux) == set(j_aux)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=1e-4)
    want = params_to_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=5e-5, rtol=1e-3, err_msg=name)
    # with precompute_x every h-side cell ran the Function: 2 scales x
    # (K+1) steps x L packages, its forward twice (checkpoint recompute)
    cells = 2 * (K + 1) * L
    assert calls == ({"res": 2 * cells, "bwd": cells} if precompute_x
                     else {"res": 0, "bwd": 0})


def test_three_adam_steps_match_jax():
    """Parameters after three Adam steps (lr 3e-4) on three windows.  Adam
    normalizes each element's update, so an element whose gradient is
    float noise in both (|g| ~ 1e-9) can move by up to lr per step in
    either direction: the bound is 3 steps x 2 x lr = 1.8e-3 per element,
    and all but a few elements agree far more closely (1e-6)."""
    raw = _raw(precompute_x=True)
    jcfg, params, cfg, model = _models(raw)
    jopt = jax_make_optimizer(jcfg)
    jstep = jax_train_step(jcfg, jopt, donate=False)
    jstate = jopt.init(params)
    step = make_train_step(cfg, model, make_optimizer(cfg, model.parameters()))
    for seed in range(3):
        batch = _batch(seed)
        params, jstate, j_aux = jstep(params, jstate,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
        aux = step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(aux["loss"], float(j_aux["loss"]), rtol=1e-4)
        np.testing.assert_allclose(aux["grad_norm"], float(j_aux["grad_norm"]),
                                   rtol=1e-3)
    want = params_to_state_dict(params)
    diffs = []
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - np.asarray(want[name]))
        assert d.max() <= 1.8e-3, name
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs > 1e-6) < 1e-2, np.mean(diffs > 1e-6)


# trainer keys the JAX package reads from the raw config, with its
# defaults (train_step.py:47, trainer.py:63)
JAX_RAW_TRAINER = {"grad_accum": 1, "async_checkpoint": False}


def _jax_trainer_value(jcfg, name):
    if name in JAX_RAW_TRAINER:
        return type(JAX_RAW_TRAINER[name])(jcfg.raw.get("trainer", {}).get(
            name, JAX_RAW_TRAINER[name]))
    return getattr(jcfg.trainer, name)


def test_config_defaults_and_schedule_match_jax():
    for tcls, jcls in ((tconfig.TrainerConfig, jconfig.TrainerConfig),
                       (tconfig.DataSplitConfig, jconfig.DataSplitConfig),
                       (tconfig.Config, jconfig.Config)):
        t, j = tcls(), jcls()
        for f in dataclasses.fields(tcls):
            if f.name in ("raw", "model", "train_data", "val_data",
                          "trainer", "crop_size", "mesh"):
                continue
            want = (JAX_RAW_TRAINER[f.name] if tcls is tconfig.TrainerConfig
                    and f.name in JAX_RAW_TRAINER else getattr(j, f.name))
            assert getattr(t, f.name) == want, (tcls, f.name)
    path = os.path.join(
        REPO, "configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json")
    t, j = tconfig.Config.load(path), jconfig.Config.load(path)
    for f in dataclasses.fields(tconfig.TrainerConfig):
        assert getattr(t.trainer, f.name) == _jax_trainer_value(j, f.name)
    assert t.metrics == j.metrics
    raw = {**j.raw, "trainer": {**j.raw["trainer"], "grad_accum": 2,
                                "async_checkpoint": True}}
    tc, jc = tconfig.Config.from_dict(raw), jconfig.Config.from_dict(raw)
    for name in JAX_RAW_TRAINER:
        assert getattr(tc.trainer, name) == _jax_trainer_value(jc, name)
    assert t.train_data == tconfig.DataSplitConfig(**{
        f.name: getattr(j.train_data, f.name)
        for f in dataclasses.fields(tconfig.DataSplitConfig)})
    assert (t.batch_size, t.grad_loss_weight, t.loss_config, t.crop_size) == \
        (j.batch_size, j.grad_loss_weight, j.loss_config, 224)
    assert supervised_keys(t) == ("events4", "image")
    # the mesh key, default and given (the two packages' own classes)
    for mesh in (None, {"data": 2, "model": 4, "dcn_data": 3}):
        raw = {**j.raw, **({"mesh": mesh} if mesh else {})}
        tc, jc = tconfig.Config.from_dict(raw), jconfig.Config.from_dict(raw)
        assert dataclasses.asdict(tc.mesh) == dataclasses.asdict(jc.mesh)
    for sched in ({"lr_scheduler_type": "ExponentialLR",
                   "lr_scheduler_freq": 3, "lr_scheduler": {"gamma": 0.5}},
                  {"lr_scheduler_type": "StepLR",
                   "lr_scheduler": {"gamma": 0.1, "step_size": 2}}):
        raw = {**_raw(), **sched}
        tc, jc = tconfig.Config.from_dict(raw), jconfig.Config.from_dict(raw)
        for epoch in range(7):
            assert lr_at_epoch(tc, epoch) == pytest.approx(
                jax_lr_at_epoch(jc, epoch), rel=1e-12)


def test_bf16_config_keeps_float32_masters():
    """Parameters stay float32 under a bf16 config (the JAX recipe's f32
    masters, configs/README.md), so an Adam step of lr 3e-4 moves every
    weight that has a gradient; with bf16 weights most such updates would
    round away.  The predictions are those of the earlier bf16-weight
    model: the weights cast at use are the same bf16 values."""
    raw = _raw(precompute_x=True, compute_dtype="bfloat16")
    cfg = tconfig.Config.from_dict(raw)
    model = ERGB2DepthRecurrent(cfg.model)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    old = ERGB2DepthRecurrent(cfg.model)
    old.to(torch.bfloat16)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.no_grad():
        _, p_new = model.forward_sequence_batched_decode(
            model.init_state(B, H, W), batch, package_precompute=True)
        _, p_old = old.forward_sequence_batched_decode(
            old.init_state(B, H, W), batch, package_precompute=True)
    for k in p_new:
        assert torch.equal(p_new[k], p_old[k])
    before = [p.detach().clone() for p in model.parameters()]
    aux = make_train_step(cfg, model, make_optimizer(cfg, model.parameters()),
                          remat=False)(batch)
    assert np.isfinite(aux["loss"])
    moved = [bool((p.detach() != b).any()) for p, b in
             zip(model.parameters(), before)]
    assert all(moved), sum(moved)


REFUSED = {
    # case: (config overrides, the error, what it matches); error None:
    # the option trains
    "bn_training": ({"model": {"norm": "BN"}}, None, None),
    "in_training": ({"model": {"norm": "IN"}}, None, None),
    "unknown_optimizer": ({"optimizer_type": "Adagrad"}, KeyError, "Adagrad"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_unported_training_options_raise(case):
    """An optimizer JAX does not know raises where it is read (KeyError,
    as JAX's).  BN/IN norms train: the loss builds despite precompute_x
    (ignored with JAX's warning: training-mode norms take the in-scan
    path), and one window gives a finite loss and the running stats to
    write back (their parity with JAX: tests/test_torch_zoo_train.py)."""
    over, error, match = REFUSED[case]
    raw = _raw()
    raw = {**raw, **{k: v for k, v in over.items() if k != "model"},
           "model": {**raw["model"], **over.get("model", {})}}
    cfg = tconfig.Config.from_dict(raw)
    if error is not None:
        with pytest.raises(error, match=match):
            make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1))])
        return
    with pytest.warns(UserWarning, match="precompute_x requires"):
        loss_fn = make_sequence_loss(cfg, remat=False)
    model = ERGB2DepthRecurrent(cfg.model)
    loss, aux = loss_fn(model, model.init_state(B, H, W),
                        {k: torch.from_numpy(v) for k, v in _batch().items()})
    assert np.isfinite(loss.item()) and aux["norm_stats"]
