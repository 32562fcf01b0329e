"""The port's training options against the JAX package's.

On the tiny config of tests/test_train.py (2 encoders, base 4, K=3, B=2,
L=2, 16x16, float32; the port's seeded init crossed into JAX): the loss
and every parameter gradient under trainer.grad_accum 2, remat_chunk 2
(the in-scan decode path) and remat_policy 'enc_out', 'gru_gx' and both,
against JAX at the tolerance of tests/test_torch_train.py (atol 5e-5,
rtol 1e-3), and against the port's own grad_accum 1, remat_chunk 1 and
'none' (bitwise: the same operations); the optimizers AdamW, SGD (with
momentum, nesterov) and RMSprop for three steps against the optax chains
of the JAX package; and a reference .pth.tar with torch Adam state,
resumed by the port's trainer and by JAX's import_torch_optimizer_state,
one step on.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from rpg_ramnet_tpu.compat.torch_import import (import_torch_optimizer_state,
                                                params_to_state_dict,
                                                state_dict_to_params)
from rpg_ramnet_tpu.core import config as jconfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss
from rpg_ramnet_tpu.train.train_step import make_train_step as jax_train_step

from rpg_ramnet_tpu_torch.core import config as tconfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train.optim import make_optimizer
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss
from rpg_ramnet_tpu_torch.train.train_step import (make_grad_fn,
                                                   make_train_step,
                                                   micro_batch)
from rpg_ramnet_tpu_torch.train.trainer import Trainer

from test_torch_train import _admit_f32, _batch, B, H, L, W
from test_train import tiny_config

ATOL, RTOL = 5e-5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (tests/test_torch_lanes.py::_one_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw(deferred=True, precompute_x=True, **trainer):
    raw = tiny_config().raw
    return {**raw, "trainer": {**raw["trainer"], "deferred_decode": deferred,
                               "precompute_x": precompute_x, **trainer}}


def _models(raw):
    """The port's seeded model and its weights as a JAX param tree."""
    cfg = tconfig.Config.from_dict(raw)
    model = ERGB2DepthRecurrent(cfg.model)
    return (jconfig.Config.from_dict(raw),
            state_dict_to_params(model.state_dict()), cfg, model)


def _torch_batch(seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def _jax_batch(seed=0):
    return {k: jnp.asarray(v) for k, v in _batch(seed).items()}


def _jax_loss_grads(jcfg, params):
    (loss, aux), grads = jax.value_and_grad(
        jax_loss(jcfg, remat=True), has_aux=True)(
        params, JaxModel.init_state(jcfg.model, B, H, W), _jax_batch())
    return float(loss), aux, params_to_state_dict(grads)


_IN_SCAN_RC2 = {}


def _jax_in_scan_rc2(jcfg, params):
    """JAX's loss and gradients with remat_chunk 2 on the in-scan path,
    once per module: with deferred_decode JAX warns and takes the same
    path (sequence_loss.py:126-131), so both remat_chunk cases hold the
    port to it."""
    if not _IN_SCAN_RC2:
        raw = {**jcfg.raw, "trainer": {**jcfg.raw["trainer"],
                                       "deferred_decode": False}}
        _IN_SCAN_RC2["ref"] = _jax_loss_grads(jconfig.Config.from_dict(raw),
                                              params)
    return _IN_SCAN_RC2["ref"]


def _port_loss_grads(cfg, model):
    model.zero_grad(set_to_none=True)
    loss, aux = make_sequence_loss(cfg, remat=True)(
        model, model.init_state(B, H, W), _torch_batch())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), aux, grads


def _assert_grads_match_jax(grads, want):
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def _with_trainer(cfg, **over):
    return dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer,
                                                                **over))


def test_grad_accum_matches_jax():
    """Two micro-batches of one window each, from their own zero states,
    gradients and loss terms averaged (JAX train_step.py:47-85).  JAX's
    step under SGD at lr 1 moves each parameter by minus its gradient."""
    raw = {**_raw(grad_accum=2), "optimizer_type": "SGD",
           "optimizer": {"lr": 1.0}}
    jcfg, params, cfg, model = _models(raw)
    assert cfg.trainer.grad_accum == 2
    jopt = jax_make_optimizer(jcfg)
    new, _, j_aux = jax_train_step(jcfg, jopt, donate=False)(
        params, jopt.init(params), _jax_batch())
    want = {k: v - params_to_state_dict(new)[k]
            for k, v in params_to_state_dict(params).items()}
    batch = _torch_batch()
    aux = make_grad_fn(cfg, model)(batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    _assert_grads_match_jax(grads, want)
    # the port's own micro-batches through grad_accum 1, averaged
    halves = []
    for i in range(2):
        a = make_grad_fn(_with_trainer(cfg, grad_accum=1), model)(
            micro_batch(batch, 2, i))
        halves.append((a, {n: p.grad.clone()
                           for n, p in model.named_parameters()}))
    for n, g in grads.items():
        assert torch.equal(g, (halves[0][1][n] + halves[1][1][n]) / 2), n
    for k, v in aux.items():
        assert torch.equal(v, (halves[0][0][k] + halves[1][0][k]) / 2), k
    step_aux = make_train_step(cfg, model,
                               make_optimizer(cfg, model.parameters()))(batch)
    assert set(step_aux) == set(j_aux)
    for k in j_aux:
        np.testing.assert_allclose(step_aux[k], float(j_aux[k]),
                                   rtol=RTOL if k == "grad_norm" else 1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["in_scan", "deferred_falls_back"])
def test_remat_chunk_matches_jax(deferred):
    """remat_chunk 2 checkpoints the window's two packages as one group on
    the in-scan decode path; with deferred_decode both packages warn and
    take that path (JAX sequence_loss.py:126-131)."""
    raw = _raw(deferred=deferred, precompute_x=False, remat_chunk=2)
    jcfg, params, cfg, model = _models(raw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_loss(jcfg, remat=True)
        loss, aux, grads = _port_loss_grads(cfg, model)
    j_loss, j_aux, want = _jax_in_scan_rc2(jcfg, params)
    warned = [str(w.message) for w in caught
              if "incompatible with remat_chunk" in str(w.message)]
    assert len(warned) == (2 if deferred else 0), warned
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    assert set(aux) == set(j_aux)
    _assert_grads_match_jax(grads, want)
    one = _with_trainer(cfg, remat_chunk=1, deferred_decode=False)
    loss1, _, grads1 = _port_loss_grads(one, model)
    assert torch.equal(loss, loss1)
    for n in grads:
        assert torch.equal(grads[n], grads1[n]), n


def test_remat_chunk_must_divide_the_window():
    _, _, cfg, model = _models(_raw(deferred=False, precompute_x=False,
                                    remat_chunk=3))
    with pytest.raises(ValueError, match="divisible"):
        make_sequence_loss(cfg, remat=True)(
            model, model.init_state(B, H, W), _torch_batch())


POLICIES = {
    # policy: (deferred_decode, precompute_x)
    "enc_out": (True, False),
    "gru_gx": (True, True),
    "enc_out+gru_gx_in_scan": (False, False),
    "enc_out_precompute_x": (True, True),
}


@pytest.mark.parametrize("case", POLICIES)
def test_remat_policy_matches_jax_and_none(monkeypatch, case):
    """Under a remat_policy the loss and gradients are JAX's (which saves
    the tagged tensors) and the port's 'none''s, bitwise: the port's
    checkpoint recomputes every package whole whatever the policy
    (ROADMAP queue 3); 'gru_gx' through the ConvGRUHside Function."""
    deferred, pre_x = POLICIES[case]
    policy = case.replace("_in_scan", "").replace("_precompute_x", "")
    calls = _admit_f32(monkeypatch) if pre_x else None
    raw = _raw(deferred=deferred, precompute_x=pre_x, remat_policy=policy)
    if pre_x:
        raw = {**raw, "model": {**raw["model"], "fused_gru": "on"}}
    jcfg, params, cfg, model = _models(raw)
    if pre_x:   # the port's 'on' needs CUDA; 'auto' takes the Function
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fused_gru="auto"))
        model.cfg = cfg.model
    j_loss, _, want = _jax_loss_grads(jcfg, params)
    loss, _, grads = _port_loss_grads(cfg, model)
    if pre_x:
        assert calls["bwd"] == 2 * (3 + 1) * L
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    _assert_grads_match_jax(grads, want)
    loss0, _, grads0 = _port_loss_grads(_with_trainer(cfg, remat_policy="none"),
                                        model)
    assert torch.equal(loss, loss0)
    for n in grads:
        assert torch.equal(grads[n], grads0[n]), n


OPTIMIZERS = {
    "AdamW": {"lr": 1e-2, "betas": [0.9, 0.99], "weight_decay": 0.05},
    "SGD_momentum": {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-3},
    "SGD_nesterov": {"lr": 0.1, "momentum": 0.9, "nesterov": True},
    "SGD": {"lr": 0.1},
    "RMSprop": {"lr": 1e-2, "alpha": 0.9, "eps": 1e-3, "weight_decay": 1e-3},
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_three_steps_match_optax(name):
    """Three steps on seeded parameters and gradients: the port's
    optimizer against the JAX package's optax chain, which includes the
    learning rate the trainer sets per epoch."""
    rng = np.random.RandomState(3)
    shapes = {"w": (6, 4, 3, 3), "b": (6,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 0.1).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    raw = {**_raw(), "optimizer_type": name.split("_")[0],
           "optimizer": OPTIMIZERS[name]}
    jopt = jax_make_optimizer(jconfig.Config.from_dict(raw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(tconfig.Config.from_dict(raw), list(tp.values()))
    for g in grads:
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if name == "RMSprop":
        # torch's RMSprop divides by sqrt(v) + eps: not the JAX update
        ref = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
        o = OPTIMIZERS[name]
        topt = torch.optim.RMSprop(list(ref.values()), lr=o["lr"],
                                   alpha=o["alpha"], eps=o["eps"],
                                   weight_decay=o["weight_decay"])
        for g in grads:
            for k, p in ref.items():
                p.grad = torch.from_numpy(g[k].copy())
            topt.step()
        assert not np.allclose(ref["w"].detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-3, atol=1e-4)


def test_pth_tar_resume_continues_reference_adam_state(tmp_path):
    """A reference .pth.tar whose module registration order is not the
    port's (reversed), with torch Adam state after two steps: the port's
    trainer takes the moments by name, as JAX's
    import_torch_optimizer_state takes them through ordered_param_names,
    and one step on both agree."""
    raw = _raw(precompute_x=False)
    jcfg, params, cfg, model = _models(raw)
    names = [n for n, _ in model.named_parameters()][::-1]
    ref_params = {n: torch.nn.Parameter(p.detach().clone())
                  for n, p in reversed(list(model.named_parameters()))}
    ref_opt = torch.optim.Adam([ref_params[n] for n in names], lr=3e-4)
    rng = np.random.RandomState(1)
    for _ in range(2):
        for p in ref_params.values():
            p.grad = torch.from_numpy(
                (rng.randn(*p.shape) * 1e-2).astype(np.float32))
        ref_opt.step()
    sd = {n: ref_params[n].detach().clone() for n in names}
    ckpt = {"arch": "ERGB2DepthRecurrent", "epoch": 3, "state_dict": sd,
            "optimizer": ref_opt.state_dict(), "monitor_best": 0.5,
            "config": raw, "logger": None}
    path = str(tmp_path / "ref.pth.tar")
    torch.save(ckpt, path)

    trainer = Trainer(cfg, None, None, resume=path, model=model,
                      run_dir=str(tmp_path / "run"))
    assert (trainer.start_epoch, trainer.monitor_best) == (4, 0.5)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), sd[n]), n
        got, want = trainer.optimizer.state[p], ref_opt.state[ref_params[n]]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[k], want[k]), (n, k)
    aux = trainer.train_step(_torch_batch())

    jparams = state_dict_to_params(sd)
    jopt = jax_make_optimizer(jcfg)
    jstate = import_torch_optimizer_state(ckpt, jparams, jopt)
    new, _, j_aux = jax_train_step(jcfg, jopt, donate=False)(
        jparams, jstate, _jax_batch())
    np.testing.assert_allclose(aux["loss"], float(j_aux["loss"]), rtol=1e-4)
    want = params_to_state_dict(new)
    diffs = []
    for n, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - np.asarray(want[n]))
        assert d.max() <= 2 * 3e-4, n      # Adam's bound for one step
        diffs.append(d.ravel())
    assert np.mean(np.concatenate(diffs) > 1e-6) < 1e-2
