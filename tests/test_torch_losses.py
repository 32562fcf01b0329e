"""The port's training losses and spatial gradients against the JAX
package's, values and gradients, with NaN targets (float32, 1e-6 relative:
the same arithmetic summed in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core.config import Config as JaxConfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import gradient as jgrad
from rpg_ramnet_tpu.train import losses as JL
from rpg_ramnet_tpu.train.sequence_loss import make_sequence_loss as jax_loss

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import Config
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.ops import gradient as tgrad
from rpg_ramnet_tpu_torch.train import losses as TL
from rpg_ramnet_tpu_torch.train.sequence_loss import make_sequence_loss

from test_train import tiny_config
from torch_threads import one_thread  # noqa: F401


def _maps(seed=0, shape=(2, 20, 24, 1), nan=True):
    rng = np.random.RandomState(seed)
    pred = rng.rand(*shape).astype(np.float32) + 0.05
    target = rng.rand(*shape).astype(np.float32) + 0.05
    if nan:
        target[0, 3:7, 5:9] = np.nan
        target[1, -2:, :3] = np.nan
    return pred, target


def test_spatial_gradient_and_avg_pool_match_jax():
    x, _ = _maps(nan=False)
    x[0, 4, 4, 0] = np.nan        # spreads as through a direct convolution
    for k in (1, 2, 4):
        want = jgrad.avg_pool(jnp.asarray(x), k)
        got = tgrad.avg_pool(torch.from_numpy(x), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   equal_nan=True)
        for g, w in zip(tgrad.spatial_gradient(got),
                        jgrad.spatial_gradient(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, equal_nan=True)


LOSSES = {
    "scale_invariant_loss": (lambda p, t: TL.scale_invariant_loss(p, t, 1.0, 0.5),
                             lambda p, t: JL.scale_invariant_loss(p, t, 1.0, 0.5)),
    "scale_invariant_log_loss": (TL.scale_invariant_log_loss,
                                 JL.scale_invariant_log_loss),
    "mse_loss": (TL.mse_loss, JL.mse_loss),
    "multi_scale_grad_loss": (TL.multi_scale_grad_loss,
                              JL.multi_scale_grad_loss),
}


@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_gradient_match_jax_with_nan_targets(name):
    t_fn, j_fn = LOSSES[name]
    pred, target = _maps()
    want, want_grad = jax.value_and_grad(j_fn)(jnp.asarray(pred),
                                               jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    got = t_fn(p, torch.from_numpy(target))
    got.backward()
    assert torch.isfinite(got) and torch.isfinite(p.grad).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-8)


def test_sequence_loss_mse_downsampled_legacy_scaling_matches_jax():
    """The MSE term on 2x-downsampled maps (antialiased bilinear, as
    jax.image.resize), legacy loss scaling and NaN targets, on the full-cell
    path."""
    raw = tiny_config().raw
    raw = {**raw, "mse_loss": {"weight": 0.5, "downsampling_factor": 0.5},
           "trainer": {**raw["trainer"], "deferred_decode": True,
                       "legacy_loss_scaling": True}}
    jcfg = JaxConfig.from_dict(raw)
    params = JaxModel.init_params(jax.random.PRNGKey(2), jcfg.model)
    cfg = Config.from_dict(raw)
    model = ERGB2DepthRecurrent(cfg.model)
    params_from_jax(model, params)
    rng = np.random.RandomState(4)
    B, L, K, H, W = 2, 2, 3, 16, 16
    batch = {"events": rng.randn(B, L, K, H, W, 5).astype(np.float32),
             "image": rng.rand(B, L, H, W, 1).astype(np.float32),
             "depth_events": rng.rand(B, L, K, H, W, 1).astype(np.float32),
             "depth_image": rng.rand(B, L, H, W, 1).astype(np.float32)}
    batch["depth_image"][:, :, 2:5, 3:7] = np.nan
    j_loss, j_aux = jax_loss(jcfg)(params, JaxModel.init_state(jcfg.model, B, H, W),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, aux = make_sequence_loss(cfg)(
            model, model.init_state(B, H, W),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(aux) == set(j_aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=1e-5,
                                   err_msg=k)
