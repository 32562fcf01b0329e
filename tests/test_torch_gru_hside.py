"""The port's ConvGRU h-side cell (kernel K1 in ops/gru_hside.py).

Its plain version against the JAX Pallas kernel in interpret mode, float32,
at the shapes tests/test_ops.py uses (1e-5), and the wrapper's checks.  The
kernel itself is tested on a card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops.gru_hside import conv_gru_hside_fused

from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside
from torch_threads import one_thread  # noqa: F401

SHAPES = ((1, 32, 24, 8), (2, 16, 16, 16), (1, 8, 8, 8))
PREFIX = "statenetphasedrecurrent."


def _cells(C, seed=0):
    """A JAX ConvGRU param dict and the port's ConvGRU with its weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    cell = ConvGRU(C, C)
    sd = {k[len(PREFIX):]: torch.from_numpy(np.array(v))
          for k, v in params_to_state_dict(p).items()}
    cell.load_state_dict(sd, strict=True)
    return p, cell


def _inputs(shape, seed=0):
    B, H, W, C = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_pallas_kernel(shape):
    C = shape[-1]
    p, cell = _cells(C)
    h, x = _inputs(shape)
    gx = np.array(JL.conv_gru_x_gates(p, jnp.asarray(x)))
    want = np.asarray(conv_gru_hside_fused(p, jnp.asarray(gx),
                                           jnp.asarray(h), interpret=True))
    th, tgx = torch.from_numpy(h), torch.from_numpy(gx)
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights()
        plain = gru_hside.conv_gru_hside_plain(th, tgx, w_ur, w_o)
        wrapped = gru_hside.conv_gru_hside(th, tgx, w_ur, w_o)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=1e-5)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(wrapped, plain)


def test_fused_on_raises_on_cpu():
    cfg = ModelConfig.from_dict(dict(
        num_encoders=2, base_num_channels=8, num_residual_blocks=1,
        recurrent_block_type="conv", state_combination="convgru",
        every_x_rgb_frame=1, norm="none", compute_dtype="bfloat16",
        fused_gru="on"))
    model = ERGB2DepthRecurrent(cfg)
    seq = {"events": torch.zeros(1, 1, 1, 16, 16, 5),
           "image": torch.zeros(1, 1, 16, 16, 1)}
    with pytest.raises(ValueError, match="CUDA"):
        model.forward_sequence_precomputed(model.init_state(1, 16, 16), seq)


def test_wrapper_raises_on_grad_and_bad_inputs():
    """Under autograd the wrapper now runs the ConvGRUHside Function:
    gradients reach h, gx and both folded weights.  Bad inputs still
    raise."""
    _, cell = _cells(8)
    w_ur, w_o = cell.hside_weights()
    h = torch.randn(1, 8, 8, 8, generator=torch.Generator().manual_seed(0))
    gx = torch.zeros(1, 8, 8, 24)
    h.requires_grad_()
    gx.requires_grad_()
    out = gru_hside.conv_gru_hside(h, gx, w_ur, w_o)
    assert out.requires_grad
    out.sum().backward()
    for t in (h, gx, cell.update_gate.weight, cell.out_gate.weight):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert cell.out_gate.weight.grad[:, -8:].abs().sum() > 0
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights()
        h = h.detach()
        gx = gx.detach()
        with pytest.raises(ValueError, match="multiple of 8"):
            gru_hside.conv_gru_hside(torch.zeros(1, 8, 8, 4),
                                     torch.zeros(1, 8, 8, 12), w_ur, w_o)
        with pytest.raises(ValueError, match="gx"):
            gru_hside.conv_gru_hside(h, gx[..., :16], w_ur, w_o)


def test_tile_choice_and_weight_fold_cache():
    # the flagship widths fit; a width beyond shared memory does not
    for shape in ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256)):
        th, tw = gru_hside.pick_tile(*shape)
        assert gru_hside.smem_bytes(th, tw, shape[-1]) <= gru_hside._SMEM_MAX
    assert gru_hside.pick_tile(1, 8, 8, 4096) is None
    assert not gru_hside.supports(torch.zeros(1, 8, 8, 4096,
                                              dtype=torch.bfloat16))
    # the folded weights follow an in-place weight update
    _, cell = _cells(8)
    with torch.no_grad():
        w_ur, _ = cell.hside_weights()
        assert cell.hside_weights()[0] is w_ur
        cell.update_gate.weight.mul_(2.0)
        w_ur2, _ = cell.hside_weights()
    assert torch.allclose(w_ur2[:, :8], 2.0 * w_ur[:, :8])
    assert torch.equal(w_ur2[:, 8:], w_ur[:, 8:])
