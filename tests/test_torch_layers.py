"""Per-layer parity of the PyTorch port against the JAX package, float32.

Parameters come from the JAX ``init_params`` and cross into the port with
``compat.params_from_jax``; inputs are made with numpy from a seed and fed
to both.  Tolerance 1e-5, that of tests/test_layer_parity.py.
"""
import numpy as np
import pytest
import torch

import jax

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.models import layers as JL

from rpg_ramnet_tpu_torch.compat import params_from_jax
from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.models.layers import upsample2x_bilinear
from rpg_ramnet_tpu_torch.utils.layout import to_nchw, to_nhwc
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
B, H, W = 2, 16, 24
CFG = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
           state_combination="convgru", num_encoders=2, base_num_channels=8,
           num_residual_blocks=1, recurrent_block_type="conv", norm="none",
           use_upsample_conv=True, every_x_rgb_frame=2, baseline=False)


@pytest.fixture(scope="module")
def models():
    params = JaxModel.init_params(jax.random.PRNGKey(0),
                                  JaxModelConfig.from_dict(CFG))
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(CFG))
    params_from_jax(model, params)
    return params, model.statenetphasedrecurrent


def _jgru(p):
    return p["state_combination_events"][0]["recurrent_block"]


def _tgru(net):
    return net.state_combination_events[0].recurrent_block


# name -> (input shapes (NHWC unless noted), JAX fn, port fn on torch NHWC)
CASES = {
    "conv_layer_apply_head_nchw": (
        [(B, 5, H, W)],
        lambda p, x: JL.conv_layer_apply(p["head_events"], x, 1, 2, "relu",
                                         None, input_layout="NCHW"),
        lambda n, x: to_nhwc(n.head_events(x))),
    "conv_layer_apply_stride2": (
        [(B, H, W, 8)],
        lambda p, x: JL.conv_layer_apply(p["encoders_events"][0], x, 2, 2,
                                         "relu"),
        lambda n, x: to_nhwc(n.encoders_events[0](to_nchw(x)))),
    "conv_layer_apply_pred": (
        [(B, H, W, 8)],
        lambda p, x: JL.conv_layer_apply(p["pred"], x, 1, 0, None),
        lambda n, x: to_nhwc(n.pred(to_nchw(x)))),
    "upsample2x_bilinear": (
        [(B, H, W, 8)],
        lambda p, x: JL.upsample2x_bilinear(x),
        lambda n, x: to_nhwc(upsample2x_bilinear(to_nchw(x)))),
    "upsample_conv_layer_apply": (
        [(B, H // 2, W // 2, 32)],
        lambda p, x: JL.upsample_conv_layer_apply(p["decoders"][0], x, 2,
                                                  "relu"),
        lambda n, x: to_nhwc(n.decoders[0](to_nchw(x)))),
    "residual_block_apply": (
        [(B, H, W, 32)],
        lambda p, x: JL.residual_block_apply(p["resblocks"][0], x),
        lambda n, x: to_nhwc(n.resblocks[0](to_nchw(x)))),
    "conv_gru_apply": (
        [(B, H, W, 16), (B, H, W, 16)],
        lambda p, x, h: JL.conv_gru_apply(_jgru(p), x, h),
        lambda n, x, h: to_nhwc(_tgru(n)(to_nchw(x), to_nchw(h)))),
    "conv_gru_x_gates": (
        [(B, H, W, 16)],
        lambda p, x: JL.conv_gru_x_gates(_jgru(p), x),
        lambda n, x: to_nhwc(_tgru(n).x_gates(to_nchw(x)))),
    "conv_gru_apply_hside": (
        [(B, H, W, 48), (B, H, W, 16)],
        lambda p, gx, h: JL.conv_gru_apply_hside(_jgru(p), gx, h),
        lambda n, gx, h: to_nhwc(_tgru(n).hside(to_nchw(gx),
                                                      to_nchw(h)))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(models, name):
    params, net = models
    shapes, jax_fn, port_fn = CASES[name]
    rng = np.random.RandomState(0)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    want = np.asarray(jax_fn(params, *xs))
    with torch.no_grad():
        got = port_fn(net, *[torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_conv_gru_orthogonal_init_matches_jax():
    """The port's ConvGRU init meets
    tests/test_init_parity.py::test_conv_gru_orthogonal_init's
    expectations, as JAX's ``conv_gru_init`` does: zero biases and
    orthonormal rows of each gate weight's (out, in*k*k) flattening
    (torch's ``orthogonal_``); and the model's init reaches every gate of
    both state combinations."""
    from rpg_ramnet_tpu_torch.models.layers import ConvGRU

    def check(gate_w, gate_b):
        flat = gate_w.reshape(gate_w.shape[0], -1)
        np.testing.assert_allclose(flat @ flat.T, np.eye(len(flat)),
                                   atol=1e-5)
        assert np.all(gate_b == 0)

    cell = ConvGRU(16, 16)
    cell.reset_parameters_(torch.Generator().manual_seed(1))
    p = JL.conv_gru_init(jax.random.PRNGKey(1), 16, 16, 3)
    for gate in ("reset_gate", "update_gate", "out_gate"):
        conv = getattr(cell, gate)
        assert tuple(conv.weight.shape) == (16, 32, 3, 3)
        check(conv.weight.detach().numpy(), conv.bias.detach().numpy())
        check(np.transpose(np.asarray(p[gate]["weight"]), (3, 2, 0, 1)),
              np.asarray(p[gate]["bias"]))
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(CFG),
                                generator=torch.Generator().manual_seed(2))
    grus = [m for m in model.modules() if isinstance(m, ConvGRU)]
    assert len(grus) == 2 * CFG["num_encoders"]
    for g in grus:
        for conv in g.gates():
            check(conv.weight.detach().float().numpy(),
                  conv.bias.detach().numpy())
