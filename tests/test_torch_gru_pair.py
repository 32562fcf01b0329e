"""The port's cross-scale pair cell (kernel K9, ops/gru_pair.py), the
fused_pair switch, and the config fields of the chunked path's launch
variants.

Op level: the plain version against the JAX Pallas kernel in interpret
mode at tiny shapes, float32 at 1e-5 and bf16 at 2e-2.  Slice level:
forward_sequence_precomputed with fused_pair='on' against the JAX
package's, weights carried by compat, within 5e-2 (tests/test_ops.py:
708-743).  The kernel itself is tested on a card in
tests/test_torch_cuda.py.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside
from rpg_ramnet_tpu.ops import gru_pair as jax_gru_pair

from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import statenet
from rpg_ramnet_tpu_torch.ops import gru_pair

from torch_chunked_common import (OP_TOL, SLICE_TOL, Spy, as_jax, as_torch,
                                  cell, folded, interpret, jax_forward,
                                  max_diff, models, port_forward, sequence,
                                  to_np, with_cfg)
from torch_threads import one_thread  # noqa: F401

PAIRS = [((1, 16, 16, 16), (1, 8, 8, 32)), ((2, 8, 16, 16), (2, 4, 8, 32))]


def _pair_inputs(shapes, seed=0):
    """Per scale: JAX params, the port's cell, h and gx (float32 numpy)."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (B, H, W, C) in enumerate(shapes):
        p, c = cell(C, seed + i)
        h = rng.randn(B, H, W, C).astype(np.float32)
        gx = np.array(JL.conv_gru_x_gates(
            p, jnp.asarray(rng.randn(B, H, W, C).astype(np.float32))))
        out.append((p, c, h, gx))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shapes", PAIRS, ids=["B1", "B2"])
def test_pair_plain_matches_jax_pallas_kernel(shapes, dtype):
    (p0, c0, h0, gx0), (p1, c1, h1, gx1) = _pair_inputs(shapes)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_gru_pair.conv_gru_hside_pair(
        p0, p1, as_jax(gx0, jdt), as_jax(gx1, jdt), as_jax(h0, jdt),
        as_jax(h1, jdt))
    args = (as_torch(h0, tdt), as_torch(gx0, tdt), *folded(c0, tdt),
            as_torch(h1, tdt), as_torch(gx1, tdt), *folded(c1, tdt))
    plain = gru_pair.conv_gru_hside_pair_plain(*args)
    # on CPU tensors the wrapper is the plain version
    wrapped = gru_pair.conv_gru_hside_pair(*args)
    tol = 1e-5 if dtype == "float32" else OP_TOL
    for got, w, t in zip(plain, want, wrapped):
        np.testing.assert_allclose(to_np(got), to_np(w), atol=tol, rtol=tol)
        assert torch.equal(t, got)


def test_pair_wrapper_checks_and_raises_under_autograd():
    (_, c0, h0, gx0), (_, c1, h1, gx1) = _pair_inputs(PAIRS[0])
    args = [as_torch(h0), as_torch(gx0), *folded(c0),
            as_torch(h1), as_torch(gx1), *folded(c1)]
    with pytest.raises(ValueError, match="batch"):
        gru_pair.conv_gru_hside_pair(*args[:4], args[4].expand(2, -1, -1, -1),
                                     args[5].expand(2, -1, -1, -1), *args[6:])
    with pytest.raises(ValueError, match="gx"):
        gru_pair.conv_gru_hside_pair(args[0], args[1][..., :16], *args[2:])
    args[0] = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        gru_pair.conv_gru_hside_pair(*args)
    with torch.no_grad():
        assert gru_pair.conv_gru_hside_pair(*args)[0].shape == PAIRS[0][0]


def test_supports_pair():
    bf = torch.bfloat16
    assert gru_pair.supports_pair(torch.zeros(1, 16, 16, 16, dtype=bf),
                                  torch.zeros(1, 8, 8, 32, dtype=bf))
    # float32, C % 16 != 0 and a batch mismatch are refused
    assert not gru_pair.supports_pair(torch.zeros(1, 16, 16, 16),
                                      torch.zeros(1, 8, 8, 32))
    assert not gru_pair.supports_pair(torch.zeros(1, 16, 16, 8, dtype=bf),
                                      torch.zeros(1, 8, 8, 32, dtype=bf))
    assert not gru_pair.supports_pair(torch.zeros(1, 16, 16, 16, dtype=bf),
                                      torch.zeros(2, 8, 8, 32, dtype=bf))


def test_fused_pair_model_path_matches_jax(monkeypatch):
    """fused_pair='on': K9's plain version on scales 0 and 1 at every
    modality step (the port's 'auto' takes the wrappers on CPU bf16
    tensors), K1's on scale 2; against JAX with fused_gru='on' and the
    kernels in interpret mode, and against the port's per-scale path."""
    L, K, H, W = 2, 2, 32, 32
    jcfg, params, model = models(fused_gru="on", fused_pair="on",
                                 every_x_rgb_frame=K)
    with_cfg(model, fused_gru="auto")
    seq = sequence(L, K, H, W)
    with interpret(jax_gru_hside, jax_gru_pair):
        j_state, j_preds = jax_forward(jcfg, params, seq)
    spy = Spy(monkeypatch, gru_pair, "conv_gru_hside_pair")
    t_state, t_preds = port_forward(model, seq)
    assert spy.calls == L * (K + 1)
    assert max_diff(t_preds, j_preds) < SLICE_TOL
    assert max_diff(t_state, j_state) < SLICE_TOL
    _, per_scale = port_forward(with_cfg(model, fused_pair="auto"), seq)
    assert spy.calls == L * (K + 1)
    assert max_diff(t_preds, per_scale) == 0.0


def test_convlstm_fused_pair_keeps_per_scale_path(monkeypatch):
    """The pair cell is the ConvGRU's: a ConvLSTM state combination with
    fused_pair='on' runs its per-scale cells, as the JAX package's
    combine_hside does."""
    _, _, model = models(state_combination="convlstm", fused_pair="on")
    seq = sequence(2, 2, 32, 32, seed=1)
    spy = Spy(monkeypatch, gru_pair, "conv_gru_hside_pair")
    _, on = port_forward(model, seq)
    _, auto = port_forward(with_cfg(model, fused_pair="auto"), seq)
    assert spy.calls == 0
    assert max_diff(on, auto) == 0.0


def test_config_keeps_launch_switches(tmp_path):
    """A config file's fused_pair and fused_stream take effect (the port's
    ModelConfig used to drop them), default 'auto', and check_supported
    takes only auto/on/off."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"model": {
        "recurrent_block_type": "conv", "state_combination": "convgru",
        "fused_pair": "on", "fused_stream": "on"}}))
    cfg = ModelConfig.load(str(path))
    assert (cfg.fused_pair, cfg.fused_stream) == ("on", "on")
    assert (ModelConfig().fused_pair, ModelConfig().fused_stream) == ("auto", "auto")
    statenet.check_supported(cfg)
    for name in ("fused_pair", "fused_stream"):
        with pytest.raises(ValueError, match=name):
            statenet.check_supported(ModelConfig.from_dict(dict(
                recurrent_block_type="conv", state_combination="convgru",
                **{name: "yes"})))
