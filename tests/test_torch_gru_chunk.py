"""The port's whole-chunk resident-state cell (kernel K11, ops/gru_chunk.py)
and forward_sequence_precomputed's chunk_cells branch.

Op level: the plain version against the JAX Pallas kernel in interpret
mode at tiny shapes, bf16 within 2e-2.  Slice level: chunk_cells against
the JAX package's, and against the port's per-step path, within 5e-2
(tests/test_batched_streaming.py:411-462), a decode_keys subset included,
and the branch's refusals with the JAX package's messages.  The kernel
itself is tested on a card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from rpg_ramnet_tpu.ops import gru_chunk as jax_gru_chunk

from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_hside, gru_pair

from torch_chunked_common import (OP_TOL, SLICE_TOL, Spy, as_jax, as_torch,
                                  cell, folded, interpret, jax_forward,
                                  max_diff, models, port_forward, sequence,
                                  to_np, with_cfg)
from torch_threads import one_thread  # noqa: F401


def _chunk_inputs(shape, S, seed=0):
    """JAX params and the port's cells (events, image), gx_steps [S, H, W,
    3C] and h0 [1, H, W, C] (float32 numpy)."""
    _, H, W, C = shape
    rng = np.random.RandomState(seed)
    (p_ev, c_ev), (p_im, c_im) = cell(C, seed), cell(C, seed + 1)
    gx = rng.randn(S, H, W, 3 * C).astype(np.float32)
    h0 = (rng.rand(1, H, W, C) * 2 - 1).astype(np.float32)
    return p_ev, c_ev, p_im, c_im, gx, h0


@pytest.mark.parametrize("shape,K", [((1, 16, 16, 16), 2), ((1, 8, 16, 32), 1)],
                         ids=["C16_K2", "C32_K1"])
def test_chunk_plain_matches_jax_pallas_kernel(shape, K):
    p_ev, c_ev, p_im, c_im, gx, h0 = _chunk_inputs(shape, 2 * (K + 1))
    want = jax_gru_chunk.conv_gru_hside_chunk(p_ev, p_im, as_jax(gx),
                                              as_jax(h0), K, interpret=True)
    args = (folded(c_ev), folded(c_im), as_torch(gx), as_torch(h0), K)
    got = gru_chunk.conv_gru_hside_chunk_plain(*args)
    assert got.shape == (gx.shape[0],) + shape[1:]
    np.testing.assert_allclose(to_np(got), to_np(want), atol=OP_TOL, rtol=0)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(gru_chunk.conv_gru_hside_chunk(*args), got)


def test_chunk_plain_selects_weights_per_step():
    """Step s uses the image weights where s % (K+1) == K, else the events
    weights, and reads the previous step's state."""
    K = 2
    _, c_ev, _, c_im, gx, h0 = _chunk_inputs((1, 8, 8, 16), 2 * (K + 1), seed=3)
    w_ev, w_im, gx, h = folded(c_ev), folded(c_im), as_torch(gx), as_torch(h0)
    snaps = gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gx, h, K)
    for s in range(len(snaps)):
        w = w_im if s % (K + 1) == K else w_ev
        want = gru_hside.conv_gru_hside_plain(h, gx[s:s + 1], *w)
        assert torch.equal(snaps[s:s + 1], want), s
        h = want


def test_chunk_wrapper_checks_and_raises_under_autograd():
    _, c_ev, _, c_im, gx, h0 = _chunk_inputs((1, 8, 8, 16), 6, seed=5)
    w_ev, w_im, gx, h = folded(c_ev), folded(c_im), as_torch(gx), as_torch(h0)
    with pytest.raises(ValueError, match="packages"):
        gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gx[:5], h, 2)
    with pytest.raises(ValueError, match="h0"):
        gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gx, h.expand(2, -1, -1, -1), 2)
    with pytest.raises(ValueError, match="gx_steps"):
        gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gx[..., :16], h, 2)
    with pytest.raises(RuntimeError, match="no gradient"):
        gru_chunk.conv_gru_hside_chunk(w_ev, w_im, gx.clone().requires_grad_(),
                                       h, 2)
    assert gru_chunk.supports(h) and not gru_chunk.supports(h.float())
    assert not gru_chunk.supports(h.expand(2, -1, -1, -1))


def test_chunk_cells_model_matches_jax(monkeypatch):
    """chunk_cells=True: one K11 call per scale per chunk; against the JAX
    package's chunk_cells (kernel in interpret mode) and the port's
    per-step path, with a decode_keys subset gathering the snapshots."""
    L, K, H, W = 2, 2, 32, 64      # the JAX kernel takes W % 8 == 0
    jcfg, params, model = models(every_x_rgb_frame=K)
    seq = sequence(L, K, H, W, seed=7)
    with interpret(jax_gru_chunk):
        j_state, j_preds = jax_forward(jcfg, params, seq, chunk_cells=True)
        _, j_sub = jax_forward(jcfg, params, seq, chunk_cells=True,
                               decode_keys=("events1", "image"))
    spy = Spy(monkeypatch, gru_chunk, "conv_gru_hside_chunk")
    t_state, t_preds = port_forward(model, seq, chunk_cells=True)
    assert spy.calls == 3
    assert max_diff(t_preds, j_preds) < SLICE_TOL
    assert max_diff(t_state, j_state) < SLICE_TOL
    _, t_sub = port_forward(model, seq, chunk_cells=True,
                            decode_keys=("events1", "image"))
    assert set(t_sub) == {"events1", "image"}
    assert max_diff(t_sub, j_sub) < SLICE_TOL
    assert max_diff(t_sub, {k: t_preds[k] for k in t_sub}) == 0.0
    per_step_state, per_step = port_forward(model, seq)
    assert max_diff(t_preds, per_step) == 0.0
    assert max_diff(t_state, per_step_state) == 0.0


def test_chunk_cells_ignores_fused_pair(monkeypatch):
    """As in JAX, chunk_cells runs K11 on every scale, fused_pair='on' and
    fused_stream='on' notwithstanding."""
    _, _, model = models(fused_pair="on", fused_stream="on")
    seq = sequence(1, 2, 32, 32, seed=9)
    chunk = Spy(monkeypatch, gru_chunk, "conv_gru_hside_chunk")
    pair = Spy(monkeypatch, gru_pair, "conv_gru_hside_pair")
    _, got = port_forward(model, seq, chunk_cells=True)
    assert (chunk.calls, pair.calls) == (3, 0)
    _, want = port_forward(with_cfg(model, fused_pair="auto",
                                    fused_stream="auto"), seq)
    assert max_diff(got, want) == 0.0


@pytest.mark.parametrize("case", ["batch2", "reset", "convlstm"])
def test_chunk_cells_refusals(case):
    """Batch 2, a reset mask or a ConvLSTM state combination raise the JAX
    package's ValueError (tests/test_batched_streaming.py:456-462)."""
    _, _, model = models(**({"state_combination": "convlstm"}
                            if case == "convlstm" else {}))
    seq = sequence(1, 2, 32, 32, B=2 if case == "batch2" else 1)
    if case == "reset":
        seq["reset"] = np.zeros((1, 1), bool)
    with pytest.raises(ValueError, match="chunk_cells requires convgru"):
        port_forward(model, seq, chunk_cells=True)
