"""The port's gx-streaming cells (kernels K10a and K10b, ops/gru_stream.py)
and forward_sequence_precomputed's stream branch.

Op level: StreamPlan.step and stream_pair_step on the plain versions
against the JAX package's in interpret mode at tiny shapes, bf16 within
2e-2; the step index (event sub-step t*K + k, image step t) on distinct
per-step gx.  Slice level: stream_cells, alone and with fused_pair='on',
against the JAX package's within 5e-2 (tests/test_batched_streaming.py:
635-715), and the branch's refusals with the JAX package's messages.  The
kernels themselves are tested on a card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from rpg_ramnet_tpu.ops import gru_stream as jax_gru_stream

from rpg_ramnet_tpu_torch.ops import gru_hside, gru_stream

from torch_chunked_common import (OP_TOL, SLICE_TOL, Spy, as_jax, as_torch,
                                  cell, folded, jax_forward, max_diff, models,
                                  port_forward, sequence, to_np, with_cfg)
from torch_threads import one_thread  # noqa: F401

L, K = 2, 2


def _plans(H, W, C, seed=0):
    """The JAX and the port's StreamPlan of one scale over L packages of K
    event steps, from the same weights, gx and h0 (bf16)."""
    rng = np.random.RandomState(seed)
    p_ev, c_ev = cell(C, seed)
    p_im, c_im = cell(C, seed + 1)
    gx_ev = rng.randn(L, 1, K, H, W, 3 * C).astype(np.float32)
    gx_im = rng.randn(L, 1, H, W, 3 * C).astype(np.float32)
    h0 = (rng.rand(1, H, W, C) * 2 - 1).astype(np.float32)
    jplan = jax_gru_stream.StreamPlan(p_ev, p_im, as_jax(gx_ev), as_jax(gx_im),
                                      as_jax(h0))
    tplan = gru_stream.StreamPlan(folded(c_ev), folded(c_im), as_torch(gx_ev),
                                  as_torch(gx_im), as_torch(h0))
    return jplan, tplan, h0


@pytest.mark.parametrize("k", [1, None], ids=["events", "image"])
def test_stream_step_matches_jax_pallas_kernel(k):
    jplan, tplan, h0 = _plans(16, 16, 16)
    want = jplan.step(as_jax(h0), 1, k)
    got = tplan.step(as_torch(h0), 1, k)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=OP_TOL, rtol=0)


def test_stream_pair_step_matches_jax_pallas_kernel():
    j0, t0, h0 = _plans(16, 16, 16, seed=2)
    j1, t1, h1 = _plans(8, 8, 32, seed=4)
    want = jax_gru_stream.stream_pair_step(j0, j1, as_jax(h0), as_jax(h1), 1, 0)
    got = gru_stream.stream_pair_step(t0, t1, as_torch(h0), as_torch(h1), 1, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), atol=OP_TOL, rtol=0)


def test_step_index_events_and_image():
    """Distinct gx at every step: event sub-step k of package t reads step
    t*K + k of the events buffer, the image step of package t step t of the
    image buffer, with the events and image weights."""
    _, tplan, h0 = _plans(8, 8, 16, seed=6)
    h = as_torch(h0)
    for t in range(L):
        for k in range(K):
            want = gru_hside.conv_gru_hside_plain(
                h, tplan.gx_ev[t * K + k:t * K + k + 1], *tplan.w_ev)
            assert torch.equal(tplan.step(h, t, k), want)
        want = gru_hside.conv_gru_hside_plain(h, tplan.gx_im[t:t + 1],
                                              *tplan.w_im)
        assert torch.equal(tplan.step(h, t), want)
    # the selections differ, so a wrong index would show
    assert not torch.equal(tplan.step(h, 1, 0), tplan.step(h, 0, 1))
    assert not torch.equal(tplan.step(h, 1), tplan.step(h, 0, 1))
    with pytest.raises(ValueError, match="sel"):
        tplan.step(h, L)                      # past the chunk


def test_stream_wrappers_check_and_raise_under_autograd():
    _, tplan, h0 = _plans(8, 8, 16, seed=8)
    gx, sel, (w_ur, w_o) = tplan.select(0, 1)
    h = as_torch(h0)
    with pytest.raises(ValueError, match="sel"):
        gru_stream.conv_gru_hside_stream(h, gx, sel.long(), w_ur, w_o)
    with pytest.raises(ValueError, match="gx_seq"):
        gru_stream.conv_gru_hside_stream(h, gx[..., :16], sel, w_ur, w_o)
    with pytest.raises(RuntimeError, match="no gradient"):
        gru_stream.conv_gru_hside_stream(h.clone().requires_grad_(), gx, sel,
                                         w_ur, w_o)
    with pytest.raises(RuntimeError, match="no gradient"):
        gru_stream.conv_gru_hside_stream_pair(
            h.clone().requires_grad_(), gx, w_ur, w_o, h, gx, w_ur, w_o, sel)


@pytest.mark.parametrize("pair", [False, True], ids=["stream", "stream_pair"])
def test_stream_cells_model_matches_jax(pair, monkeypatch):
    """stream_cells=True: K10a's plain version at every step and scale, or
    K10b's for scales 0 and 1 with fused_pair='on'; against the JAX
    package's stream branch (its kernels in interpret mode on the CPU)."""
    H, W = 32, 64            # the JAX kernels take W % 8 == 0 at every scale
    over = {"fused_pair": "on"} if pair else {}
    jcfg, params, model = models(every_x_rgb_frame=K, **over)
    seq = sequence(L, K, H, W, seed=3)
    j_state, j_preds = jax_forward(jcfg, params, seq, stream_cells=True)
    single = Spy(monkeypatch, gru_stream, "conv_gru_hside_stream")
    double = Spy(monkeypatch, gru_stream, "conv_gru_hside_stream_pair")
    t_state, t_preds = port_forward(model, seq, stream_cells=True)
    steps = L * (K + 1)
    assert (single.calls, double.calls) == ((steps, steps) if pair
                                            else (3 * steps, 0))
    assert max_diff(t_preds, j_preds) < SLICE_TOL
    assert max_diff(t_state, j_state) < SLICE_TOL


def test_fused_stream_config_selects_stream_cells(monkeypatch):
    """stream_cells=None reads cfg.fused_stream; the branch runs whatever
    fused_gru says (JAX model.py:509-511), and stream_cells=False keeps the
    per-step cells."""
    _, _, model = models(fused_stream="on", fused_gru="off")
    seq = sequence(1, 2, 32, 32, seed=5)
    spy = Spy(monkeypatch, gru_stream, "conv_gru_hside_stream")
    _, on = port_forward(model, seq)
    assert spy.calls == 3 * 3
    _, off = port_forward(model, seq, stream_cells=False)
    assert spy.calls == 3 * 3
    assert max_diff(on, off) < SLICE_TOL


@pytest.mark.parametrize("case", ["batch2", "reset", "convlstm"])
def test_stream_cells_refusals(case):
    """Batch 2, a reset mask or a ConvLSTM state combination raise the JAX
    package's ValueError (tests/test_batched_streaming.py:671-680)."""
    _, _, model = models(**({"state_combination": "convlstm"}
                            if case == "convlstm" else {}))
    seq = sequence(1, 2, 32, 32, B=2 if case == "batch2" else 1)
    if case == "reset":
        seq["reset"] = np.zeros((1, 1), bool)
    with pytest.raises(ValueError, match="stream_cells requires convgru"):
        port_forward(model, seq, stream_cells=True)
    with pytest.raises(ValueError, match="stream_cells requires convgru"):
        port_forward(with_cfg(model, fused_stream="on"), seq)


def test_eval_entry_point_reads_launch_switches(tmp_path, monkeypatch):
    """``python -m rpg_ramnet_tpu_torch.eval --scan_chunk`` with
    "fused_stream": "on" and "fused_pair": "on" in the config file's model
    block runs K10b and K10a (their plain versions on the CPU), with the
    predictions of the same file without them."""
    import json
    from rpg_ramnet_tpu_torch.core.config import Config
    from rpg_ramnet_tpu_torch.data import generate_split
    from rpg_ramnet_tpu_torch.eval.__main__ import main as eval_main
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.train.checkpoint import export_pth_tar
    from torch_chunked_common import CFG
    split = {"every_x_rgb_frame": K, "step_size": 1, "clip_distance": 80.0,
             "reg_factor": 3.70378}
    raw = {"name": "tiny", "arch": "ERGB2DepthRecurrent",
           "data_loader": {"train": dict(split), "validation": dict(split),
                           "batch_size": 1},
           "model": {k: v for k, v in CFG.items() if k != "every_x_rgb_frame"}}
    generate_split(str(tmp_path / "data/test"), n_sequences=1, n_frames=8,
                   height=40, width=70, events_per_frame=500)
    model = ERGB2DepthRecurrent(Config.from_dict(raw).model,
                                generator=torch.Generator().manual_seed(3))
    export_pth_tar(str(tmp_path / "model.pth.tar"), model, raw["arch"], raw)
    monkeypatch.setenv("PREPROCESSED_DATASETS_FOLDER", str(tmp_path / "data"))
    single = Spy(monkeypatch, gru_stream, "conv_gru_hside_stream")
    double = Spy(monkeypatch, gru_stream, "conv_gru_hside_stream_pair")
    preds = {}
    for name, over in (("auto", {}),
                       ("on", {"fused_stream": "on", "fused_pair": "on"})):
        path = tmp_path / f"config_{name}.json"
        path.write_text(json.dumps({**raw, "model": {**raw["model"], **over}}))
        preds[name] = {}
        eval_main(["--path_to_model", str(tmp_path / "model.pth.tar"),
                   "--config", str(path), "--data_folder", "test", "--crop",
                   "32,64", "--device", "cpu", "--scan_chunk", "2"],
                  on_prediction=preds[name].__setitem__)
        if name == "auto":
            assert (single.calls, double.calls) == (0, 0)
    # 4 packages in 2 chunks of 2, K + 1 steps each: one K10b and one K10a
    assert (single.calls, double.calls) == (4 * (K + 1), 4 * (K + 1))
    assert sorted(preds["on"]) == sorted(preds["auto"]) == [0, 1, 2, 3]
    for idx, p in preds["auto"].items():
        for k in p:
            assert np.abs(preds["on"][idx][k] - p[k]).max() < SLICE_TOL
