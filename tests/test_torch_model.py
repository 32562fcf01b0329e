"""The ported slice end to end: ERGB2DepthRecurrent.forward_sequence_precomputed
against the JAX package's, and the inference engine's chunking semantics.

Tiny flagship-shaped config: 2 encoders, base 8, 1 residual block, K=2,
32x64, L=3 packages run as chunks of 2 with the state carried.  Float32 at
2e-5 (tests/test_model_parity.py); bf16 against the JAX Pallas h-side
kernel in interpret mode at 5e-2 on the sigmoid predictions.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.ops import gru_hside as jax_gru_hside

from rpg_ramnet_tpu_torch.compat import load_reference_checkpoint, params_from_jax
from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.eval import SequenceScanInference, run_chunked_streaming
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent, statenet
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_F32 = 2e-5
ATOL_BF16 = 5e-2
H, W, L, CHUNK, K = 32, 64, 3, 2, 2
CFG = dict(num_bins_rgb=1, num_bins_events=5, skip_type="sum",
           state_combination="convgru", num_encoders=2, base_num_channels=8,
           num_residual_blocks=1, recurrent_block_type="conv", norm="none",
           use_upsample_conv=True, every_x_rgb_frame=K, baseline=False)


def _models(**over):
    d = {**CFG, **over}
    jcfg = JaxModelConfig.from_dict(d)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    params_from_jax(model, params)
    return jcfg, params, model


def _sequence(seed=0, n=L):
    rng = np.random.RandomState(seed)
    return {"events": rng.randn(1, n, K, H, W, 5).astype(np.float32),
            "image": rng.rand(1, n, H, W, 1).astype(np.float32)}


def _jax_chunks(jcfg, params, seq):
    fwd = jax.jit(lambda p, s, sub: JaxModel.forward_sequence_precomputed(
        p, jcfg, s, sub))
    state = JaxModel.init_state(jcfg, 1, H, W)
    outs = []
    for t0 in range(0, L, CHUNK):
        sub = {k: v[:, t0:t0 + CHUNK] for k, v in seq.items()}
        state, preds = fwd(params, state, sub)
        outs.append({k: np.asarray(v, np.float32) for k, v in preds.items()})
    preds = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return [np.asarray(s, np.float32) for s in state.super_states], preds


def _port_chunks(model, seq):
    state = model.init_state(1, H, W)
    outs = []
    for t0 in range(0, L, CHUNK):
        sub = {k: torch.from_numpy(v[:, t0:t0 + CHUNK]) for k, v in seq.items()}
        state, preds = model.forward_sequence_precomputed(state, sub)
        outs.append({k: v.float().numpy() for k, v in preds.items()})
    preds = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return [s.float().numpy() for s in state.super_states], preds


def _package_loop(model, seq):
    """The port's reference path: forward_package per package."""
    state = model.init_state(1, H, W)
    preds = {}
    with torch.inference_mode():
        for t in range(seq["image"].shape[1]):
            pkg = {k: torch.from_numpy(v[:, t]) for k, v in seq.items()}
            state, p = model.forward_package(state, pkg)
            for k, v in p.items():
                preds.setdefault(k, []).append(v.numpy())
    return ([s.numpy() for s in state.super_states],
            {k: np.stack(v) for k, v in preds.items()})


def test_slice_f32_matches_jax_and_package_loop():
    jcfg, params, model = _models()
    seq = _sequence()
    j_state, j_preds = _jax_chunks(jcfg, params, seq)
    t_state, t_preds = _port_chunks(model, seq)
    l_state, l_preds = _package_loop(model, seq)
    assert set(t_preds) == {"events0", "events1", "image"}
    for k in j_preds:
        assert t_preds[k].shape == (L, 1, H, W, 1)
        np.testing.assert_allclose(t_preds[k], j_preds[k], atol=ATOL_F32)
        np.testing.assert_allclose(t_preds[k], l_preds[k], atol=ATOL_F32)
    for a, b, c in zip(t_state, j_state, l_state):
        np.testing.assert_allclose(a, b, atol=ATOL_F32)
        np.testing.assert_allclose(a, c, atol=ATOL_F32)
    # decode_keys decodes a subset and leaves the recurrence alone
    sub = {k: torch.from_numpy(v[:, :CHUNK]) for k, v in seq.items()}
    _, only = model.forward_sequence_precomputed(
        model.init_state(1, H, W), sub, decode_keys=("image",))
    assert set(only) == {"image"}
    np.testing.assert_allclose(only["image"].numpy(), t_preds["image"][:CHUNK],
                               atol=ATOL_F32)


def test_slice_bf16_matches_jax_pallas_kernel():
    jcfg, params, model = _models(compute_dtype="bfloat16", fused_gru="on")
    # the port's 'on' needs CUDA; 'auto' on the CPU runs the kernel's plain
    # version, the counterpart of the JAX kernel in interpret mode
    model.cfg = dataclasses.replace(model.cfg, fused_gru="auto")
    seq = _sequence()
    old = jax_gru_hside._INTERPRET
    jax_gru_hside._INTERPRET = True
    try:
        _, j_preds = _jax_chunks(jcfg, params, seq)
    finally:
        jax_gru_hside._INTERPRET = old
    _, t_preds = _port_chunks(model, seq)
    for k in j_preds:
        d = np.abs(t_preds[k] - j_preds[k]).max()
        assert d < ATOL_BF16, (k, d)


class _Seq:
    """One sequence in the dataset contract of run_chunked_streaming."""

    def __init__(self, seq):
        self.seq = seq

    def __len__(self):
        return self.seq["image"].shape[1]

    def __getitem__(self, i):
        return {k: v[0, i:i + 1] for k, v in self.seq.items()}


def test_chunked_streaming_carries_pads_and_resets():
    """Chunks of 2 over sequences of 3 and 2 packages: the state carries
    across the chunks of a sequence, the tail chunk is padded, and the
    second sequence starts from zero — so every prediction equals a fresh
    forward_package loop over its own sequence."""
    _, _, model = _models()
    seqs = [_sequence(1, 3), _sequence(2, 2)]

    class Dataset:
        datasets = [_Seq(s) for s in seqs]

    got = {}
    run_chunked_streaming(Dataset(), model, chunk=CHUNK, precompute_x=True,
                          on_prediction=lambda g, p, item, pos:
                          got.__setitem__(g, (pos, p)))
    assert sorted(got) == [0, 1, 2, 3, 4]
    offset = 0
    for seq in seqs:
        _, want = _package_loop(model, seq)
        for t in range(seq["image"].shape[1]):
            pos, p = got[offset + t]
            assert pos == t
            for k in want:
                np.testing.assert_allclose(p[k], want[k][t, 0], atol=ATOL_F32)
        offset += seq["image"].shape[1]
    engine = SequenceScanInference(model, chunk=CHUNK, batched_decode=True,
                                   precompute_x=True)
    out = engine.run_sequence(seqs[0]["events"][0], seqs[0]["image"][0])
    np.testing.assert_allclose(out["image"][2], got[2][1]["image"], atol=0)
    # float32 without precompute_x: forward_sequence_batched_decode, the
    # whole cells per step, as the JAX engine
    plain = SequenceScanInference(model, chunk=CHUNK, batched_decode=True
                                  ).run_sequence(
        seqs[0]["events"][0], seqs[0]["image"][0])
    np.testing.assert_allclose(plain["image"], out["image"], atol=ATOL_F32)


def test_config_checkpoint_and_unported_paths(tmp_path):
    cfg = ModelConfig.load(os.path.join(
        REPO, "configs/train_e2depth_si_grad_loss_statenet_ergb_tpu_bf16.json"))
    assert (cfg.num_encoders, cfg.base_num_channels, cfg.every_x_rgb_frame,
            cfg.compute_dtype, cfg.norm) == (3, 32, 5, "bfloat16", None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        statenet.check_supported(dataclasses.replace(
            cfg, baseline="rgb", state_combination="convlstm"))
    _, _, model = _models()
    # the resident-state kernel K11 takes bf16 states only (the JAX
    # package's ValueError)
    seq = {k: torch.from_numpy(v) for k, v in _sequence(n=1).items()}
    with pytest.raises(ValueError, match="chunk_cells"):
        model.forward_sequence_precomputed(
            model.init_state(1, H, W), seq, chunk_cells=True)
    path = tmp_path / "model.pth.tar"
    torch.save({"state_dict": model.state_dict()}, path)
    other = ERGB2DepthRecurrent(model.cfg, generator=torch.Generator().manual_seed(1))
    load_reference_checkpoint(other, str(path))
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_params_to_state_dict_matches_jax_package():
    """The port's own copy against the JAX package's on flagship params:
    the same names and arrays, the OIHW transposes included."""
    from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict as jax_sd
    from rpg_ramnet_tpu_torch.compat import params_to_state_dict
    jcfg = JaxModelConfig.from_dict(dict(CFG, num_encoders=3,
                                         base_num_channels=32,
                                         num_residual_blocks=2,
                                         every_x_rgb_frame=5))
    params = jax.tree_util.tree_map(
        np.asarray, JaxModel.init_params(jax.random.PRNGKey(1), jcfg))
    got, want = params_to_state_dict(params), jax_sd(params)
    assert list(got) == list(want) and len(got) > 50
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    assert got["statenetphasedrecurrent.head_events.conv2d.weight"].shape == \
        (32, 5, 5, 5)


def test_port_imports_no_jax():
    code = (
        "import sys, torch, numpy as np\n"
        "import rpg_ramnet_tpu_torch.compat, rpg_ramnet_tpu_torch.eval\n"
        "import rpg_ramnet_tpu_torch.kernels, rpg_ramnet_tpu_torch.utils\n"
        "import rpg_ramnet_tpu_torch.data, rpg_ramnet_tpu_torch.train.trainer\n"
        "import rpg_ramnet_tpu_torch.train.__main__\n"
        "import rpg_ramnet_tpu_torch.eval.__main__, rpg_ramnet_tpu_torch.stream\n"
        "import rpg_ramnet_tpu_torch.eval.filters, rpg_ramnet_tpu_torch.eval.writers\n"
        "import rpg_ramnet_tpu_torch.eval.evaluation\n"
        "import rpg_ramnet_tpu_torch.ops.voxel, rpg_ramnet_tpu_torch.ops.event_preprocess\n"
        "import rpg_ramnet_tpu_torch.utils.event_readers, rpg_ramnet_tpu_torch.options\n"
        "import rpg_ramnet_tpu_torch.ops.gru_pair, rpg_ramnet_tpu_torch.ops.gru_stream\n"
        "import rpg_ramnet_tpu_torch.ops.gru_chunk\n"
        "import rpg_ramnet_tpu_torch.data.raw_pipeline, rpg_ramnet_tpu_torch.eval.display\n"
        "import rpg_ramnet_tpu_torch.train.frame_trainer, rpg_ramnet_tpu_torch.utils.timers\n"
        "import rpg_ramnet_tpu_torch.core.registry\n"
        "import rpg_ramnet_tpu_torch.parallel, rpg_ramnet_tpu_torch.entry\n"
        "import rpg_ramnet_tpu_torch.parallel.distributed\n"
        "from rpg_ramnet_tpu_torch.core.config import Config, TrainerConfig\n"
        "from rpg_ramnet_tpu_torch.train.optim import make_optimizer\n"
        "from rpg_ramnet_tpu_torch.train.train_step import make_train_step\n"
        "from rpg_ramnet_tpu_torch.core.config import ModelConfig\n"
        "from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent\n"
        "cfg = ModelConfig(num_encoders=2, base_num_channels=8,\n"
        "    recurrent_block_type='conv', state_combination='convgru',\n"
        "    num_residual_blocks=1, every_x_rgb_frame=2,\n"
        "    compute_dtype='bfloat16')\n"
        "m = ERGB2DepthRecurrent(cfg)\n"
        "seq = {'events': torch.randn(1, 2, 2, 16, 32, 5),\n"
        "       'image': torch.rand(1, 2, 16, 32, 1)}\n"
        "_, p = m.forward_sequence_precomputed(m.init_state(1, 16, 32), seq)\n"
        "assert p['image'].shape == (2, 1, 16, 32, 1)\n"
        "for kw in ({'chunk_cells': True}, {'stream_cells': True}):\n"
        "    _, q = m.forward_sequence_precomputed(m.init_state(1, 16, 32), seq, **kw)\n"
        "    assert (q['image'] - p['image']).abs().max() < 5e-2\n"
        "c = Config(model=cfg, trainer=TrainerConfig(\n"
        "    deferred_decode=True, precompute_x=True, sequence_length=2))\n"
        "step = make_train_step(c, m, make_optimizer(c, m.parameters()))\n"
        "aux = step({**seq, 'depth_events': torch.rand(1, 2, 2, 16, 32, 1),\n"
        "            'depth_image': torch.rand(1, 2, 16, 32, 1)})\n"
        "assert aux['loss'] == aux['loss']\n"
        "from rpg_ramnet_tpu_torch.compat import params_from_jax\n"
        "# a JAX-layout numpy param tree (HWIO, lists) of m's weights\n"
        "sd = m.state_dict()\n"
        "tree = {}\n"
        "for name, v in sd.items():\n"
        "    node = tree\n"
        "    parts = name.split('.')[1:]\n"
        "    for p in parts[:-1]:\n"
        "        node = node.setdefault(p, {})\n"
        "    a = v.float().numpy()\n"
        "    node[parts[-1]] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a\n"
        "def lists(n):\n"
        "    if isinstance(n, dict) and n and all(k.isdigit() for k in n):\n"
        "        return [lists(n[str(i)]) for i in range(len(n))]\n"
        "    return {k: lists(v) for k, v in n.items()} if isinstance(n, dict) else n\n"
        "m2 = ERGB2DepthRecurrent(cfg, generator=torch.Generator().manual_seed(7))\n"
        "params_from_jax(m2, lists(tree))\n"
        "assert all(torch.equal(a, b) for a, b in zip(sd.values(), m2.state_dict().values()))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'rpg_ramnet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
