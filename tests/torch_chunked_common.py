"""Shared inputs of the port's tests of the chunked path's launch variants
(tests/test_torch_gru_pair.py, test_torch_gru_stream.py,
test_torch_gru_chunk.py): a JAX ConvGRU param dict with the port's cell
holding the same weights, and one tiny flagship-shaped model in both
packages, with the sequences and forward calls that compare them.
"""
import contextlib
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.core.config import ModelConfig as JaxModelConfig
from rpg_ramnet_tpu.models import ERGB2DepthRecurrent as JaxModel
from rpg_ramnet_tpu.models import layers as JL

from rpg_ramnet_tpu_torch.compat import params_from_jax, params_to_state_dict
from rpg_ramnet_tpu_torch.core.config import ModelConfig
from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.models.layers import ConvGRU

PREFIX = "statenetphasedrecurrent."
OP_TOL = 2e-2      # a few bf16 cells: eps 7.8e-3, a few roundings stack
SLICE_TOL = 5e-2   # sigmoid maps after L*(K+1) bf16 cells, as the JAX
                   # package's own tests (tests/test_batched_streaming.py)
# the tiny recipe of tests/test_batched_streaming.py:642-646 with base 8,
# since the port's kernels take C % 16 == 0 (scales of C 16, 32, 64)
CFG = dict(num_bins_rgb=1, num_bins_events=5, recurrent_block_type="conv",
           state_combination="convgru", num_encoders=3, base_num_channels=8,
           num_residual_blocks=1, every_x_rgb_frame=2, baseline=False,
           skip_type="sum", norm="none", compute_dtype="bfloat16")


def cell(C, seed):
    """A JAX ConvGRU param dict (input C, hidden C) and the port's ConvGRU
    with its weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    c = ConvGRU(C, C)
    c.load_state_dict({k[len(PREFIX):]: torch.from_numpy(np.array(v))
                       for k, v in params_to_state_dict(p).items()},
                      strict=True)
    return p, c


def folded(c, dtype=torch.bfloat16):
    """The port cell's folded h-side weights in dtype."""
    with torch.no_grad():
        return c.hside_weights(dtype)


def as_jax(x, dtype=jnp.bfloat16):
    return jnp.asarray(x, dtype)


def as_torch(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def leaves(supers):
    """The super states' tensors (ConvLSTM pairs flattened), as float32
    numpy."""
    if isinstance(supers, (tuple, list)):
        return [a for s in supers for a in leaves(s)]
    return [to_np(supers)]


def models(**over):
    """(JAX config, JAX params, the port's model with those weights)."""
    d = {**CFG, **over}
    jcfg = JaxModelConfig.from_dict(d)
    params = JaxModel.init_params(jax.random.PRNGKey(0), jcfg)
    model = ERGB2DepthRecurrent(ModelConfig.from_dict(d))
    params_from_jax(model, params)
    return jcfg, params, model


def with_cfg(model, **over):
    """The model with its config's fields replaced (the weights shared)."""
    model.cfg = dataclasses.replace(model.cfg, **over)
    return model


def sequence(L, K, H, W, seed=0, B=1):
    rng = np.random.RandomState(seed)
    return {"events": rng.randn(B, L, K, H, W, 5).astype(np.float32),
            "image": rng.rand(B, L, H, W, 1).astype(np.float32)}


def jax_forward(jcfg, params, seq, **kw):
    """JAX forward_sequence_precomputed from the zero state: (supers,
    preds) as float32 numpy."""
    B, _, _, H, W = seq["events"].shape[:5]
    fwd = jax.jit(lambda p, s, x: JaxModel.forward_sequence_precomputed(
        p, jcfg, s, x, **kw))
    state, preds = fwd(params, JaxModel.init_state(jcfg, B, H, W),
                       {k: jnp.asarray(v) for k, v in seq.items()})
    return leaves(state.super_states), {k: to_np(v) for k, v in preds.items()}


def port_forward(model, seq, **kw):
    """The port's forward_sequence_precomputed from the zero state: (supers,
    preds) as float32 numpy."""
    B, _, _, H, W = seq["events"].shape[:5]
    state, preds = model.forward_sequence_precomputed(
        model.init_state(B, H, W),
        {k: torch.from_numpy(v) for k, v in seq.items()}, **kw)
    return leaves(state.super_states), {k: to_np(v) for k, v in preds.items()}


def max_diff(a, b):
    """Max abs difference of two dicts of arrays (or two lists)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(float(np.abs(a[k] - b[k]).max()) for k in a)
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@contextlib.contextmanager
def interpret(*modules):
    """Run the JAX modules' Pallas kernels in interpret mode."""
    old = [m._INTERPRET for m in modules]
    for m in modules:
        m._INTERPRET = True
    try:
        yield
    finally:
        for m, o in zip(modules, old):
            m._INTERPRET = o


class Spy:
    """Counts the calls of a module function it replaces (monkeypatch)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)
