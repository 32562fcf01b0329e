"""The port's data-parallel training step in two processes against one
process and against JAX.

One pair of gloo ranks on localhost (tests/torch_dist_worker.py, started
as torchrun starts ranks, OMP_NUM_THREADS=1) runs every case of
tests/torch_dist_cases.py in turn, each rank on its share of the case's
global batch (B=4), and writes the loss, grad_norm and the state dict
after one SGD step at lr 1 (the parameters minus the gradients).  The
pair is started once for the module.  Per case:

- the two ranks hold one model after the step, BN's running stats
  included, bit for bit;
- loss and grad_norm equal the port's single-process step on the global
  batch (rtol 1e-5 and 1e-4, JAX's own bounds, tests/test_distributed.py:
  86-87), and so does every parameter and running stat;
- they equal JAX's ``make_train_step`` on the global batch: loss rtol
  1e-5, the parameters after the step (so the gradients) at the JAX
  package's training tolerance (atol 5e-5, rtol 1e-3), the running stats
  at atol 1e-6.  The plain and uneven-NaN cases run the JAX step on a
  2-device mesh.

The cases: plain, grad_accum 2 (a rank's items are its share of each
micro-batch, interleaved), the gradient loss (scaled by the global
batch), BN in training mode (global batch statistics), and NaN targets
on rank 0's items only (every masked mean over the global valid count).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.core.config import Config as JaxConfig
from rpg_ramnet_tpu.parallel import make_mesh, replicate, shard_batch
from rpg_ramnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from rpg_ramnet_tpu.train.train_step import make_train_step as jax_train_step

from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
from rpg_ramnet_tpu_torch.train.optim import make_optimizer
from rpg_ramnet_tpu_torch.train.train_step import make_train_step

from test_torch_lanes import _jax_tree, _one_thread  # noqa: F401
from torch_dist_cases import CASES, case_config, case_raw, global_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_GRAD, RTOL_GRAD = 5e-5, 1e-3
ATOL_STATS = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Pair:
    """The two ranks, started; ``get()`` waits for them once and returns
    (results per case, [rank 0's, rank 1's] state dict per case)."""

    def __init__(self, procs, out):
        self.procs, self.out, self._got = procs, out, None

    def get(self):
        if self._got is None:
            logs = [p.communicate(timeout=180)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-3000:]
            with open(self.out / "results.json") as f:
                results = json.load(f)
            assert results["world"] == 2 and results["regathered"]
            self._got = results["cases"], {
                c: [dict(np.load(self.out / f"{c}_rank{r}.npz"))
                    for r in (0, 1)] for c in CASES}
        return self._got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The pair, started once for the module; each test computes its
    references before it waits, so the ranks run meanwhile."""
    out = tmp_path_factory.mktemp("dp_ranks")
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
           "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "tests/torch_dist_worker.py", str(out)], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        yield _Pair(procs, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _single(case):
    """The port's one-process step on the global batch: (aux, state dict
    after it, the state dict before it)."""
    cfg = case_config(case)
    model = ERGB2DepthRecurrent(cfg.model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    aux = make_train_step(cfg, model, make_optimizer(cfg, model.parameters()))(
        {k: torch.from_numpy(v) for k, v in global_batch(case).items()})
    return aux, {k: v.numpy() for k, v in model.state_dict().items()}, before


# the cases on JAX's 2-device data mesh ('nan_uneven' shares the plain
# config, so its compiled step)
ON_MESH = ("plain", "nan_uneven")
_JAX_STEPS = {}


def _jax_step(case, before):
    """JAX's make_train_step on the global batch from the same weights
    (the ON_MESH cases over a 2-device data mesh): (aux, state dict)."""
    raw = case_raw(case)
    jcfg = JaxConfig.from_dict(raw)
    model = ERGB2DepthRecurrent(case_config(case).model)
    model.load_state_dict(before)
    params = _jax_tree(model)
    opt = jax_make_optimizer(jcfg)
    batch = global_batch(case)
    mesh = (make_mesh(devices=jax.devices()[:2]) if case in ON_MESH
            else None)
    key = (json.dumps(raw, sort_keys=True), mesh is not None)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax_train_step(jcfg, opt, mesh=mesh, donate=False)
    step = _JAX_STEPS[key]
    if mesh is not None:
        new, _, aux = step(replicate(params, mesh),
                           replicate(opt.init(params), mesh),
                           shard_batch(batch, mesh))
    else:
        new, _, aux = step(params, opt.init(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return aux, params_to_state_dict(jax.device_get(new))


def _close(got, want, name, stats_atol=ATOL_STATS):
    if ".running_" in name:
        np.testing.assert_allclose(got, want, atol=stats_atol, rtol=0,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL_GRAD, rtol=RTOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_jax_train_step(ranks, case):
    cfg = case_config(case)
    before = ERGB2DepthRecurrent(cfg.model).state_dict()
    aux, want = _jax_step(case, before)
    results, sds = ranks.get()
    np.testing.assert_allclose(results[case]["loss"], float(aux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(results[case]["grad_norm"],
                               float(aux["grad_norm"]), rtol=1e-4)
    got = sds[case][0]
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        _close(v, np.asarray(want[name]), name)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_the_single_process_step(ranks, case):
    aux, want, before = _single(case)
    results, sds = ranks.get()
    got = results[case]
    np.testing.assert_allclose(got["loss"], aux["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], aux["grad_norm"], rtol=1e-4)
    moved = 0
    for name, v in sds[case][0].items():
        _close(v, want[name], name)
        moved += not np.array_equal(v, before[name].numpy())
    assert moved > len(want) // 2


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_one_model(ranks, case):
    _, sds = ranks.get()
    r0, r1 = sds[case]
    assert sorted(r0) == sorted(r1)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    if case == "bn_train":
        assert any(".running_" in n for n in r0)
