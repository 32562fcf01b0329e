"""The port's device voxelizers (kernels K6 and K7 in ops/voxel.py).

On the CPU each backend runs its plain version: 'scatter' (index_add_),
'matmul' (the one-hot product), 'sortseg' (K6's wrapper) and 'pallas'
(K7's wrapper).  Each is held against the JAX package's scatter, against
the JAX backend of its own name (the Pallas kernels in interpret mode, as
tests/test_ops.py runs them) and against the numpy oracle, at JAX's own
tolerance, atol/rtol 1e-4 (tests/test_ops.py:97); bfloat16 factors at
0.05 (tests/test_ops.py:85).  Cases: padding past n_valid, one bin, a
sparse 260x346 grid, timestamps near 1e3 s and events on bin boundaries.
The kernels themselves are tested on a card in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpg_ramnet_tpu.ops import voxel as jvoxel

from rpg_ramnet_tpu_torch.ops import voxel

TOL = 1e-4


def _events(n, height, width, seed, t0=0.0, span=0.05):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(t0, t0 + span, n))
    return np.stack([t, rng.randint(0, width, n), rng.randint(0, height, n),
                     rng.randint(0, 2, n)], axis=1).astype(np.float32)


def _boundary_events(nb, height, width):
    """Timestamps that put ts exactly on bin boundaries in float32."""
    ev = _events(4 * nb + 1, height, width, seed=11)
    ev[:, 0] = np.arange(4 * nb + 1, dtype=np.float32) / 4.0   # ts = k/4
    return ev


# name -> (events [N, 4] float32, n_valid, num_bins, height, width)
CASES = {
    "dense": lambda: (_events(2500, 40, 60, 1), 2500, 5, 40, 60),
    "padded": lambda: (np.concatenate([_events(1000, 40, 60, 2),
                                       np.zeros((500, 4), np.float32)]),
                       1000, 5, 40, 60),
    "single_bin": lambda: (_events(1500, 40, 60, 3), 1500, 1, 40, 60),
    "sparse_260x346": lambda: (np.concatenate([_events(64, 260, 346, 4),
                                               np.zeros((1984, 4), np.float32)]),
                               64, 5, 260, 346),
    "late_stamps": lambda: (_events(2000, 40, 60, 5, t0=1000.0), 2000, 5, 40, 60),
    "boundaries": lambda: (_boundary_events(5, 40, 60), 21, 5, 40, 60),
}
JAX_OWN = {"scatter": jvoxel.events_to_voxel_grid_scatter,
           "matmul": jvoxel.events_to_voxel_grid_matmul,
           "sortseg": jvoxel.events_to_voxel_grid_sortseg,
           "pallas": jvoxel.events_to_voxel_grid_pallas}


def _jax(fn, ev, n_valid, nb, h, w, **kw):
    return np.asarray(fn(jnp.asarray(ev), jnp.int32(n_valid), num_bins=nb,
                         height=h, width=w, **kw))


@pytest.mark.parametrize("backend", ["scatter", "matmul", "sortseg", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backend_matches_jax(case, backend):
    ev, n_valid, nb, h, w = CASES[case]()
    got = voxel.events_to_voxel_grid(torch.from_numpy(ev), n_valid,
                                     num_bins=nb, height=h, width=w,
                                     backend=backend)
    assert got.shape == (nb, h, w) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(
        got, _jax(jvoxel.events_to_voxel_grid_scatter, ev, n_valid, nb, h, w),
        atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _jax(JAX_OWN[backend], ev, n_valid, nb, h, w),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        got, jvoxel.events_to_voxel_grid_np(ev[:n_valid], nb, h, w),
        atol=TOL, rtol=TOL)


def test_auto_is_scatter_on_cpu_and_bf16_factors():
    ev, n_valid, nb, h, w = CASES["dense"]()
    t = torch.from_numpy(ev)
    auto = voxel.events_to_voxel_grid(t, n_valid, num_bins=nb, height=h, width=w)
    assert torch.equal(auto, voxel.events_to_voxel_grid_scatter(
        t, n_valid, num_bins=nb, height=h, width=w))
    got = voxel.events_to_voxel_grid_pallas(t, n_valid, num_bins=nb, height=h,
                                            width=w, factor_dtype=torch.bfloat16)
    want = _jax(jvoxel.events_to_voxel_grid_pallas, ev, n_valid, nb, h, w,
                factor_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=0.05)
    # no events: a zero grid; no counts moved on the CPU
    empty = voxel.events_to_voxel_grid(torch.zeros(0, 4), 0, num_bins=nb,
                                       height=h, width=w, backend="sortseg")
    assert empty.shape == (nb, h, w) and not empty.any()
    assert voxel.events_to_voxel_grid_sortseg.launches == 0
    assert voxel.events_to_voxel_grid_pallas.launches == 0


@pytest.mark.parametrize("case", ["dense", "sparse_260x346", "late_stamps"])
def test_stats_and_normalize_match_jax(case):
    ev, n_valid, nb, h, w = CASES[case]()
    grid, stats = voxel.events_to_voxel_grid_sortseg(
        torch.from_numpy(ev), n_valid, num_bins=nb, height=h, width=w,
        with_stats=True)
    j_grid, j_stats = jvoxel.events_to_voxel_grid_sortseg(
        jnp.asarray(ev), jnp.int32(n_valid), num_bins=nb, height=h, width=w,
        with_stats=True)
    np.testing.assert_allclose(grid.numpy(), np.asarray(j_grid), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose([float(s) for s in stats],
                               [float(s) for s in j_stats], atol=TOL, rtol=TOL)
    want = np.asarray(jvoxel.normalize_voxel_grid(j_grid))
    np.testing.assert_allclose(voxel.normalize_voxel_grid(grid).numpy(), want,
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(voxel.normalize_voxel_grid(grid, stats).numpy(),
                               want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        voxel.normalize_voxel_grid(grid).numpy(),
        voxel.normalize_voxel_grid_np(grid.numpy()), atol=TOL, rtol=TOL)
