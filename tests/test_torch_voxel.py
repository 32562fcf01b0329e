"""The port's device voxelizers (kernels K6 and K7 in ops/voxel.py).

On the CPU each backend runs its plain version: 'scatter' (index_add_),
'matmul' (the one-hot product), 'sortseg' (K6's wrapper) and 'pallas'
(K7's wrapper).  Each is held against the JAX package's scatter, against
the JAX backend of its own name (the Pallas kernels in interpret mode, as
tests/test_ops.py runs them) and against the numpy oracle, at JAX's own
tolerance, atol/rtol 1e-4 (tests/test_ops.py:97); bfloat16 factors at
0.05 (tests/test_ops.py:85).  Cases: padding past n_valid, one bin, a
sparse 260x346 grid, timestamps near 1e3 s and events on bin boundaries.

The kernels themselves run on a card only (tests/test_torch_cuda.py).
Here their plan and algorithm are held against JAX: the tile plan
(``voxel.tile_plan``) covers every cell once within the shared-memory
budget, and a plain-torch emulation of csrc/voxel.cu's count -> scan ->
partition -> accumulate, with its plan, band arithmetic and 8-byte
records, gives JAX's grids and stats, also on unsorted events, events in
one band and events outside the image.  The batched plain versions are
held against JAX's ``voxelize_batch`` on ragged windows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpg_ramnet_tpu.data.raw_pipeline import voxelize_batch
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


@pytest.mark.parametrize("path", [None, "one_pass", "tiled", "bogus"])
def test_kernel_wrappers_path_argument(path):
    """The kernels' path argument (None: the kernel's size rule; or a
    path by name) on a CPU tensor: the plain versions, JAX's grid, no
    launch; an unknown path raises before anything runs."""
    ev, n_valid, nb, h, w = CASES["dense"]()
    kw = dict(num_bins=nb, height=h, width=w, path=path)
    t = torch.from_numpy(ev)
    if path not in (None, *voxel.PATHS):
        with pytest.raises(ValueError, match="path"):
            voxel.events_to_voxel_grid_sortseg(t, n_valid, **kw)
        with pytest.raises(ValueError, match="path"):
            voxel.events_to_voxel_grid_pallas(t, n_valid, **kw)
        return
    want = _jax(jvoxel.events_to_voxel_grid_scatter, ev, n_valid, nb, h, w)
    grid, stats = voxel.events_to_voxel_grid_sortseg(t, n_valid, with_stats=True, **kw)
    np.testing.assert_allclose(grid.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(voxel.events_to_voxel_grid_pallas(t, n_valid, **kw).numpy(),
                               want, atol=TOL, rtol=TOL)
    for f in (voxel.events_to_voxel_grid_sortseg, voxel.events_to_voxel_grid_pallas):
        assert f.launches == 0 and f.path_launches == dict.fromkeys(voxel.PATHS, 0)


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


def tile_cells(plan, tile, height, width):
    """[start, stop) of a tile's cells in its window's flat grid, as
    csrc/voxel.cu's accumulate writes them: bin * height + the band's rows."""
    b, band = divmod(tile, plan.bands)
    r0 = band * plan.rows
    r1 = min(height, r0 + plan.rows)
    return (b * height + r0) * width, (b * height + r1) * width


@pytest.mark.parametrize("shape", [(5, 260, 346), (5, 256, 512), (15, 480, 640),
                                   (1, 40, 60), (3, 1, 346)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_covers_grid(shape):
    """Bands of at most TILE_BYTES (fewer rows where a launch would have
    fewer than TILE_BLOCKS tiles), ceil(H / rows) bands per bin, and the
    tiles, in id order, cover the grid's cells once and contiguously; the
    kernel's tile id and cell offset of (bin, y, x) land in that cell."""
    nb, h, w = shape
    for windows in (1, 800):
        plan = voxel.tile_plan(nb, h, w, windows)
        assert 1 <= plan.rows <= h and plan.rows * 4 * w <= voxel.TILE_BYTES
        assert plan.tile_bytes == plan.rows * 4 * w <= voxel.SMEM_BYTES
        assert plan.bands == -(-h // plan.rows) and plan.tiles == nb * plan.bands
        if windows * plan.tiles < voxel.TILE_BLOCKS:
            assert plan.rows == 1
        starts = [tile_cells(plan, t, h, w) for t in range(plan.tiles)]
        assert starts[0][0] == 0 and starts[-1][1] == nb * h * w
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(starts, starts[1:]))
        b, y, x = np.meshgrid(np.arange(nb), np.arange(h), np.arange(w), indexing="ij")
        band = y // plan.rows
        tile = b * plan.bands + band
        cell = (y - band * plan.rows) * w + x
        lo = np.array(starts)[tile, 0]
        np.testing.assert_array_equal(lo + cell, (b * h + y) * w + x)
    with pytest.raises(ValueError):
        voxel.tile_plan(1, 4, voxel.SMEM_BYTES // 4 + 1)


def _pack(cell, val):
    """The kernel's 8-byte record (uint2: cell offset, float32 bits) as one
    little-endian int64."""
    return cell.to(torch.int64) | (val.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) << 32


def _unpack(rec):
    return rec & 0xFFFFFFFF, ((rec >> 32) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)


def emulate_kernel(events, counts, num_bins, height, width, bf16=False,
                   chunk=2048):
    """csrc/voxel.cu's tiled path in plain torch on the CPU: (grids [B, nb,
    H, W], stats [B, 3]).  Bucket pass, per chunk of ``chunk`` events (the
    kernel's kChunk; the grid does not depend on it): each
    contribution's tile (bin * bands + y // rows) and cell offset in it,
    the tiles' histogram and its exclusive scan, the records staged in
    tile order.  Accumulate pass, per tile: its segment of every chunk's
    region added into the tile, written once over its cells; the nonzero
    cells' count, sum and sum of squares.  Unwritten cells stay NaN."""
    B, N = events.shape[:2]
    plan = voxel.tile_plan(num_bins, height, width, B)
    rows, bands, tiles = plan.rows, plan.bands, plan.tiles
    grid = torch.full((B, num_bins * height * width), float("nan"))
    stats = torch.zeros(B, 3)
    for w in range(B):
        n = min(max(int(counts[w]), 0), N)
        ev = events[w]
        regions, starts = [], []
        if n:
            first = ev[0, 0]
            dt = ev[n - 1, 0] - first
            dt = torch.where(dt == 0, torch.ones_like(dt), dt)
        for c0 in range(0, n, chunk):
            e = ev[c0:min(n, c0 + chunk)]
            ts = (num_bins - 1) * (e[:, 0] - first) / dt
            tis = ts.to(torch.int32)
            dts = ts - tis
            x, y = e[:, 1].to(torch.int32), e[:, 2].to(torch.int32)
            pol = torch.where(e[:, 3] == 0, -1.0, e[:, 3])
            inside = (tis >= 0) & (x >= 0) & (x < width) & (y >= 0) & (y < height)
            ok = [inside & (tis < num_bins), inside & (tis < num_bins - 1)]
            vals = [pol * (1.0 - dts), pol * dts]
            if bf16:
                vals = [v.to(torch.bfloat16).float() for v in vals]
            band = torch.div(y, rows, rounding_mode="floor")
            cell = (y - band * rows) * width + x
            tile = [tis * bands + band, (tis + 1) * bands + band]
            t = torch.cat([tile[0][ok[0]], tile[1][ok[1]]]).long()
            rec = _pack(torch.cat([cell[ok[0]], cell[ok[1]]]),
                        torch.cat([vals[0][ok[0]], vals[1][ok[1]]]))
            hist = torch.bincount(t, minlength=tiles)
            starts.append(torch.cat([torch.zeros(1, dtype=torch.long), hist.cumsum(0)]))
            regions.append(rec[torch.argsort(t, stable=True)])
        for t in range(tiles):
            lo, hi = tile_cells(plan, t, height, width)
            acc = torch.zeros(hi - lo)
            for rec, st in zip(regions, starts):
                cell, val = _unpack(rec[st[t]:st[t + 1]])
                acc.index_add_(0, cell, val)
            grid[w, lo:hi] = acc
            nz = acc[acc != 0]
            stats[w] += torch.stack([torch.tensor(float(nz.numel())), nz.sum(),
                                     (nz * nz).sum()])
    return grid.reshape(B, num_bins, height, width), stats


def _unsorted_case():
    ev, n_valid, nb, h, w = CASES["dense"]()
    rng = np.random.RandomState(12)
    ev[1:n_valid - 1] = ev[1 + rng.permutation(n_valid - 2)]   # first, last kept
    return ev, n_valid, nb, h, w


def _one_band_case():
    ev = _events(3000, 260, 346, seed=13)
    ev[:, 2] = np.random.RandomState(13).randint(16, 18, len(ev))
    return ev, len(ev), 5, 260, 346


def _outside_case():
    ev = _events(2500, 40, 60, seed=14)
    ev[1:1200:7, 1] = 60.0           # x outside the image
    ev[2:1200:11, 2] = -1.0          # y outside the image
    ev[3:1200:13, 1] = -3.0
    return ev, len(ev), 5, 40, 60


EMULATION_CASES = {**CASES, "unsorted": _unsorted_case, "one_band": _one_band_case,
                   "outside": _outside_case}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_kernel_emulation_matches_jax(case):
    """The emulated kernel against JAX's scatter (float32 values) and its
    Pallas kernel with bfloat16 factors in interpret mode (bf16 values, at
    0.05; against the port's bf16 one-hot product at 1e-4), its stats
    against JAX's sortseg with_stats, every cell written once.  Events
    outside the image are dropped: JAX gets the events inside (the window's
    first and last are)."""
    ev, n_valid, nb, h, w = EMULATION_CASES[case]()
    got, stats = emulate_kernel(torch.from_numpy(ev)[None], [n_valid], nb, h, w)
    got_b, _ = emulate_kernel(torch.from_numpy(ev)[None], [n_valid], nb, h, w, bf16=True)
    assert not got.isnan().any() and not got_b.isnan().any()
    inside = ev[:n_valid]
    inside = inside[(inside[:, 1] >= 0) & (inside[:, 1] < w)
                    & (inside[:, 2] >= 0) & (inside[:, 2] < h)]
    n_in = len(inside)
    want = _jax(jvoxel.events_to_voxel_grid_scatter, inside, n_in, nb, h, w)
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)
    want_b = _jax(jvoxel.events_to_voxel_grid_pallas, inside, n_in, nb, h, w,
                  factor_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got_b[0].numpy(), want_b, atol=0.05)
    np.testing.assert_allclose(
        got_b[0].numpy(), voxel.events_to_voxel_grid_matmul(
            torch.from_numpy(inside), n_in, num_bins=nb, height=h, width=w,
            factor_dtype=torch.bfloat16).numpy(), atol=TOL, rtol=TOL)
    _, j_stats = jvoxel.events_to_voxel_grid_sortseg(
        jnp.asarray(inside), jnp.int32(n_in), num_bins=nb, height=h, width=w,
        with_stats=True)
    np.testing.assert_allclose(stats[0].numpy(), [float(s) for s in j_stats],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("backend", ["scatter", "sortseg", "pallas"])
def test_batched_backends_match_voxelize_batch(backend):
    """A batch of ragged windows (one of them empty) through the port's
    entry point on the CPU (the wrappers' batched plain versions: one
    index_add_ with window offsets, a loop of one-hot products) against
    JAX's voxelize_batch(normalize=False), whose grids are HWC; the port's
    sortseg stats per window against its grids' own."""
    rng = np.random.RandomState(21)
    counts = np.array([1500, 0, 700, 1, 1499], np.int32)
    ev = np.zeros((len(counts), 1500, 4), np.float32)
    for b, n in enumerate(counts):
        ev[b, :n] = _events(int(n), 40, 60, seed=30 + b)
    ev[2, 700:] = rng.uniform(0, 1, (800, 4))         # padding past the count
    want = np.asarray(voxelize_batch(jnp.asarray(ev), jnp.asarray(counts),
                                     num_bins=5, height=40, width=60,
                                     backend=backend, normalize=False))
    got = voxel.events_to_voxel_grid(torch.from_numpy(ev), torch.from_numpy(counts),
                                     num_bins=5, height=40, width=60, backend=backend)
    assert got.shape == (5, 5, 40, 60)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=TOL, rtol=TOL)
    assert not got[1].any()
    if backend == "sortseg":
        grid, stats = voxel.events_to_voxel_grid_sortseg(
            torch.from_numpy(ev), counts.tolist(), num_bins=5, height=40, width=60,
            with_stats=True)
        assert torch.equal(grid, got) and all(s.shape == (5,) for s in stats)
        for s, r in zip(stats, voxel.voxel_stats(grid)):
            torch.testing.assert_close(s, r)
