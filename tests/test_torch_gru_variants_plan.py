"""The gx-streaming cell K10a and the whole-chunk cell K11 on K1's tile
(ops/gru_stream.py, ops/gru_chunk.py; csrc/gru_hside.cu, gru_chunk.cu):
their decompositions in plain torch (tests/k1_emulation.py) against the
JAX Pallas kernels in interpret mode under plans with ragged tiles, a tile
beyond the image, 1x1 tiles and cluster splits; K11's planner (the
clusters of its plan fit the resident count it is given, plan_k1's plan
wherever that one fits, a looping grid where none does, ``blocks``
rounded or refused); the private plan argument of both wrappers on the
CPU; the ctypes signatures against the C entries; the gates ``supports``
and ``gru_chunk.supports`` unchanged.  The kernels themselves are tested
on a card in tests/test_torch_cuda.py.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpg_ramnet_tpu.ops import gru_chunk as jax_gru_chunk
from rpg_ramnet_tpu.ops import gru_stream as jax_gru_stream

from rpg_ramnet_tpu_torch.ops import gru_chunk, gru_hside, gru_pair, gru_stream
from rpg_ramnet_tpu_torch.ops.gru_hside import K1Plan

from k1_emulation import EMULATED, k1_emulated, k11_emulated, k11_walk
from torch_chunked_common import cell, folded

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "rpg_ramnet_tpu_torch" / "csrc"
F32 = torch.float32
# (H, W, C, plan) of tests/k1_emulation.py's plans, at batch 1 (K10a and
# K11 are single-stream)
PLANS = [(H, W, C, plan) for _, H, W, C, plan in EMULATED]
PLAN_IDS = ["x".join(map(str, (H, W, C) + tuple(plan))) for H, W, C, plan in PLANS]
# the clusters an H100 holds at once of K1's flagship plans, one block per
# SM (chip_smoke.py phase 14 reports K11's own count)
RESIDENT = {1: 132, 2: 66}
WIDTHS = (16, 32, 48, 64, 96, 128, 256)
# (H, W) of the flagship chunked-inference cells, the training cells and
# the ragged and edge cells of chip_smoke.py, at batch 1
CELLS = ((128, 256), (64, 128), (32, 64), (112, 112), (56, 56), (28, 28),
         (30, 45), (5, 40), (9, 3), (1, 1), (17, 19))
FLAGSHIP = ((128, 256, 64), (64, 128, 128), (32, 64, 256))


def resident(plan):
    return RESIDENT[plan.split]


def _weights(C, seed):
    """A JAX ConvGRU param dict and the port's folded float32 weights."""
    p, c = cell(C, seed)
    return p, folded(c, F32)


@pytest.mark.parametrize("k", [1, None], ids=["events", "image"])
@pytest.mark.parametrize("H,W,C,plan", PLANS, ids=PLAN_IDS)
def test_k10a_emulated_matches_jax_kernel(H, W, C, plan, k):
    """float32: K1's decomposition on step sel of the whole chunk's gx
    buffer (what K10a runs under a plan) gives the JAX stream kernel's h'
    (StreamPlan.step, interpret mode) within 1e-5, at an events and an
    image step."""
    L, loop = 2, 2
    rng = np.random.RandomState(C + H)
    (p_ev, w_ev), (p_im, w_im) = _weights(C, 1), _weights(C, 2)
    gx_ev = rng.randn(L, 1, loop, H, W, 3 * C).astype(np.float32)
    gx_im = rng.randn(L, 1, H, W, 3 * C).astype(np.float32)
    h = (rng.rand(1, H, W, C) * 2 - 1).astype(np.float32)
    jplan = jax_gru_stream.StreamPlan(p_ev, p_im, jnp.asarray(gx_ev),
                                      jnp.asarray(gx_im), jnp.asarray(h))
    want = np.asarray(jplan.step(jnp.asarray(h), 1, k))
    if k is None:
        gx_seq, sel, (w_ur, w_o) = gx_im.reshape(L, H, W, 3 * C), 1, w_im
    else:
        gx_seq, sel, (w_ur, w_o) = gx_ev.reshape(L * loop, H, W, 3 * C), loop + k, w_ev
    got = k1_emulated(torch.from_numpy(h), torch.from_numpy(gx_seq[sel:sel + 1]),
                      w_ur, w_o, plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("H,W,C,plan", PLANS, ids=PLAN_IDS)
def test_k11_emulated_matches_jax_kernel(H, W, C, plan, K):
    """float32: K11's decomposition (every tile of every step in the order
    a grid of 3 clusters walks them, the image weights on each package's
    last step) over two packages gives the JAX chunk kernel's trajectory
    (interpret mode) within 1e-5."""
    S = 2 * (K + 1)
    rng = np.random.RandomState(C + K)
    (p_ev, w_ev), (p_im, w_im) = _weights(C, 3), _weights(C, 4)
    gx = rng.randn(S, H, W, 3 * C).astype(np.float32)
    h0 = (rng.rand(1, H, W, C) * 2 - 1).astype(np.float32)
    want = np.asarray(jax_gru_chunk.conv_gru_hside_chunk(
        p_ev, p_im, jnp.asarray(gx), jnp.asarray(h0), K, interpret=True))
    got = k11_emulated(w_ev, w_im, torch.from_numpy(gx), torch.from_numpy(h0),
                       K, plan, clusters=3)
    assert got.shape == (S, H, W, C)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_k11_walk_visits_each_tile_once_per_step():
    """Clusters take tiles c, c + clusters, ...: with fewer clusters than
    tiles each visits several, with more some visit none."""
    plan = K1Plan(3, 4, 1, 1, 16)                # 3 x 2 tiles of 8 x 8
    for clusters in (1, 2, 5, 6, 9):
        walk = k11_walk(plan, 8, 8, clusters)
        assert sorted(walk) == [(y, x) for y in (0, 3, 6) for x in (0, 4)]
    assert k11_walk(plan, 8, 8, 2)[:3] == [(0, 0), (3, 0), (6, 0)]


@pytest.mark.parametrize("shape", [(H, W, C) for H, W in CELLS for C in (64, 128, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k11_plan_fits_resident(shape):
    """K11's plan: a K1 plan K11 builds (combos 1, 2; split up to 2; its
    footprint with K11's static shared memory in a block's), one cluster
    per tile all resident at once wherever some plan's are, and then the
    cheapest such by the K1 model; plan_k1's wherever that one is among
    K11's plans and fits."""
    H, W, C = shape
    plan = gru_chunk.plan_k11(H, W, C, resident)
    plans = gru_chunk.k11_plans(H, W, C)
    assert plan in plans
    assert plan.combo in gru_chunk.K11_COMBOS and plan.split <= 2
    gru_chunk._checked(plan, C)
    cost = lambda p: gru_hside._k1_cost(p, 1, H, W, C)   # noqa: E731
    fitting = [p for p in plans if gru_chunk.tiles(p, H, W) <= resident(p)]
    if fitting:
        assert gru_chunk.tiles(plan, H, W) <= resident(plan)
        assert cost(plan) == min(cost(p) for p in fitting)
    k1 = gru_hside.plan_k1(1, H, W, C)
    if k1 in plans and gru_chunk.tiles(k1, H, W) <= resident(k1):
        assert plan == k1


@pytest.mark.parametrize("shape", FLAGSHIP, ids=lambda s: "x".join(map(str, s)))
def test_k11_flagship_plans_are_one_wave(shape):
    """At the flagship shapes K11 runs one wave of 64-128 clusters, each
    block keeping one tile for every step: plan_k1's plan at C = 128 and
    256 (split 2), and at C = 64, where plan_k1 takes combo 0, which K11
    does not build, the 16x16 tile on combo 1."""
    H, W, C = shape
    plan = gru_chunk.plan_k11(H, W, C, resident)
    want = {64: K1Plan(16, 16, 1, 1, 64)}.get(C, gru_hside.plan_k1(1, H, W, C))
    assert plan == want
    assert gru_chunk.tiles(plan, H, W) <= resident(plan)
    assert gru_chunk.k11_grid(plan, H, W, 0, resident(plan)) == \
        gru_chunk.tiles(plan, H, W) * plan.split


def test_k11_plan_loops_where_no_plan_fits():
    """Where no plan's clusters all fit at once (a card that holds 4, or
    a shape beyond the flagship), the cheapest plan runs with the resident
    clusters as its grid, and its blocks loop over the tiles."""
    for H, W, C, fit in ((64, 128, 128, lambda p: 4), (256, 512, 64, resident)):
        plan = gru_chunk.plan_k11(H, W, C, fit)
        cost = lambda p: gru_hside._k1_cost(p, 1, H, W, C)   # noqa: E731
        assert cost(plan) == min(cost(p) for p in gru_chunk.k11_plans(H, W, C))
        assert gru_chunk.tiles(plan, H, W) > fit(plan)
        assert gru_chunk.k11_grid(plan, H, W, 0, fit(plan)) == fit(plan) * plan.split


def test_k11_grid_rounds_or_refuses_blocks():
    """blocks > 0 is rounded up to a multiple of the split (a cluster's
    blocks come whole); 0 gives a cluster per tile up to the resident
    ones; a negative count raises."""
    one, two = K1Plan(16, 16, 1, 1, 64), K1Plan(8, 16, 2, 1, 64)
    assert gru_chunk.k11_grid(one, 128, 256, 5, 132) == 5
    assert gru_chunk.k11_grid(two, 64, 128, 5, 66) == 6
    assert gru_chunk.k11_grid(two, 64, 128, 6, 66) == 6
    assert gru_chunk.k11_grid(two, 64, 128, 1 << 20, 66) == 1 << 20
    assert gru_chunk.k11_grid(two, 64, 128, 0, 66) == 128
    assert gru_chunk.k11_grid(two, 64, 128, 0, 10) == 20
    assert gru_chunk.k11_grid(K1Plan(1, 1, 1, 2, 64), 1, 1, 0, 132) == 1
    with pytest.raises(ValueError, match="blocks"):
        gru_chunk.k11_grid(one, 128, 256, -1, 132)


def _stream_inputs(C=96, S=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(1, 8, 8, C, generator=gen)
    gx_seq = torch.randn(S, 8, 8, 3 * C, generator=gen)
    w_ur = torch.randn(9, 2 * C, C, generator=gen) * 0.05
    w_o = torch.randn(9, C, C, generator=gen) * 0.05
    return h, gx_seq, w_ur, w_o


BAD_PLANS = (K1Plan(4, 4, 4, 1, 32),     # no clusters of 4
             K1Plan(4, 4, 1, 3, 32),     # no such combo
             K1Plan(4, 4, 1, 1, 64),     # 64 does not divide 96
             K1Plan(4, 4, 1, 1, 48),     # no 48-wide slab
             K1Plan(64, 64, 1, 1, 32))   # shared memory


def test_k10a_plan_argument_checked_on_cpu():
    h, gx_seq, w_ur, w_o = _stream_inputs()
    sel = torch.tensor([2], dtype=torch.int32)
    want = gru_stream.conv_gru_hside_stream_plain(h, gx_seq, sel, w_ur, w_o)
    for plan in (K1Plan(4, 4, 2, 1, 32), (3, 5, 1, 0, 32)):
        assert torch.equal(gru_stream.conv_gru_hside_stream(
            h, gx_seq, sel, w_ur, w_o, _plan=plan), want)
    for bad in BAD_PLANS:
        with pytest.raises(ValueError):
            gru_stream.conv_gru_hside_stream(h, gx_seq, sel, w_ur, w_o, _plan=bad)


def test_k11_plan_argument_checked_on_cpu():
    """A plan K11 can run gives the plain trajectory on the CPU; K1's
    refusals, combo 0 (not built for K11) and a negative grid raise."""
    h, gx_seq, w_ur, w_o = _stream_inputs(S=6)
    args = ((w_ur, w_o), (w_ur * 0.5, w_o), gx_seq, h, 2)
    want = gru_chunk.conv_gru_hside_chunk_plain(*args)
    for plan in (K1Plan(4, 4, 2, 1, 32), K1Plan(3, 5, 1, 2, 32)):
        assert torch.equal(gru_chunk.conv_gru_hside_chunk(*args, _plan=plan), want)
    for bad in BAD_PLANS + (K1Plan(4, 4, 1, 0, 32),):
        with pytest.raises(ValueError):
            gru_chunk.conv_gru_hside_chunk(*args, _plan=bad)
    with pytest.raises(ValueError, match="blocks"):
        gru_chunk.conv_gru_hside_chunk(*args, blocks=-2)


def _c_params(src: str, name: str):
    """The kinds of a C entry's parameters, as ctypes types."""
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
            for p in params]


@pytest.mark.parametrize("source,signatures", [
    ("gru_hside.cu", {k: v for k, v in gru_hside._FWD_SIGNATURES.items()
                      if k == "ramnet_gru_hside_forward_sel"}),
    ("gru_chunk.cu", gru_chunk._SIGNATURES),
    ("gru_cells.cu", gru_pair._SIGNATURES)], ids=["k10a", "k11", "k9_k10b"])
def test_signatures_match_the_c_entries(source, signatures):
    """The ctypes signatures of K10a's, K11's and K9/K10b's C entries
    (loaded only on a card) take as many arguments, of the same kinds, as
    the sources declare; K10a's entry left gru_cells.cu."""
    src = (CSRC / source).read_text()
    assert signatures
    for name, (_, argtypes) in signatures.items():
        assert list(argtypes) == _c_params(src, name), name
    assert "ramnet_gru_stream_forward(" not in (CSRC / "gru_cells.cu").read_text()


def test_k11_builds_its_combos():
    """gru_chunk.cu instantiates K11 for exactly K11_COMBOS, with K1's
    warp jobs of each (K1_COMBOS)."""
    src = (CSRC / "gru_chunk.cu").read_text()
    body = src[src.index("K11Kernel kernel_of(int combo)"):]
    body = body[:body.index("\n}\n")]
    built = {int(c): tuple(int(v) for v in args.split(","))
             for c, args in re.findall(r"case (\d+): return k11_kernel<([\d, ]+)>", body)}
    assert built == {c: gru_hside.K1_COMBOS[c] for c in gru_chunk.K11_COMBOS}


def _old_supports(shape):
    """``gru_hside.supports`` as it was: bf16, 4-D, C % 16, a tile of the
    launch variants and of the first backward design, a K1-res plan."""
    return (shape[-1] % 16 == 0 and gru_hside.pick_tile(*shape) is not None
            and gru_hside.plan_k1(*shape, residuals=True) is not None
            and gru_hside.pick_tile(*shape, smem=gru_hside.smem_bytes_bwd)
            is not None)


@pytest.mark.parametrize("hw", CELLS, ids=lambda c: "x".join(map(str, c)))
def test_supports_unchanged_and_planned(hw):
    """``supports`` and ``gru_chunk.supports`` give the answers they gave
    at every width, B = 1 and 2; wherever they hold, K10a has a K1 plan
    and K11 a plan of its own."""
    for C in WIDTHS:
        for B in (1, 2):
            h = torch.empty(B, *hw, C, dtype=torch.bfloat16, device="meta")
            old = _old_supports(h.shape)
            assert gru_hside.supports(h) == old, (B, C)
            assert gru_chunk.supports(h) == (old and B == 1), (B, C)
            if gru_chunk.supports(h):
                assert gru_hside.plan_k1(*h.shape) is not None
                assert gru_chunk.plan_k11(*hw, C, resident) is not None
        assert not gru_chunk.supports(torch.empty(1, *hw, C, device="meta"))


def test_k11_static_smem_covers_the_kernel():
    """K11_STATIC_SMEM bounds the static shared memory of K11's kernel: the
    tile's K1Args (6 pointers, 8 ints, one long long, padded), its origin
    and rank, the walk's 3 ints."""
    k1args = 6 * 8 + 8 * 4 + 8
    assert k1args + 3 * 4 + 3 * 4 <= gru_chunk.K11_STATIC_SMEM
    for H, W, C in FLAGSHIP:
        for p in gru_chunk.k11_plans(H, W, C):
            assert gru_hside.k1_smem_bytes(p.tile_h, p.tile_w, C, p.split, p.ks) \
                + gru_chunk.K11_STATIC_SMEM <= 232448
