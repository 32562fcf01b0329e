"""The pair cells K9 and K10b on K1's tile (ops/gru_pair.py,
ops/gru_stream.py; csrc/gru_cells.cu): the pair grid's decomposition in
plain torch (tests/k1_emulation.py::k9_emulated, every block of both
scales through the block -> scale, item, tile and rank map) against the
JAX Pallas pair and stream-pair kernels in interpret mode, under plan
pairs that mix cluster splits, ragged tiles, a tile beyond the image,
padding blocks, B = 2 with a batch-strided gx and both block orders; the
map itself (each tile of each scale once, no cluster of two scales); the
planner (one combo, K1's cheapest plan on it per scale; the flagship
plans PERF.md records); the
private plan arguments on the CPU; the ctypes signatures and the built
combos against csrc/gru_cells.cu; the gate ``supports_pair``
unchanged.  The kernels themselves are tested on a card in
tests/test_torch_cuda.py and chip_smoke.py phase 14.
"""
import functools
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rpg_ramnet_tpu.ops import gru_pair as jax_gru_pair
from rpg_ramnet_tpu.ops import gru_stream as jax_gru_stream

from rpg_ramnet_tpu_torch.ops import gru_hside, gru_pair, gru_stream
from rpg_ramnet_tpu_torch.ops.gru_hside import K1Plan

from k1_emulation import k9_emulated, pair_blocks
from torch_chunked_common import cell, folded
from torch_threads import one_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "rpg_ramnet_tpu_torch" / "csrc"
F32 = torch.float32
# (B, scale 0's [H, W, C], scale 1's, their plans, the scale first in the
# grid; both plans on one combo, as the kernel takes them): shapes the JAX
# kernels take (H % 4 == 0, W % 8 == 0); a split-1
# scale with an odd count of tile columns beside a split-2 one (padding
# blocks in clusters of 2), in either order; 2 + 2 and 1 + 1; a tile beyond the image; 1x1 tiles;
# ragged tiles; B = 2 (gx then a batch-strided view)
PAIR_CASES = (
    (1, (12, 16, 16), (8, 8, 32), K1Plan(5, 7, 1, 0, 16), K1Plan(4, 4, 2, 0, 16), 0),
    (1, (12, 16, 16), (8, 8, 32), K1Plan(5, 7, 1, 1, 16), K1Plan(4, 4, 2, 1, 16), 1),
    (2, (8, 16, 32), (4, 8, 64), K1Plan(2, 8, 2, 2, 16), K1Plan(3, 4, 2, 2, 32), 0),
    (2, (8, 16, 16), (4, 8, 32), K1Plan(3, 5, 1, 2, 16), K1Plan(16, 16, 1, 2, 32), 1),
    (1, (4, 8, 48), (4, 8, 32), K1Plan(1, 1, 1, 1, 16), K1Plan(1, 1, 2, 1, 32), 0),
    (1, (12, 16, 64), (8, 8, 128), K1Plan(7, 8, 2, 0, 16), K1Plan(3, 3, 1, 0, 32), 1),
)
CASE_IDS = ["-".join(("B%d" % B, "x".join(map(str, s0)), "x".join(map(str, s1)),
                      "".join(map(str, p0)), "".join(map(str, p1)), "f%d" % f))
            for B, s0, s1, p0, p1, f in PAIR_CASES]
# the flagship pair (chunked inference at 256x512, base 32) and its plans
# (PERF.md §6: K1's on combo 0 at each scale), and the ragged pair of
# chip_smoke.py
FLAGSHIP = ((1, 128, 256, 64), (1, 64, 128, 128))
FLAGSHIP_PLANS = (K1Plan(16, 16, 1, 0, 64), K1Plan(8, 16, 2, 0, 64))
RAGGED = ((2, 30, 45, 96), (2, 15, 23, 32))
# (H, W) of scale 0 (scale 1 is half of it, rounded up) of chip_smoke's
# cells and of the training, flagship and phased resolutions
PAIR_HW = ((128, 256), (112, 112), (64, 128), (30, 45), (128, 176), (5, 40),
           (9, 3), (1, 1), (17, 19), (240, 320))


def _scale(B, H, W, C, seed, strided):
    """A JAX ConvGRU param dict, the port's folded float32 weights, h in
    (-1, 1) and gx ~ N(0, 1) (numpy), gx as a batch-strided view when
    strided."""
    rng = np.random.RandomState(seed)
    p, c = cell(C, seed)
    h = (rng.rand(B, H, W, C) * 2 - 1).astype(np.float32)
    if strided:
        gx_t = torch.from_numpy(rng.randn(B, 2, H, W, 3 * C).astype(np.float32))[:, 1]
    else:
        gx_t = torch.from_numpy(rng.randn(B, H, W, 3 * C).astype(np.float32))
    return p, folded(c, F32), h, gx_t


@pytest.mark.parametrize("B,s0,s1,p0,p1,first", PAIR_CASES, ids=CASE_IDS)
def test_k9_emulated_matches_jax_kernel(B, s0, s1, p0, p1, first):
    """float32: every block of the pair grid, each under its scale's plan,
    gives the JAX pair kernel's h' on both scales (interpret mode) within
    1e-5; at B = 2 gx is a batch-strided view."""
    (q0, w0, h0, g0), (q1, w1, h1, g1) = (
        _scale(B, *s, seed, B > 1) for s, seed in ((s0, 3), (s1, 5)))
    want = jax_gru_pair.conv_gru_hside_pair(
        q0, q1, jnp.asarray(g0.numpy()), jnp.asarray(g1.numpy()),
        jnp.asarray(h0), jnp.asarray(h1))
    got = k9_emulated(((torch.from_numpy(h0), g0, *w0),
                       (torch.from_numpy(h1), g1, *w1)), (p0, p1), first)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _stream_scale(H, W, C, seed, L=2, K=2):
    """The JAX StreamPlan of one scale over L packages of K event steps
    (float32), the port's folded weights of both cells, gx_ev as a step
    sequence [L*K, H, W, 3C], gx_im [L, H, W, 3C] and h0; built once per
    module for each scale (the tests read them, none writes)."""
    rng = np.random.RandomState(seed)
    (p_ev, c_ev), (p_im, c_im) = cell(C, seed), cell(C, seed + 1)
    gx_ev = rng.randn(L, 1, K, H, W, 3 * C).astype(np.float32)
    gx_im = rng.randn(L, 1, H, W, 3 * C).astype(np.float32)
    h0 = (rng.rand(1, H, W, C) * 2 - 1).astype(np.float32)
    jplan = jax_gru_stream.StreamPlan(p_ev, p_im, jnp.asarray(gx_ev),
                                      jnp.asarray(gx_im), jnp.asarray(h0))
    return (jplan, (folded(c_ev, F32), folded(c_im, F32)),
            torch.from_numpy(gx_ev.reshape(L * K, H, W, 3 * C)),
            torch.from_numpy(gx_im.reshape(L, H, W, 3 * C)), h0)


# (package, event sub-step or None for the image step): in range, and the
# image step past the last package and before the first, where the
# kernel's clamp reads the buffer's last and first step (as the JAX
# kernel's clamped block index does)
STEPS = ((1, 0, 2), (0, 1, 1), (1, None, 1), (5, None, 1), (-3, None, 0))


@pytest.mark.parametrize("pkg,k,clamped", STEPS,
                         ids=["events", "events_early", "image", "image_beyond",
                              "image_before"])
@pytest.mark.parametrize("case", [0, 5], ids=[CASE_IDS[0], CASE_IDS[5]])
def test_k10b_emulated_matches_jax_kernel(case, pkg, k, clamped):
    """float32: K10b's decomposition, the pair grid reading both scales'
    gx at step sel of their gx_seq (clamped to the buffer), gives the JAX
    stream-pair kernel's h' (interpret mode) within 1e-5, at events and
    image steps and at image steps out of range."""
    _, s0, s1, p0, p1, first = PAIR_CASES[case]
    j0, (ev0, im0), gev0, gim0, h0 = _stream_scale(*s0, seed=7)
    j1, (ev1, im1), gev1, gim1, h1 = _stream_scale(*s1, seed=9)
    want = jax_gru_stream.stream_pair_step(j0, j1, jnp.asarray(h0), jnp.asarray(h1),
                                           pkg, k)
    if k is None:
        scales = ((torch.from_numpy(h0), gim0, *im0), (torch.from_numpy(h1), gim1, *im1))
        sel = pkg
    else:
        scales = ((torch.from_numpy(h0), gev0, *ev0), (torch.from_numpy(h1), gev1, *ev1))
        sel = pkg * 2 + k
    assert min(max(sel, 0), scales[0][1].shape[0] - 1) == clamped
    got = k9_emulated(scales, (p0, p1), first, step=sel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


MAP_CASES = [(B, s0[:2], s1[:2], (p0, p1), first)
             for B, s0, s1, p0, p1, first in PAIR_CASES] + [
    (1, FLAGSHIP[0][1:3], FLAGSHIP[1][1:3], FLAGSHIP_PLANS, f) for f in (0, 1)] + [
    (1, (128, 256), (64, 128), (K1Plan(12, 24, 1, 0, 32), FLAGSHIP_PLANS[1]), f)
    for f in (0, 1)] + [
    (2, RAGGED[0][1:3], RAGGED[1][1:3], gru_pair.plan_k9(*RAGGED), 0)]


@pytest.mark.parametrize("B,hw0,hw1,plans,first", MAP_CASES,
                         ids=[f"case{i}" for i in range(len(MAP_CASES))])
def test_pair_map_covers_each_tile_once(B, hw0, hw1, plans, first):
    """The pair grid visits each (scale, item, tile, rank) exactly once;
    its cluster size is the larger split and its x extent whole clusters;
    no cluster holds blocks of two scales; a split-2 tile's two ranks share
    a cluster; the first scale's blocks come first; padding blocks only
    past a scale's columns, at most a cluster's worth beyond the wider
    scale's."""
    grid, blocks = pair_blocks(plans, B, hw0, hw1, first)
    cl, (gx, gy, gz) = grid.cluster, grid.grid
    assert cl == max(p.split for p in plans) and gx % cl == 0
    assert len(blocks) == gx * gy * gz and gz == B
    want = {(s, b, (y, x), r) for s, (p, (H, W)) in enumerate(zip(plans, (hw0, hw1)))
            for b in range(B) for y in range(0, H, p.tile_h)
            for x in range(0, W, p.tile_w) for r in range(p.split)}
    real = [blk for blk in blocks if blk is not None]
    assert len(real) == len(set(real)) and set(real) == want
    for c in range(len(blocks) // cl):
        members = [blk for blk in blocks[c * cl:(c + 1) * cl] if blk is not None]
        assert len({blk[0] for blk in members}) <= 1
        if members and plans[members[0][0]].split == 2:
            assert len(members) == 2 and members[0][1:3] == members[1][1:3]
            assert [blk[3] for blk in members] == [0, 1]
    assert blocks[0][0] == first
    assert blocks.count(None) == B * sum(r * (gx - c) for r, c in zip(grid.rows, grid.cols))
    assert gx - max(grid.cols) < cl


def test_flagship_pair_plans_and_grid():
    """At the flagship pair K9 and K10b run combo 0 (16x16/s1/c0 and
    8x16/s2/c0, k64: scale 0 K1's own plan, scale 1 K1's tile and split on
    combo 0, where K1 takes combo 1): 8 + 8 tile rows of 16 columns, 256
    blocks in clusters of 2, no padding, 28 + 57 MB of weights streamed per
    launch, and scale 0's plan at split 1 inside clusters of 2."""
    plans = gru_pair.plan_k9(*FLAGSHIP)
    assert plans == FLAGSHIP_PLANS
    k1 = tuple(gru_hside.plan_k1(*s) for s in FLAGSHIP)
    assert plans[0] == k1[0] and plans[1] == k1[1]._replace(combo=0)
    for first in (0, 1):
        grid = gru_pair.pair_grid(plans, 1, FLAGSHIP[0][1:3], FLAGSHIP[1][1:3], first)
        assert grid.cluster == 2 and grid.grid == (16, 16, 1)
        assert grid.rows == (8, 8) and grid.cols == (16, 16)
        assert grid.row0[first] == 0 and grid.row0[1 - first] == 8
    mb = [gru_hside.k1_weight_bytes(p, *s) / 1e6 for p, s in zip(plans, FLAGSHIP)]
    assert [round(m) for m in mb] == [28, 57]
    assert gru_pair.pair_weight_bytes(plans, *FLAGSHIP) == sum(
        gru_hside.k1_weight_bytes(p, *s) for p, s in zip(plans, FLAGSHIP))
    assert gru_pair.PAIR_FIRST in (0, 1)


@pytest.mark.parametrize("hw", PAIR_HW, ids=lambda c: "x".join(map(str, c)))
def test_plan_k9_takes_one_combo(hw):
    """Wherever supports_pair holds, plan_k9 gives both scales one combo,
    each scale K1's cheapest plan on it (the plan_k1 model), the combo of
    least summed cost; plan_k1's own plans wherever those share a combo;
    both within shared memory at their widths."""
    H, W = hw
    hw1 = (-(-H // 2), -(-W // 2))
    for B in (1, 2):
        for C0 in (16, 32, 64, 96, 128):
            s0, s1 = (B, H, W, C0), (B, *hw1, 2 * C0)
            h0, h1 = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in (s0, s1))
            if not gru_pair.supports_pair(h0, h1):
                continue
            plans = gru_pair.plan_k9(s0, s1)
            assert plans[0].combo == plans[1].combo

            def cost(p, s):
                return gru_hside._k1_cost(p, *s)

            def best(s, combo):
                return min(cost(p, s) for p in gru_hside.k1_plans(*s) if p.combo == combo)

            for p, s in zip(plans, (s0, s1)):
                gru_hside.check_k1_plan(p, s[-1])
                assert cost(p, s) == best(s, p.combo)
            total = cost(plans[0], s0) + cost(plans[1], s1)
            assert total == min(best(s0, c) + best(s1, c) for c in range(3))
            k1 = (gru_hside.plan_k1(*s0), gru_hside.plan_k1(*s1))
            if k1[0].combo == k1[1].combo:
                assert plans == k1


def _old_supports(shape):
    """``gru_hside.supports`` as the pair gate read it before the pair
    cells had K1's plans: C % 16, a first-design tile (pick_tile), a K1-res
    plan and a first-design backward tile."""
    return (shape[-1] % 16 == 0 and gru_hside.pick_tile(*shape) is not None
            and gru_hside.plan_k1(*shape, residuals=True) is not None
            and gru_hside.pick_tile(*shape, smem=gru_hside.smem_bytes_bwd) is not None)


@pytest.mark.parametrize("hw", PAIR_HW, ids=lambda c: "x".join(map(str, c)))
def test_supports_pair_unchanged(hw):
    """``supports_pair`` gives the answers it gave (both scales as the old
    gate read them, one batch size, bf16) at every width pair, B = 1 and 2
    and a batch mismatch; and wherever it holds plan_k9 has plans."""
    H, W = hw
    hw1 = (-(-H // 2), -(-W // 2))
    for B0, B1 in ((1, 1), (2, 2), (1, 2)):
        for C0, C1 in itertools.product((16, 24, 64, 256), (32, 128, 512)):
            s0, s1 = (B0, H, W, C0), (B1, *hw1, C1)
            h0, h1 = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in (s0, s1))
            old = _old_supports(s0) and _old_supports(s1) and B0 == B1
            assert gru_pair.supports_pair(h0, h1) == old, (s0, s1)
            if old:
                assert gru_pair.plan_k9(s0, s1) is not None
            assert not gru_pair.supports_pair(h0.float(), h1.float())


def _pair_inputs(C0=32, C1=64, S=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for H, C in ((8, C0), (4, C1)):
        out += [torch.randn(1, H, H, C, generator=gen),
                torch.randn(S, H, H, 3 * C, generator=gen),
                torch.randn(9, 2 * C, C, generator=gen) * 0.05,
                torch.randn(9, C, C, generator=gen) * 0.05]
    return out


BAD_PAIRS = ((K1Plan(4, 4, 4, 1, 16), K1Plan(4, 4, 1, 1, 32)),   # no clusters of 4
             (K1Plan(4, 4, 1, 3, 16), K1Plan(4, 4, 1, 1, 32)),   # no such combo
             (K1Plan(4, 4, 1, 1, 32), K1Plan(4, 4, 1, 1, 48)),   # no 48-wide slab
             (K1Plan(4, 4, 1, 1, 64), K1Plan(4, 4, 1, 1, 32)),   # 64 does not divide 32
             (K1Plan(64, 64, 1, 1, 32), K1Plan(4, 4, 1, 1, 32)),  # shared memory
             (K1Plan(4, 4, 1, 1, 32), K1Plan(4, 4, 1, 0, 32)),   # two combos
             (K1Plan(4, 4, 1, 1, 32),))                           # one plan


@pytest.mark.parametrize("kind", ["k9", "k10b"])
def test_pair_plan_argument_checked_on_cpu(kind):
    """On CPU tensors both wrappers run the plain version under any pair
    of plans the kernel runs (one combo) and either block order, and raise
    on a plan the tile cannot run, plans on two combos, a single plan or a
    block order other than 0 and 1."""
    h0, g0, u0, o0, h1, g1, u1, o1 = _pair_inputs()
    sel = torch.tensor([2], dtype=torch.int32)
    if kind == "k9":
        def call(**kw):
            return gru_pair.conv_gru_hside_pair(h0, g0[2:3], u0, o0, h1, g1[2:3], u1, o1,
                                                **kw)
        want = gru_pair.conv_gru_hside_pair_plain(h0, g0[2:3], u0, o0, h1, g1[2:3], u1, o1)
    else:
        def call(**kw):
            return gru_stream.conv_gru_hside_stream_pair(h0, g0, u0, o0, h1, g1, u1, o1,
                                                         sel, **kw)
        want = gru_stream.conv_gru_hside_stream_pair_plain(h0, g0, u0, o0, h1, g1, u1, o1,
                                                           sel)
    for kw in ({}, {"_plan": (K1Plan(4, 4, 2, 0, 32), (3, 5, 1, 0, 16))},
               {"_plan": (K1Plan(4, 4, 2, 1, 32), K1Plan(4, 4, 1, 1, 64))},
               {"_plan": (K1Plan(8, 8, 1, 2, 32), K1Plan(1, 1, 2, 2, 64)), "_first": 1},
               {"_first": 0}):
        for got, w in zip(call(**kw), want):
            assert torch.equal(got, w)
    for bad in BAD_PAIRS:
        with pytest.raises(ValueError):
            call(_plan=bad)
    with pytest.raises(ValueError, match="first"):
        call(_first=2)


def _c_entry(src, name):
    m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
    assert m, name
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_pair_signatures_and_plan_order():
    """The K9 and K10b entries take each scale's plan in K1Plan's field
    order (tile_h, tile_w, split, combo, ks) after its widths, then the
    block order: the wrappers pass ``*plan`` there."""
    src = (CSRC / "gru_cells.cu").read_text()
    fields = [f"int {f}" for f in K1Plan._fields]
    for name in ("ramnet_gru_pair_forward", "ramnet_gru_stream_pair_forward"):
        params = _c_entry(src, name)
        assert len(params) == len(gru_pair._SIGNATURES[name][1])
        for i in (0, 1):
            at = params.index(f"int tile_h{i}")
            assert [p.rstrip("01") for p in params[at:at + 5]] == fields
        assert "int first" in params


def test_k9_builds_every_combo():
    """gru_cells.cu instantiates k9_kernel once per K1 combo, with K1's
    warp jobs of each (K1_COMBOS), and the planner's combos at the
    flagship, ragged and PAIR_HW shapes are among them; a pair of plans on
    two combos is refused."""
    src = (CSRC / "gru_cells.cu").read_text()
    body = src[src.index("K9Kernel kernel_of(int combo)"):]
    body = body[:body.index("\n}\n")]
    built = {int(c): tuple(int(v) for v in args.split(","))
             for c, args in re.findall(r"case (\d): return k9_kernel<kSel, ([\d, ]+)>", body)}
    assert built == dict(enumerate(gru_hside.K1_COMBOS))
    emitted = {gru_pair.plan_k9(*pair)[0].combo for pair in (FLAGSHIP, RAGGED)}
    for H, W in PAIR_HW:
        for C in (32, 64):
            plans = gru_pair.plan_k9((1, H, W, C), (1, -(-H // 2), -(-W // 2), 2 * C))
            if plans:
                emitted.add(plans[0].combo)
    assert emitted <= set(built) and len(emitted) >= 2
    with pytest.raises(ValueError, match="one warp-job combo"):
        gru_pair.resolve_plans(FLAGSHIP[0], FLAGSHIP[1],
                               (FLAGSHIP_PLANS[0], FLAGSHIP_PLANS[1]._replace(combo=1)), None,
                               "K9")


@pytest.mark.parametrize("pair", [FLAGSHIP, RAGGED], ids=["flagship", "ragged"])
def test_k9_plan_kinds_cover_the_grid_paths(pair):
    """The launches the card runs (gru_pair.k9_plan_kinds): the planner's
    pair first in the kept order, then in the other; every combo (both
    scales on it, every kernel instance);
    splits 1 + 1, 1 + 2 and 2 + 2; padding blocks in both orders; each
    plan one the tile runs at its scale's width."""
    kinds = gru_pair.k9_plan_kinds(*pair)
    planned = gru_pair.plan_k9(*pair)
    assert kinds[:2] == [(planned, gru_pair.PAIR_FIRST), (planned, 1 - gru_pair.PAIR_FIRST)]
    assert len(set(kinds)) == len(kinds)
    for plans, _ in kinds:
        for p, s in zip(plans, pair):
            gru_hside.check_k1_plan(p, s[-1])
    assert {(p0.combo, p1.combo) for (p0, p1), _ in kinds} == {(c, c) for c in range(3)}
    splits = {(p0.split, p1.split) for (p0, p1), _ in kinds}
    assert {(1, 1), (1, 2), (2, 2)} <= splits
    padded = {first for plans, first in kinds
              if (grid := gru_pair.pair_grid(plans, pair[0][0], pair[0][1:3],
                                             pair[1][1:3], first)).cols[0] % grid.cluster}
    assert padded == {0, 1}
