"""The plan of the port's ConvGRU h-side kernels K1 and K1-res
(ops/gru_hside.py::plan_k1): shared memory, cluster split and tiles at
every width and cell the port runs, the gate ``supports`` unchanged with
the first pair design's tiles as one of its terms, the weight
bytes the split saves, the private plan argument, and a plain-torch
emulation of the kernel's decomposition (output tiles, the a tile with its
ring, each cluster rank's channel slice; tests/k1_emulation.py) against
the JAX Pallas kernel in interpret mode.  The kernel itself is tested on a
card in tests/test_torch_cuda.py; K10a and K11, which run K1's tile, in
tests/test_torch_gru_variants_plan.py, K9 and K10b in
tests/test_torch_gru_pair_plan.py.
"""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops.gru_hside import conv_gru_hside_fused

from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.ops.gru_hside import K1Plan

from k1_emulation import EMULATED, k1_emulated
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (16, 32, 48, 64, 96, 128, 256)
# (B, H, W): the flagship chunked-inference cells, the training cells and
# the ragged cells of chip_smoke.py
CELLS = ((1, 128, 256), (1, 64, 128), (1, 32, 64), (16, 112, 112),
         (16, 56, 56), (16, 28, 28), (2, 30, 45), (3, 30, 45))
PREFIX = "statenetphasedrecurrent."
MAIN = ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256),
        (16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256))


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(map(str, c)))
def test_k1_plan_fits(cell, C):
    B, H, W = cell
    for res in (False, True):
        plan = gru_hside.plan_k1(B, H, W, C, residuals=res)
        kinds = gru_hside.k1_plan_kinds(B, H, W, C, residuals=res)
        assert plan is not None and kinds[0] == plan
        assert len(set(kinds)) == len(kinds)
        for p in kinds:
            gru_hside.check_k1_plan(p, C, residuals=res)
            assert gru_hside.k1_smem_bytes(p.tile_h, p.tile_w, C, p.split,
                                           p.ks, res) <= 232448
            assert (C // 16) % p.split == 0
            if C < 128:
                assert p.split == 1
            # the tiles cover the image, and none is larger than it
            assert 1 <= p.tile_h <= H and 1 <= p.tile_w <= W
            assert math.ceil(H / p.tile_h) * p.tile_h >= H
            assert math.ceil(W / p.tile_w) * p.tile_w >= W
            assert gru_hside.plan_blocks(p, B, H, W) == (
                B * math.ceil(H / p.tile_h) * math.ceil(W / p.tile_w)
                * p.split)
        if C == 64:
            assert plan.split == 1
    # K1-res's footprint is K1's or more: its plans run K1 too
    p = gru_hside.plan_k1(B, H, W, C, residuals=True)
    gru_hside.check_k1_plan(p, C)


def _old_supports(shape):
    """The gate before K1's planner: a variant tile and a backward tile."""
    return (shape[-1] % 16 == 0 and gru_hside.pick_tile(*shape) is not None
            and gru_hside.pick_tile(*shape, smem=gru_hside.smem_bytes_bwd)
            is not None)


@pytest.mark.parametrize("cell", CELLS + ((1, 1, 1), (2, 3, 5), (1, 7, 300)),
                         ids=lambda c: "x".join(map(str, c)))
def test_supports_unchanged(cell):
    for C in range(8, 1240, 8):
        h = torch.empty(*cell, C, dtype=torch.bfloat16, device="meta")
        assert gru_hside.supports(h) == _old_supports(h.shape), C
        if gru_hside.supports(h):
            assert gru_hside.plan_k1(*h.shape) is not None
            assert gru_hside.plan_k1(*h.shape, residuals=True) is not None
    assert not gru_hside.supports(torch.empty(1, 8, 8, 64, device="meta"))


# the first pair design's tiles (pick_tile with smem_bytes), which K9 and
# K10b ran before they took K1's plans and which stay a term of the gate
# ``supports``
VARIANT_TILES = {(1, 128, 256, 64): ((16, 16), 104256),
                 (1, 64, 128, 128): ((8, 8), 66368),
                 (1, 32, 64, 256): ((4, 4), 52800),
                 (2, 30, 45, 96): ((4, 4), 20800),
                 (2, 15, 23, 32): ((4, 4), 8000)}


@pytest.mark.parametrize("shape", sorted(VARIANT_TILES),
                         ids=lambda s: "x".join(map(str, s)))
def test_variants_keep_their_tile(shape):
    tile, smem = VARIANT_TILES[shape]
    h = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert gru_hside.pick_tile(*shape) == tile
    assert gru_hside.supports(h)
    assert gru_hside.smem_bytes(*tile, shape[-1]) == smem


@pytest.mark.parametrize("shape", MAIN, ids=lambda s: "x".join(map(str, s)))
def test_split_cuts_weight_bytes(shape):
    """The weight ring streams each weight byte once per block and pass:
    the planner's plans stream fewer bytes than the first design's
    27*C^2*2 per 32-pixel warp item, and at C >= 128,
    among plans of one wave of blocks or more, a cluster split streams
    fewer than any unsplit plan."""
    B, H, W, C = shape
    th, tw = gru_hside.pick_tile(*shape)
    first = (B * math.ceil(H / th) * math.ceil(W / tw) * 9 * C * C * 2
             * (math.ceil((th + 2) * (tw + 2) / 32)
                + 2 * math.ceil(th * tw / 32)))
    for res in (False, True):
        for p in (gru_hside.plan_k1(*shape, residuals=res),
                  gru_hside.plan_k1(*shape, max_split=1, residuals=res)):
            assert gru_hside.k1_weight_bytes(p, *shape) < first
        if C >= 128:
            by_split = {}
            for p in gru_hside.k1_plans(*shape, residuals=res):
                if gru_hside.plan_blocks(p, B, H, W) >= 128:
                    w = gru_hside.k1_weight_bytes(p, *shape)
                    by_split[p.split > 1] = min(w, by_split.get(p.split > 1, w))
            assert by_split[True] < by_split[False]


def _cell(C, seed=0):
    """A JAX ConvGRU param dict and the port's ConvGRU with its weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    cell = ConvGRU(C, C)
    cell.load_state_dict({k[len(PREFIX):]: torch.from_numpy(np.array(v))
                          for k, v in params_to_state_dict(p).items()},
                         strict=True)
    return p, cell


@pytest.mark.parametrize("B,H,W,C,plan", EMULATED,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, K1Plan) else str(v))
def test_k1_emulated_matches_jax_kernel(B, H, W, C, plan):
    """float32: the decomposition K1 runs under a plan (split included,
    whatever the planner's C >= 128 rule) gives the JAX kernel's h' (1e-5)."""
    p, cell = _cell(C)
    rng = np.random.RandomState(0)
    h = rng.randn(B, H, W, C).astype(np.float32)
    x = rng.randn(B, H, W, C).astype(np.float32)
    gx = np.array(JL.conv_gru_x_gates(p, jnp.asarray(x)))
    want = np.asarray(conv_gru_hside_fused(p, jnp.asarray(gx), jnp.asarray(h),
                                           interpret=True))
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights()
        got = k1_emulated(torch.from_numpy(h), torch.from_numpy(gx), w_ur,
                          w_o, plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plan_argument_checked_on_cpu():
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(1, 8, 8, 96, generator=gen)
    gx = torch.randn(1, 8, 8, 288, generator=gen)
    w_ur = torch.randn(9, 192, 96, generator=gen) * 0.05
    w_o = torch.randn(9, 96, 96, generator=gen) * 0.05
    want = gru_hside.conv_gru_hside_plain(h, gx, w_ur, w_o)
    plan = K1Plan(4, 4, 2, 1, 32)
    assert torch.equal(gru_hside.conv_gru_hside(h, gx, w_ur, w_o, _plan=plan), want)
    got_h, _ = gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o, _plan=plan)
    assert torch.equal(got_h, want)
    for bad in (K1Plan(4, 4, 4, 1, 32), K1Plan(4, 4, 1, 3, 32),
                K1Plan(4, 4, 1, 1, 64), K1Plan(4, 4, 1, 1, 48),
                K1Plan(64, 64, 1, 1, 32)):
        with pytest.raises(ValueError):
            gru_hside.conv_gru_hside(h, gx, w_ur, w_o, _plan=bad)
        with pytest.raises(ValueError):
            gru_hside.conv_gru_hside_res(h, gx, w_ur, w_o, _plan=bad)


def test_k1_model_is_the_committed_fit():
    """``_K1_MODEL`` is what ``gru_hside_timing.py --fit`` gives on the
    committed sweep (gru_hside_sweep.jsonl, timed on an H100), and the
    fit picks within 5% of the swept best at each timed shape."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    with open(ROOT / gru_hside_timing.SWEEP_FILE) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    model, report = gru_hside_timing.fit_model(lines)
    assert model == gru_hside._K1_MODEL
    assert len(report["picks"]) == 6
    for key, pick in report["picks"].items():
        assert pick["pick_over_best"] <= 1.05, (key, pick)


def test_k1_signatures_match_the_c_entries():
    """The ctypes signatures of csrc/gru_hside.cu's C entries (loaded only
    on a card) take as many arguments, of the same kinds, as the source
    declares."""
    import ctypes
    import re
    src = (ROOT / "rpg_ramnet_tpu_torch" / "csrc" / "gru_hside.cu").read_text()
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, (_, argtypes) in gru_hside._FWD_SIGNATURES.items():
        m = re.search(r"\b" + name + r"\(([^)]*)\)\s*\{", src)
        assert m, name
        params = [" ".join(p.split()) for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
                for p in params]
        assert list(argtypes) == want, name
