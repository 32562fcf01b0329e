"""The plan of the port's ConvGRU backward kernel K2
(ops/gru_hside.py::plan_k2, csrc/gru_hside_bwd_tile.cuh): shared memory
and tiles at the shapes the port runs, the C side's shared-memory formula
and entry points, the weight bytes the tile saves, the gate ``supports`` (a
K2 plan wherever it holds), the other kernels' tiles unchanged, the
private plan argument, the cost model against its committed sweep, and a
plain-torch emulation of the tile's decomposition (output tiles, the 2-
and 1-pixel rings, the forward-layout weights with their taps flipped)
against the JAX Pallas backward in interpret mode and the XLA backward.  The kernel itself is tested on a card in
tests/test_torch_cuda.py.
"""
import ctypes
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from rpg_ramnet_tpu.compat.torch_import import params_to_state_dict
from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops import gru_hside as JG

from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.ops.gru_hside import K2Plan

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "rpg_ramnet_tpu_torch" / "csrc"
PREFIX = "statenetphasedrecurrent."
# (B, H, W, C): the training cells (B=16), the ragged cells of chip_smoke.py
# and K1's edge cells (H or W below the tile, H = W = 1, C = 16, 48, 96)
TRAIN = ((16, 112, 112, 64), (16, 56, 56, 128), (16, 28, 28, 256))
EDGE = ((3, 30, 45, 96), (1, 5, 40, 64), (2, 9, 3, 128), (1, 3, 37, 256),
        (1, 1, 1, 64), (2, 1, 1, 256), (1, 20, 24, 16), (2, 17, 19, 48),
        (3, 33, 21, 96))


def _cell(C, seed=0):
    """A JAX ConvGRU param dict and the port's ConvGRU with its weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    cell = ConvGRU(C, C)
    cell.load_state_dict({k[len(PREFIX):]: torch.from_numpy(np.array(v))
                          for k, v in params_to_state_dict(p).items()},
                         strict=True)
    return p, cell


def _convT_oihw(w):
    """Forward-layout [9, O, I] -> the transposed conv's OIHW [I, O, 3, 3]:
    [i, o, ky, kx] = w[8 - (3*ky + kx), o, i], the tap flipped."""
    return w.flip(0).reshape(3, 3, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)


def k2_emulated(g, h, acts, w_ur, w_o, plan):
    """The tile's decomposition in plain torch (NHWC, the inputs' dtype):
    per output tile, phase o on the tile plus its 2-pixel ring (dpre_o,
    and dpre_z on the 1-pixel ring, 0 outside the image); phase da on the
    1-pixel ring (dpre_r there, da * r at the tile); then phase dh over the
    [dpre_z | dpre_r] tile.  The weights come in the forward layout, the
    taps flipped."""
    B, H, W, C = h.shape
    th, tw = plan.tile_h, plan.tile_w
    pad = lambda t: F.pad(t.permute(0, 3, 1, 2), (2, 2 + tw, 2, 2 + th))  # noqa: E731
    gp, hp, ap = pad(g), pad(h), pad(acts)
    wo, wur = _convT_oihw(w_o), _convT_oihw(w_ur)
    dh = torch.zeros(B, C, H + th, W + tw, dtype=h.dtype)
    dgx = torch.zeros(B, 3 * C, H + th, W + tw, dtype=h.dtype)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            win = (slice(None), slice(None), slice(y0, y0 + th + 4),
                   slice(x0, x0 + tw + 4))
            gt, ht, at = gp[win], hp[win], ap[win]
            z, r, o = at[:, :C], at[:, C:2 * C], at[:, 2 * C:]
            dpo = gt * z * (1 - o * o)                             # 2-pixel ring
            dpz = (gt * (o - ht) * z * (1 - z))[:, :, 1:-1, 1:-1]   # 1-pixel ring
            base = (gt * (1 - z))[:, :, 2:-2, 2:-2]                 # the tile
            da = F.conv2d(dpo, wo)                                  # 1-pixel ring
            h1, r1 = ht[:, :, 1:-1, 1:-1], r[:, :, 1:-1, 1:-1]
            dpr = da * h1 * r1 * (1 - r1)
            ur = torch.cat([dpz, dpr], 1)
            out = (slice(None), slice(None), slice(y0, y0 + th), slice(x0, x0 + tw))
            dh[out] = base + (da * r1)[:, :, 1:-1, 1:-1] + F.conv2d(ur, wur)
            dgx[out] = torch.cat([dpz, dpr, dpo[:, :, 1:-1, 1:-1]], 1)[:, :, 1:-1, 1:-1]
    back = lambda t: t[:, :, :H, :W].permute(0, 2, 3, 1)  # noqa: E731
    return back(dh), back(dgx)


# images the JAX kernel takes (its H tile divides H) under tiles that leave
# ragged edges, a tile beyond the image, 1x1 tiles, C = 16 and 48
EMULATED = ((1, 12, 16, 16, K2Plan(5, 7, 0, 16)),
            (2, 8, 24, 32, K2Plan(2, 8, 1, 16)),
            (1, 12, 16, 64, K2Plan(7, 8, 2, 16)),
            (1, 4, 8, 48, K2Plan(16, 16, 2, 16)),
            (1, 4, 8, 32, K2Plan(1, 1, 0, 32)),
            (2, 8, 16, 48, K2Plan(3, 4, 1, 16)))


def _case_id(v):
    return "x".join(map(str, v)) if isinstance(v, K2Plan) else str(v)


@pytest.mark.parametrize("jax_bwd", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("B,H,W,C,plan", EMULATED, ids=_case_id)
def test_k2_emulated_matches_jax_backward(B, H, W, C, plan, jax_bwd):
    """float32: the decomposition K2 runs under a plan gives the JAX Pallas
    backward's (interpret mode) and the XLA backward's dh and dgx (1e-5),
    from the same residuals."""
    p, cell = _cell(C, seed=C + H)
    rng = np.random.RandomState(C + W)
    h = jnp.asarray(rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32))
    x = jnp.asarray(rng.randn(B, H, W, C).astype(np.float32))
    g = jnp.asarray(rng.randn(B, H, W, C).astype(np.float32))
    gx = JL.conv_gru_x_gates(p, x)
    tile_h = 4
    _, res = JG._gru_hside_fwd(tile_h, True, p, gx, h)
    fn = (JG._gru_hside_bwd_kernel_path if jax_bwd == "pallas_interpret"
          else JG._gru_hside_bwd_xla)
    _, want_dgx, want_dh = fn(tile_h, True, res, g)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    with torch.no_grad():
        w_ur, w_o = cell.hside_weights()
        dh, dgx = k2_emulated(t(g), t(h), t(res[3]), w_ur, w_o, plan)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dgx.numpy(), np.asarray(want_dgx), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", TRAIN + EDGE, ids=lambda s: "x".join(map(str, s)))
def test_k2_plan_fits(shape):
    """Every plan kind at the shape fits a block's shared memory, covers
    the image with tiles no larger than it, and its slab width divides
    C."""
    B, H, W, C = shape
    plan = gru_hside.plan_k2(*shape)
    kinds = gru_hside.k2_plan_kinds(*shape)
    assert plan is not None and kinds[0] == plan
    assert len(set(kinds)) == len(kinds)
    for p in kinds:
        gru_hside.check_k2_plan(p, C)
        assert gru_hside.k2_smem_bytes(p.tile_h, p.tile_w, C, p.ks) <= 232448
        assert C % p.ks == 0
        assert 1 <= p.tile_h <= H and 1 <= p.tile_w <= W
        assert math.ceil(H / p.tile_h) * p.tile_h >= H
        assert math.ceil(W / p.tile_w) * p.tile_w >= W
        assert gru_hside.plan_blocks(p, B, H, W) == (
            B * math.ceil(H / p.tile_h) * math.ceil(W / p.tile_w))


def _c_expr(expr):
    """A C expression of k2_smem_bytes as Python: casts and sizeof
    resolved, '/' on ints as '//'."""
    expr = re.sub(r"\(size_t\)", "", expr)
    expr = expr.replace("sizeof(bf16)", "2").replace("sizeof(float)", "4")
    return expr.replace("kStages", "2").replace("kPad", "8").replace(" / ", " // ")


def test_k2_smem_bytes_matches_the_c_formula():
    """ops/gru_hside.py::k2_smem_bytes is csrc/gru_hside_bwd_tile.cuh's
    k2_smem_bytes, which sizes the launch and which the C entry checks, at
    every plan kind of every shape above and at each slab width."""
    src = (CSRC / "gru_hside_bwd_tile.cuh").read_text()
    body = re.search(r"inline size_t k2_smem_bytes\(([^)]*)\)\s*\{(.*?)\n\}",
                     src, re.S).group(2)
    stmts = [" ".join(s.split()) for s in body.split(";") if s.strip()]
    assert stmts[0].startswith("const size_t ") and stmts[1].startswith("return ")
    defs = [d.split("=", 1) for d in stmts[0][len("const size_t "):].split(", ")]
    ret = _c_expr(stmts[1][len("return "):])
    checked = 0
    for shape in TRAIN + EDGE:
        C = shape[-1]
        for p in gru_hside.k2_plan_kinds(*shape):
            for ks in (16, 32, 64):
                env = {"TH": p.tile_h, "TW": p.tile_w, "C": C, "ks": ks}
                for name, value in defs:
                    env[name.strip()] = eval(_c_expr(value), {}, env)
                assert eval(ret, {}, env) == gru_hside.k2_smem_bytes(
                    p.tile_h, p.tile_w, C, ks)
                checked += 1
    assert checked > 60


@pytest.mark.parametrize("shape", TRAIN, ids=lambda s: "x".join(map(str, s)))
def test_k2_plan_cuts_weight_bytes(shape):
    """The weight ring streams each weight byte once per block and pass:
    at the training shapes the planner's plan streams fewer weight bytes
    per launch than the first design's per-item reads (1850 / 1850 / 3699
    MB), and no plan kind streams more."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    first = gru_hside_timing.k2_first_design_weight_bytes(gru_hside, *shape)
    assert round(first / 1e6) in (1850, 3699)
    assert gru_hside.k2_weight_bytes(gru_hside.plan_k2(*shape), *shape) < first
    for p in gru_hside.k2_plan_kinds(*shape):
        assert gru_hside.k2_weight_bytes(p, *shape) <= first


def test_k2_signatures_match_the_c_entries():
    """The ctypes signatures of csrc/gru_hside_bwd.cu's C entries (loaded
    only on a card) take as many arguments, of the same kinds, as the
    source declares."""
    src = (CSRC / "gru_hside_bwd.cu").read_text()
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, (restype, argtypes) in gru_hside._BWD_SIGNATURES.items():
        m = re.search(r"\n(\S[^\n(]*?)\b" + name + r"\(([^)]*)\)\s*\{", src)
        assert m, name
        params = [" ".join(p.split()) for p in m.group(2).split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
                for p in params]
        assert list(argtypes) == want, name
        assert restype == (ctypes.c_char_p if "char*" in m.group(1) else ctypes.c_int)


@pytest.mark.parametrize("cell", ((1, 128, 256), (16, 112, 112), (16, 28, 28),
                                  (3, 30, 45), (1, 1, 1), (2, 3, 5), (1, 7, 300)),
                         ids=lambda c: "x".join(map(str, c)))
def test_k2_plan_wherever_supports(cell):
    """Wherever the gate ``supports`` holds, K2 has a plan: the Function
    never meets a shape its backward cannot run."""
    held = 0
    for C in range(16, 1240, 16):
        h = torch.empty(*cell, C, dtype=torch.bfloat16, device="meta")
        if gru_hside.supports(h):
            held += 1
            plan = gru_hside.plan_k2(*h.shape)
            assert plan is not None, C
            gru_hside.check_k2_plan(plan, C)
    assert held >= 40


# the first design's tiles (pick_tile) of the launch variants K9-K11
# (smem_bytes), at their shapes: a term of the gate ``supports`` since the
# variants run K1's plans
OTHER_TILES = {
    ("variants", (1, 128, 256, 64)): (16, 16), ("variants", (1, 64, 128, 128)): (8, 8),
    ("variants", (1, 32, 64, 256)): (4, 4), ("variants", (2, 15, 23, 32)): (4, 4),
}


@pytest.mark.parametrize("key", sorted(OTHER_TILES), ids=lambda k: f"{k[0]}-" + "x".join(map(str, k[1])))
def test_other_kernels_keep_their_tile(key):
    kind, shape = key
    smem = {"variants": gru_hside.smem_bytes}[kind]
    h = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert gru_hside.pick_tile(*shape, smem=smem) == OTHER_TILES[key]
    assert gru_hside.supports(h)


def test_k2_plan_argument_checked_on_cpu():
    """On CPU tensors the wrapper runs the plain version under any plan
    that fits and raises on one that does not."""
    gen = torch.Generator().manual_seed(0)
    B, H, W, C = 1, 8, 8, 96
    h = torch.randn(B, H, W, C, generator=gen)
    g = torch.randn(B, H, W, C, generator=gen)
    acts = torch.rand(B, H, W, 3 * C, generator=gen)
    w_ur = torch.randn(9, 2 * C, C, generator=gen) * 0.05
    w_o = torch.randn(9, C, C, generator=gen) * 0.05
    want = gru_hside.conv_gru_hside_bwd_plain(g, h, acts, w_ur, w_o)
    got = gru_hside.conv_gru_hside_bwd(g, h, acts, w_ur, w_o,
                                       _plan=K2Plan(4, 4, 1, 32))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (K2Plan(4, 4, -1, 32), K2Plan(4, 4, 3, 32),
                K2Plan(4, 4, 1, 64), K2Plan(4, 4, 1, 48),
                K2Plan(0, 4, 1, 32), K2Plan(64, 64, 1, 32)):
        with pytest.raises(ValueError):
            gru_hside.conv_gru_hside_bwd(g, h, acts, w_ur, w_o, _plan=bad)


def test_k2_model_is_the_committed_fit():
    """``_K2_MODEL`` is what ``gru_hside_timing.py --bwd --fit`` gives on the
    committed sweep (gru_hside_bwd_sweep.jsonl, timed on an H100), and the
    fit picks within 5% of the swept best at each timed shape."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    with open(ROOT / gru_hside_timing.BWD_SWEEP_FILE) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    model, report = gru_hside_timing.fit_model(lines, bwd=True)
    assert model == gru_hside._K2_MODEL
    assert len(report["picks"]) == 3
    for key, pick in report["picks"].items():
        assert pick["pick_over_best"] <= 1.05, (key, pick)
