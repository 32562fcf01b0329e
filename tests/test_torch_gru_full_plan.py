"""The plan of the port's whole-ConvGRU-cell kernel K5
(ops/gru_hside.py::plan_k5, csrc/gru_full_tile.cuh): a plain-torch
emulation of the tile's decomposition against the JAX Pallas kernel
``conv_gru_full_fused`` in interpret mode, shared memory and tiles at the
shapes the port runs, the C side's shared-memory formula and entry point,
the weight bytes the tile saves, the gate ``supports_full`` (every
shape it admitted before, a K5 plan wherever it holds), the private plan
argument, and the cost model against its committed sweep.  The kernel
itself is tested on a card in tests/test_torch_cuda.py.
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

from rpg_ramnet_tpu.models import layers as JL
from rpg_ramnet_tpu.ops.gru_hside import conv_gru_full_fused

from rpg_ramnet_tpu_torch.compat import params_to_state_dict
from rpg_ramnet_tpu_torch.models.layers import ConvGRU
from rpg_ramnet_tpu_torch.ops import gru_hside
from rpg_ramnet_tpu_torch.ops.gru_hside import K5Plan
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "rpg_ramnet_tpu_torch" / "csrc"
PREFIX = "statenetphasedrecurrent."
BF16_ULP = 2.0 ** -7
# (B, H, W, C): the per-package cells, the ragged cell of chip_smoke.py and
# K1's edge cells (H or W below the tile, H = W = 1, C = 16, 48, 96)
FLAGSHIP = ((1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256))
EDGE = ((2, 30, 45, 96), (1, 5, 40, 64), (2, 9, 3, 128), (1, 3, 37, 256),
        (1, 1, 1, 64), (2, 1, 1, 256), (1, 20, 24, 16), (2, 17, 19, 48),
        (3, 33, 21, 96))


def _cell(C, seed, dtype):
    """A JAX ConvGRU param dict with nonzero biases (representable in
    dtype, as the JAX kernel rounds them to it) and the port's ConvGRU
    with the same weights."""
    p = JL.conv_gru_init(jax.random.PRNGKey(seed), C, C, 3, jnp.float32)
    rng = np.random.RandomState(seed)
    for gate in ("update_gate", "reset_gate", "out_gate"):
        b = torch.from_numpy(rng.uniform(-0.5, 0.5, C).astype(np.float32))
        p[gate]["bias"] = jnp.asarray(b.to(dtype).float().numpy())
    cell = ConvGRU(C, C)
    cell.load_state_dict({k[len(PREFIX):]: torch.from_numpy(np.array(v))
                          for k, v in params_to_state_dict(p).items()},
                         strict=True)
    return p, cell


def k5_emulated(x, h, w_ur, w_o, b_ur, b_o, plan):
    """The tile's decomposition in plain torch (NHWC in, NHWC out, h's
    dtype; f32 accumulation).  Per output tile and per block of a cluster
    (its C/split output channels): phase r on the tile plus its 1-pixel
    ring, then a = r*h rounded to h's dtype (0 outside the image, where h
    is); the blocks' a slices make the a tile; phase z/o on the tile, z
    over [x | h] and o over [x | a].  Each conv is accumulated slab by slab
    in the kernel's K walk: the x half (9 taps x C/ks slabs of ks inputs),
    then the h (or a) half."""
    B, H, W, C = h.shape
    th, tw, cn, ks = plan.tile_h, plan.tile_w, C // plan.split, plan.ks
    f32 = torch.float32
    pad = lambda t: F.pad(t.permute(0, 3, 1, 2).to(f32), (2, 2 + tw, 2, 2 + th))  # noqa: E731
    xp, hp = pad(x), pad(h)
    wur, wo = w_ur.to(h.dtype).to(f32), w_o.to(h.dtype).to(f32)

    def walk(acc, srcs, w, rows, oh, ow):
        """acc [B, rows, oh, ow] += the 3x3 conv of srcs (x half, other
        half) with w[:, rows, :], slab by slab."""
        for half, src in enumerate(srcs):
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                win = src[:, :, ky:ky + oh, kx:kx + ow]
                for k0 in range(0, C, ks):
                    wt = w[tap][rows][:, half * C + k0:half * C + k0 + ks]
                    acc = acc + torch.einsum("bkyx,ok->boyx", win[:, k0:k0 + ks], wt)
        return acc

    out = torch.zeros(B, C, H + th, W + tw, dtype=f32)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            xt = xp[:, :, y0:y0 + th + 4, x0:x0 + tw + 4]
            ht = hp[:, :, y0:y0 + th + 4, x0:x0 + tw + 4]
            a = []
            for c0 in range(0, C, cn):   # phase r per block of the cluster
                rows = slice(C + c0, C + c0 + cn)
                acc = walk(torch.zeros(B, cn, th + 2, tw + 2), (xt, ht), wur, rows,
                           th + 2, tw + 2)
                r = torch.sigmoid(acc + b_ur[rows].view(1, -1, 1, 1))
                a.append((r * ht[:, c0:c0 + cn, 1:-1, 1:-1]).to(h.dtype).to(f32))
            a = torch.cat(a, 1)
            for c0 in range(0, C, cn):   # phase z/o per block
                rows = slice(c0, c0 + cn)
                z = torch.sigmoid(walk(torch.zeros(B, cn, th, tw), (xt[:, :, 1:-1, 1:-1],
                                       ht[:, :, 1:-1, 1:-1]), wur, rows, th, tw)
                                  + b_ur[rows].view(1, -1, 1, 1))
                o = torch.tanh(walk(torch.zeros(B, cn, th, tw), (xt[:, :, 1:-1, 1:-1], a),
                                    wo, rows, th, tw) + b_o[rows].view(1, -1, 1, 1))
                hc = ht[:, c0:c0 + cn, 2:-2, 2:-2]
                out[:, c0:c0 + cn, y0:y0 + th, x0:x0 + tw] = hc * (1 - z) + o * z
    return out[:, :, :H, :W].permute(0, 2, 3, 1).to(h.dtype)


# images the JAX kernel takes (its H tile, 2 here, divides H) under every
# plan kind:
# tiles that leave ragged edges, a tile beyond the image, 1x1 tiles, each
# combo, a split of 2, every slab width, C = 16, 32 and 48
EMULATED = ((1, 12, 16, 16, K5Plan(5, 7, 1, 0, 16)),
            (2, 8, 12, 32, K5Plan(3, 5, 2, 1, 16)),
            (1, 8, 10, 48, K5Plan(16, 16, 1, 2, 16)),
            (1, 4, 6, 32, K5Plan(1, 1, 2, 3, 32)),
            (2, 6, 9, 32, K5Plan(4, 4, 1, 1, 32)),
            (1, 6, 7, 48, K5Plan(2, 3, 1, 3, 16)),
            (1, 8, 8, 32, K5Plan(3, 3, 1, 0, 32)))


def _case_id(v):
    return "x".join(map(str, v)) if isinstance(v, K5Plan) else str(v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,C,plan", EMULATED, ids=_case_id)
def test_k5_emulated_matches_jax_kernel(B, H, W, C, plan, dtype):
    """The decomposition K5 runs under a plan gives the JAX Pallas kernel's
    h' (interpret mode) on the same inputs: float32 within 1e-5, bfloat16
    within one bf16 ulp (2^-7: the two round a = r*h and h' after f32 sums
    taken in another order)."""
    gru_hside.check_k5_plan(plan, C)
    td = getattr(torch, dtype)
    p, cell = _cell(C, seed=C + H, dtype=td)
    rng = np.random.RandomState(C + W)
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(td)
    h = torch.from_numpy(rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)).to(td)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    j = lambda t: jnp.asarray(t.float().numpy(), jd)  # noqa: E731
    want = np.asarray(conv_gru_full_fused(p, j(x), j(h), tile_h=2, interpret=True),
                      np.float32)
    with torch.no_grad():
        w_ur, w_o, b_ur, b_o = cell.full_weights()
        got = k5_emulated(x, h, w_ur, w_o, b_ur, b_o, plan)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", FLAGSHIP + EDGE, ids=lambda s: "x".join(map(str, s)))
def test_k5_plan_fits(shape):
    """Every plan kind at the shape fits a block's shared memory, covers
    the image with tiles no larger than it, and its slab width divides C;
    a split only at C >= 128."""
    B, H, W, C = shape
    plan = gru_hside.plan_k5(*shape)
    kinds = gru_hside.k5_plan_kinds(*shape)
    assert plan is not None and kinds[0] == plan
    assert len(set(kinds)) == len(kinds)
    assert {p.combo for p in kinds} == set(range(len(gru_hside.K5_COMBOS)))
    for p in kinds:
        gru_hside.check_k5_plan(p, C)
        assert gru_hside.k5_smem_bytes(p.tile_h, p.tile_w, C, p.split, p.ks) <= 232448
        assert C % p.ks == 0 and (p.split == 1 or C >= 128)
        assert 1 <= p.tile_h <= H and 1 <= p.tile_w <= W
        assert gru_hside.plan_blocks(p, B, H, W) == (
            B * math.ceil(H / p.tile_h) * math.ceil(W / p.tile_w) * p.split)


def _c_expr(expr):
    """A C expression of k5_smem_bytes as Python: casts and sizeof
    resolved, '/' on ints as '//'."""
    expr = re.sub(r"\(size_t\)", "", expr)
    expr = expr.replace("sizeof(bf16)", "2")
    return expr.replace("kStages", "2").replace("kPad", "8").replace(" / ", " // ")


def test_k5_smem_bytes_matches_the_c_formula():
    """ops/gru_hside.py::k5_smem_bytes is csrc/gru_full_tile.cuh's
    k5_smem_bytes, which sizes the launch and which the C entry checks, at
    every plan kind of every shape above, each split and each slab width."""
    src = (CSRC / "gru_full_tile.cuh").read_text()
    body = re.search(r"inline size_t k5_smem_bytes\(([^)]*)\)\s*\{(.*?)\n\}",
                     src, re.S).group(2)
    stmts = [" ".join(s.split()) for s in body.split(";") if s.strip()]
    assert stmts[0].startswith("const size_t ") and stmts[1].startswith("return ")
    defs = [d.split("=", 1) for d in stmts[0][len("const size_t "):].split(", ")]
    ret = _c_expr(stmts[1][len("return "):])
    checked = 0
    for shape in FLAGSHIP + EDGE:
        C = shape[-1]
        for p in gru_hside.k5_plan_kinds(*shape):
            for split in (1, 2):
                for ks in (16, 32, 64):
                    env = {"TH": p.tile_h, "TW": p.tile_w, "C": C, "split": split,
                           "ks": ks}
                    for name, value in defs:
                        env[name.strip()] = eval(_c_expr(value), {}, env)
                    assert eval(ret, {}, env) == gru_hside.k5_smem_bytes(
                        p.tile_h, p.tile_w, C, split, ks)
                    checked += 1
    assert checked > 300


@pytest.mark.parametrize("shape", FLAGSHIP, ids=lambda s: "x".join(map(str, s)))
def test_k5_plan_cuts_weight_bytes(shape):
    """The weight ring streams each weight byte once per block and pass:
    at the per-package shapes the planner's plan streams at most half of
    the first design's per-item weight bytes per launch (pick_tile's tile,
    9 taps x 16 rows x 2C per 32-pixel item: 528 / 604 / 1208 MB)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    first = gru_hside_timing.k5_first_design_weight_bytes(gru_hside, *shape)
    assert round(first / 1e6) in (528, 604, 1208)
    assert 2 * gru_hside.k5_weight_bytes(gru_hside.plan_k5(*shape), *shape) <= first


def test_k5_signatures_match_the_c_entries():
    """The ctypes signatures of csrc/gru_full.cu's C entries (loaded only
    on a card) take as many arguments, of the same kinds, as the source
    declares."""
    src = (CSRC / "gru_full.cu").read_text()
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, (restype, argtypes) in gru_hside._FULL_SIGNATURES.items():
        m = re.search(r"\n(\S[^\n(]*?)\b" + name + r"\(([^)]*)\)\s*\{", src)
        assert m, name
        params = [" ".join(p.split()) for p in m.group(2).split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
                for p in params]
        assert list(argtypes) == want, name
        assert restype == (ctypes.c_char_p if "char*" in m.group(1) else ctypes.c_int)


@pytest.mark.parametrize("cell", ((1, 128, 256), (1, 64, 128), (1, 32, 64),
                                  (2, 30, 45), (3, 33, 21), (2, 17, 19),
                                  (1, 1, 1), (2, 3, 5), (1, 9, 3), (1, 7, 300)),
                         ids=lambda c: "x".join(map(str, c)))
def test_supports_full_keeps_its_answers(cell):
    """``supports_full`` admits every shape the first K5 design's gate
    admitted (bf16, 4-D, C % 16 == 0, a pick_tile tile within that
    design's footprint), so no engine loses K5 where it had it, and K5 has
    a plan wherever the gate holds."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    held = 0
    for C in range(8, 1240, 8):
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.empty(*cell, C, dtype=dtype, device="meta")
            before = (dtype == torch.bfloat16 and C % 16 == 0 and gru_hside.pick_tile(
                *h.shape, smem=gru_hside_timing.k5_first_design_smem_bytes) is not None)
            if before:
                assert gru_hside.supports_full(h), (cell, C)
                held += 1
            if gru_hside.supports_full(h):
                assert dtype == torch.bfloat16 and C % 16 == 0, (cell, C)
                gru_hside.check_k5_plan(gru_hside.plan_k5(*h.shape), C)
    assert held >= 40


def test_k5_plan_argument_checked_on_cpu():
    """On CPU tensors the wrapper runs the plain version under any plan
    that fits and raises on one that does not."""
    gen = torch.Generator().manual_seed(0)
    B, H, W, C = 1, 8, 8, 96
    x = torch.randn(B, H, W, C, generator=gen)
    h = torch.rand(B, H, W, C, generator=gen) * 2 - 1
    w_ur = torch.randn(9, 2 * C, 2 * C, generator=gen) * 0.05
    w_o = torch.randn(9, C, 2 * C, generator=gen) * 0.05
    b_ur, b_o = torch.randn(2 * C, generator=gen), torch.randn(C, generator=gen)
    want = gru_hside.conv_gru_full_plain(x, h, w_ur, w_o, b_ur, b_o)
    got = gru_hside.conv_gru_full(x, h, w_ur, w_o, b_ur, b_o,
                                  _plan=K5Plan(4, 4, 1, 1, 32))
    assert torch.equal(got, want)
    for bad in (K5Plan(4, 4, 1, -1, 32), K5Plan(4, 4, 1, 4, 32),
                K5Plan(4, 4, 4, 0, 32), K5Plan(4, 4, 1, 1, 64),
                K5Plan(4, 4, 1, 1, 48), K5Plan(0, 4, 1, 1, 32),
                K5Plan(64, 64, 1, 1, 32)):
        with pytest.raises(ValueError):
            gru_hside.conv_gru_full(x, h, w_ur, w_o, b_ur, b_o, _plan=bad)


def test_k5_model_is_the_committed_fit():
    """``_K5_MODEL`` is what ``gru_hside_timing.py --full --fit`` gives on
    the committed sweep (gru_full_sweep.jsonl, timed on an H100), and the
    fit picks within 5% of the swept best at each timed shape."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    with open(ROOT / gru_hside_timing.FULL_SWEEP_FILE) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    model, report = gru_hside_timing.fit_model(lines, full=True)
    assert model == gru_hside._K5_MODEL
    assert len(report["picks"]) == 3
    for key, pick in report["picks"].items():
        assert pick["pick_over_best"] <= 1.05, (key, pick)
