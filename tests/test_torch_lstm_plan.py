"""The plan of the port's ConvLSTM kernels, K3 and K4 for inference and
K3-res and K4-res for training (ops/gru_hside.py::plan_lstm,
csrc/lstm_hside_tile.cuh): shared memory, tiles and splits at the shapes
the port runs, the C side's shared-memory formula and entry points, the
weight bytes the tile saves, the gate that admits the kernels, the private
plan argument, and a plain-torch emulation of the tile's decomposition
(output tiles, the halo, each split rank's gate rows, the slab walk, the
io tile's slots) against the JAX Pallas kernels in interpret mode, with
and without the residuals.  The kernels themselves are tested on a card in
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

import jax.numpy as jnp

from rpg_ramnet_tpu.ops import gru_hside as JG
from rpg_ramnet_tpu.ops import phased_cell as JP

from rpg_ramnet_tpu_torch.models.layers import ConvLSTM
from rpg_ramnet_tpu_torch.ops import gru_hside, phased_cell
from rpg_ramnet_tpu_torch.ops.gru_hside import LstmPlan

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "rpg_ramnet_tpu_torch" / "csrc"
LEAK, RATIO_ON = phased_cell.LEAK, phased_cell.RATIO_ON
JAX_TILE_H = 4
# (B, H, W, C): the phased training cells (B=8), the phased and flagship
# inference cells, the ragged cells of chip_smoke.py and two edge cells
TRAIN = ((8, 112, 112, 64), (8, 56, 56, 128), (8, 28, 28, 256))
INFER = ((1, 128, 176, 64), (1, 64, 88, 128), (1, 32, 44, 256),
         (1, 128, 256, 64), (1, 64, 128, 128), (1, 32, 64, 256))
RAGGED = ((3, 30, 45, 96), (1, 1, 1, 16), (2, 5, 3, 48))


def _cell(rng, C):
    """A ConvLSTM on cat(x, h) (x and h of C channels) and the JAX HWIO
    tree of the same weights."""
    bound = 3.0 / np.sqrt(9 * 2 * C)
    w = rng.uniform(-bound, bound, (4 * C, 2 * C, 3, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, 4 * C).astype(np.float32)
    cell = ConvLSTM(C, C)
    with torch.no_grad():
        cell.Gates.weight.copy_(torch.from_numpy(w))
        cell.Gates.bias.copy_(torch.from_numpy(b))
    return cell, {"Gates": {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)),
                            "bias": jnp.asarray(b)}}


def lstm_emulated(h, c, gx, w4, plan, phased=False, tau=None, phase=None,
                  t=None, leak=LEAK, ratio_on=RATIO_ON, acts=True):
    """The tile's decomposition in plain torch (NHWC, float32): per output
    tile the h tile with its 1-pixel halo (zeros outside the image); per
    split rank the conv over its gate rows q*C + c0 .. c0 + cn, accumulated
    in the slab walk's order (tap by tap, ks input channels at a time);
    the io tile's input slots [gx_i | gx_f | gx_o | gx_u | c] of the rank's
    channels; then the gates, the cell and (phased) the time-gate blend,
    staged in the io tile as the kernel stages them (acts: [i | f | o | u]
    in slots 0-3 and the outputs after them; else the outputs over slots 0
    on), and the written slots read back.  Returns K3-res's (h', c', acts)
    or K4-res's (h_t, h_new, c_new, acts); without acts K3's or K4's
    outputs alone."""
    B, H, W, C = h.shape
    th, tw, split, ks = plan.tile_h, plan.tile_w, plan.split, plan.ks
    cn = C // split
    hp = F.pad(h, (0, 0, 1, 1 + tw, 1, 1 + th))
    pad = lambda v: F.pad(v, (0, 0, 0, tw, 0, th))   # noqa: E731
    gxp, cp = pad(gx), pad(c)
    n_out = 3 if phased else 2
    first = 4 if acts else 0                 # the io slot of the first output
    slots = first + n_out if acts else 5
    outs = [torch.zeros(B, H + th, W + tw, C) for _ in range(n_out)]
    act_map = torch.zeros(B, H + th, W + tw, 4 * C)
    if phased:
        # the time gate per (batch item, pixel, channel); 1 outside the
        # image, where nothing is written
        tp = F.pad(tau[None], (0, 0, 0, tw, 0, th), value=1.0)[0]
        pp = F.pad(phase[None], (0, 0, 0, tw, 0, th))[0]
        k_all = phased_cell.gate_k(tp[None], pp[None], t.reshape(-1, 1, 1, 1),
                                   leak, ratio_on)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            ht = hp[:, y0:y0 + th + 2, x0:x0 + tw + 2]
            at = (slice(None), slice(y0, y0 + th), slice(x0, x0 + tw))
            for rank in range(split):
                ch = slice(rank * cn, (rank + 1) * cn)
                rows = torch.cat([q * C + torch.arange(rank * cn, (rank + 1) * cn)
                                  for q in range(4)])
                io = torch.zeros(B, th, tw, slots, cn)
                io[..., :4, :] = gxp[at][..., rows].unflatten(-1, (4, cn))
                io[..., 4, :] = cp[at][..., ch]
                acc = torch.zeros(B, th, tw, 4 * cn)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    win = ht[:, ky:ky + th, kx:kx + tw]
                    for k0 in range(0, C, ks):
                        acc = acc + win[..., k0:k0 + ks] @ w4[tap][rows, k0:k0 + ks].T
                g = acc + io[..., :4, :].flatten(-2)
                i, f, o = (torch.sigmoid(g[..., q * cn:(q + 1) * cn]) for q in range(3))
                u = torch.tanh(g[..., 3 * cn:])
                cin = io[..., 4, :].clone()
                cell = f * cin + i * u
                hid = o * torch.tanh(cell)
                if phased:
                    k = k_all[at + (ch,)]
                    c0 = ht[:, 1:-1, 1:-1, ch]
                    res = (cell, k * cell + (1.0 - k) * cin, k * hid + (1.0 - k) * c0)
                else:
                    res = (hid, cell)
                if acts:
                    io[..., :4, :] = torch.stack([i, f, o, u], -2)
                for j, v in enumerate(res):
                    io[..., first + j, :] = v
                if acts:
                    act_map[at + (rows,)] = io[..., :4, :].flatten(-2)
                for j in range(n_out):
                    outs[j][at + (ch,)] = io[..., first + j, :]
    return tuple(v[:, :H, :W] for v in outs + ([act_map] if acts else []))


# images the JAX kernels take (H % 4 == 0, W % 8 == 0) under tiles that
# leave ragged edges, a tile beyond the image, 1x1 tiles, splits of 2,
# every slab width
EMULATED = ((1, 12, 16, 16, LstmPlan(5, 7, 1, 0, 16)),
            (2, 8, 24, 32, LstmPlan(3, 8, 2, 1, 16)),
            (1, 12, 16, 64, LstmPlan(7, 8, 2, 2, 32)),
            (1, 4, 8, 48, LstmPlan(16, 16, 1, 1, 16)),
            (1, 4, 8, 32, LstmPlan(1, 1, 2, 0, 32)),
            (2, 8, 16, 64, LstmPlan(3, 4, 2, 0, 64)))


def _case_id(v):
    return "x".join(map(str, v)) if isinstance(v, LstmPlan) else str(v)


@pytest.mark.parametrize("residuals", [True, False], ids=["res", "infer"])
@pytest.mark.parametrize("phased", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("B,H,W,C,plan", EMULATED, ids=_case_id)
def test_lstm_emulated_matches_jax_kernel(B, H, W, C, plan, phased, residuals):
    """float32: the decomposition K3-res (K4-res) runs under a plan gives
    the JAX residual kernel's outputs and acts, and the one K3 (K4) runs,
    without the acts, gives the JAX inference kernel's outputs
    (``_run_lstm``, ``_run_phased`` with residuals=False, on the weight
    ``_fold3`` folds) (1e-5)."""
    rng = np.random.RandomState(C + H)
    cell, tree = _cell(rng, C)
    arr = lambda *s, scale=1.0: (rng.uniform(-1, 1, s) * scale).astype(np.float32)  # noqa: E731
    h, c = arr(B, H, W, C), arr(B, H, W, C, scale=2.0)
    gx = rng.randn(B, H, W, 4 * C).astype(np.float32)
    with torch.no_grad():
        w4 = cell.hside_weights(torch.float32)
    th = lambda v: torch.from_numpy(v)   # noqa: E731
    jw4 = JG._fold3(tree["Gates"]["weight"][:, :, -C:]).astype(jnp.float32)
    if phased:
        tau = np.exp(rng.uniform(np.log(0.02), np.log(50.0), (H, W, C))).astype(np.float32)
        phase = (rng.uniform(0, 1, (H, W, C)) * tau).astype(np.float32)
        t = rng.uniform(0, 3, (B, 1)).astype(np.float32)
        if residuals:
            want, res = JP._phased_cell_fwd(JAX_TILE_H, LEAK, RATIO_ON, True, tree,
                                            jnp.asarray(gx), jnp.asarray(h),
                                            jnp.asarray(c), jnp.asarray(tau),
                                            jnp.asarray(phase), jnp.asarray(t))
        else:
            want = JP._run_phased(jnp.asarray(h), jnp.asarray(c), jnp.asarray(gx),
                                  jw4, jnp.asarray(tau), jnp.asarray(phase),
                                  jnp.asarray(t), JAX_TILE_H, LEAK, RATIO_ON,
                                  interpret=True, residuals=False)
        got = lstm_emulated(th(h), th(c), th(gx), w4, plan, True, th(tau),
                            th(phase), th(t).reshape(B), acts=residuals)
    else:
        if residuals:
            want, res = JG._lstm_hside_fwd(JAX_TILE_H, True, tree, jnp.asarray(gx),
                                           jnp.asarray(h), jnp.asarray(c))
        else:
            want = JG._run_lstm(jnp.asarray(h), jnp.asarray(c), jnp.asarray(gx),
                                jw4, JAX_TILE_H, interpret=True, residuals=False)
        got = lstm_emulated(th(h), th(c), th(gx), w4, plan, acts=residuals)
    want = tuple(want) + ((res[-1],) if residuals else ())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _kind_id(phased, residuals):
    return f"k{4 if phased else 3}{'_res' if residuals else ''}"


# K3-res and K4-res at every shape, K3 and K4 where they run: the
# inference shapes and the ragged ones
PLAN_CASES = [(shape, phased, True) for shape in TRAIN + INFER + RAGGED
              for phased in (False, True)] + \
             [(shape, phased, False) for shape in INFER + RAGGED
              for phased in (False, True)]


@pytest.mark.parametrize("shape,phased,residuals", PLAN_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_lstm_plan_fits(shape, phased, residuals):
    """Every plan kind at the shape fits a block's shared memory, covers
    the image with tiles no larger than it, splits only at C >= 128, by a
    divisor of C/16 and no more than the kernel's planner weighs, and its
    slab width divides C."""
    B, H, W, C = shape
    kw = {"phased": phased, "residuals": residuals}
    plan = gru_hside.plan_lstm(*shape, **kw)
    kinds = gru_hside.lstm_plan_kinds(*shape, **kw)
    assert plan is not None and kinds[0] == plan
    assert len(set(kinds)) == len(kinds)
    for p in kinds:
        gru_hside.check_lstm_plan(p, C, **kw)
        assert gru_hside.lstm_smem_bytes(p.tile_h, p.tile_w, C, p.split, p.ks,
                                         **kw) <= 232448
        assert (C // 16) % p.split == 0 and (p.split == 1 or C >= 128)
        assert p.split <= gru_hside._LSTM_MAX_SPLIT[residuals]
        assert C % p.ks == 0
        assert 1 <= p.tile_h <= H and 1 <= p.tile_w <= W
        assert math.ceil(H / p.tile_h) * p.tile_h >= H
        assert math.ceil(W / p.tile_w) * p.tile_w >= W
        assert gru_hside.plan_blocks(p, B, H, W) == (
            B * math.ceil(H / p.tile_h) * math.ceil(W / p.tile_w) * p.split)
    # K4-res's footprint is the largest of the four: its plans run the
    # other three too
    big = gru_hside.plan_lstm(*shape, phased=True, residuals=True)
    for ph in (False, True):
        for res in (False, True):
            gru_hside.check_lstm_plan(big, C, ph, res)


def _c_expr(expr):
    """A C expression of lstm_smem_bytes as Python: casts and sizeof
    resolved, '/' on ints as '//', a ? b : c as (b if a else c)."""
    expr = re.sub(r"\(size_t\)", "", expr)
    expr = expr.replace("sizeof(bf16)", "2").replace("sizeof(float)", "4")
    expr = expr.replace("kStages", "2").replace("kPad", "8").replace(" / ", " // ")
    while "?" in expr:
        q = expr.index("?")
        start, depth = q, 0
        while depth >= 0:            # the '(' that opens the conditional
            start -= 1
            depth += {")": 1, "(": -1}.get(expr[start], 0)
        end, depth, colon = q, 0, None
        while depth >= 0:            # its ':' and the ')' that closes it
            end += 1
            depth += {"(": 1, ")": -1}.get(expr[end], 0)
            if expr[end] == ":" and depth == 0:
                colon = end
        cond, a, b = expr[start + 1:q], expr[q + 1:colon], expr[colon + 1:end]
        expr = f"{expr[:start]}(({a}) if ({cond}) else ({b})){expr[end + 1:]}"
    return expr


def test_lstm_smem_bytes_matches_the_c_formula():
    """ops/gru_hside.py::lstm_smem_bytes is csrc/lstm_hside_tile.cuh's
    lstm_smem_bytes, which sizes the launch, at every plan kind of every
    kernel and shape above, at each slab width, with and without the acts
    and the phased flag."""
    src = (CSRC / "lstm_hside_tile.cuh").read_text()
    body = re.search(r"inline size_t lstm_smem_bytes\(([^)]*)\)\s*\{(.*?)\n\}",
                     src, re.S).group(2)
    stmts = [" ".join(s.split()) for s in body.split(";") if s.strip()]
    assert stmts[0].startswith("const size_t ") and stmts[1].startswith("return ")
    defs = [d.split("=") for d in stmts[0][len("const size_t "):].split(", ")]
    ret = _c_expr(stmts[1][len("return "):])
    checked = 0
    for shape, phased, residuals in PLAN_CASES:
        C = shape[-1]
        for p in gru_hside.lstm_plan_kinds(*shape, phased=phased, residuals=residuals):
            for ks in (16, 32, 64):
                for ph in (False, True):
                    for acts in (False, True):
                        env = {"TH": p.tile_h, "TW": p.tile_w, "C": C,
                               "split": p.split, "ks": ks, "phased": ph,
                               "acts": acts}
                        for name, value in defs:
                            env[name.strip()] = eval(_c_expr(value), {}, env)
                        assert eval(ret, {}, env) == gru_hside.lstm_smem_bytes(
                            p.tile_h, p.tile_w, C, p.split, ks, ph, acts)
                        checked += 1
    assert checked > 400


@pytest.mark.parametrize("phased", [False, True], ids=["k3_res", "k4_res"])
@pytest.mark.parametrize("shape", TRAIN, ids=lambda s: "x".join(map(str, s)))
def test_lstm_plan_cuts_weight_bytes(shape, phased):
    """The weight ring streams each weight byte once per block and pass:
    at the training shapes, where K3-res and K4-res run, the planner's plan
    streams fewer weight bytes per launch than the first design's 9*4*16*C
    bf16 per 32-pixel x 16-channel warp item, 2.25*B*H*W*C^2 bytes."""
    B, H, W, C = shape
    plan = gru_hside.plan_lstm(*shape, phased=phased, residuals=True)
    assert gru_hside.lstm_weight_bytes(plan, *shape) < 2.25 * B * H * W * C * C


@pytest.mark.parametrize("phased", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("shape", INFER, ids=lambda s: "x".join(map(str, s)))
def test_k3_k4_plan_cuts_weight_bytes(shape, phased):
    """At the inference shapes K3's and K4's plans stream at most the first
    design's 2.25*B*H*W*C^2 weight bytes per launch, and fewer wherever the
    plan's tile is over 32 pixels (the first design's warp item)."""
    B, H, W, C = shape
    plan = gru_hside.plan_lstm(*shape, phased=phased)
    first = 2.25 * B * H * W * C * C
    got = gru_hside.lstm_weight_bytes(plan, *shape)
    assert got <= first
    if plan.tile_h * plan.tile_w > 32:
        assert got < first


# the shapes where the committed fit picks further than 5% from the swept
# best, and how far: at 1x32x44x256 the 4x14 tile (split 4, 32-pixel jobs)
# runs 5-6% under every other one-pass plan in each of three timings, and
# no term of the tile's geometry the model was tried with captures it
# (PERF.md §6); everywhere else 5%
FIT_MISSES = {"k3 1x32x44x256": 1.06, "k4 1x32x44x256": 1.06}


def test_lstm_model_is_the_committed_fit():
    """``_LSTM_MODEL`` is what ``gru_hside_timing.py --lstm --fit`` gives on
    the committed sweep (lstm_hside_sweep.jsonl, timed on an H100), and the
    fit picks within 5% of the swept best at each timed shape of K3-res
    and K4-res (B=8) and of K3 and K4 (B=1) but those of FIT_MISSES, within
    their bound."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    with open(ROOT / gru_hside_timing.LSTM_SWEEP_FILE) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    model, report = gru_hside_timing.fit_model(lines, lstm=True)
    assert model == gru_hside._LSTM_MODEL
    assert len(report["picks"]) == 15
    for key, pick in report["picks"].items():
        assert pick["pick_over_best"] <= FIT_MISSES.get(key, 1.05), (key, pick)


def test_lstm_signatures_match_the_c_entries():
    """The ctypes signatures of csrc/lstm_hside.cu's C entries (loaded only
    on a card) take as many arguments, of the same kinds, as the source
    declares, and K3's and K4's take the plan as the -res entries do."""
    src = (CSRC / "lstm_hside.cu").read_text()
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    for name, (restype, argtypes) in gru_hside._LSTM_SIGNATURES.items():
        m = re.search(r"\n(\S[^\n(]*?)\b" + name + r"\(([^)]*)\)\s*\{", src)
        assert m, name
        params = [" ".join(p.split()) for p in m.group(2).split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
                for p in params]
        assert list(argtypes) == want, name
        assert restype == (ctypes.c_char_p if "char*" in m.group(1) else ctypes.c_int)
        if name.endswith("_forward") or name.endswith("_forward_res"):
            names = [p.rsplit(" ", 1)[1] for p in params]
            assert names[names.index("gx_bstride") + 1:][:5] == [
                "tile_h", "tile_w", "split", "combo", "ks"], name


# cells (B, H, W) at which supports_lstm is held to the first gate over
# every C: the shapes above and edges (one pixel, rows or columns under
# the tiles, odd sides)
GATE_CELLS = sorted({s[:3] for s in TRAIN + INFER + RAGGED}
                    | {(1, 1, 1), (2, 3, 1), (1, 5, 33), (4, 17, 19), (1, 260, 346)})


@pytest.mark.parametrize("cell", GATE_CELLS, ids=lambda c: "x".join(map(str, c)))
def test_supports_lstm_keeps_its_answers(cell):
    """``supports_lstm`` admits every shape the first K3/K4 design's gate
    admitted (bf16, 4-D, C % 16 == 0, a pick_tile tile within that
    design's footprint, a K4-res plan), so no engine loses K3 or K4 where
    it had them, and each of the four kernels has a plan wherever the gate
    holds."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import gru_hside_timing
    held = 0
    for C in range(8, 1240, 8):
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.empty(*cell, C, dtype=dtype, device="meta")
            before = (dtype == torch.bfloat16 and C % 16 == 0
                      and gru_hside.pick_tile(
                          *h.shape, smem=gru_hside_timing.lstm_first_design_smem_bytes)
                      is not None
                      and gru_hside.plan_lstm(*h.shape, phased=True,
                                              residuals=True) is not None)
            if before:
                assert gru_hside.supports_lstm(h), (cell, C)
                held += 1
            if gru_hside.supports_lstm(h):
                assert dtype == torch.bfloat16 and C % 16 == 0, (cell, C)
                for phased in (False, True):
                    for res in (False, True):
                        gru_hside.check_lstm_plan(gru_hside.plan_lstm(
                            *h.shape, phased=phased, residuals=res), C, phased, res)
    assert held >= 40


def test_lstm_plan_argument_checked_on_cpu():
    """On CPU tensors the wrappers run the plain versions under any plan
    that fits and raise on one that does not."""
    gen = torch.Generator().manual_seed(0)
    B, H, W, C = 1, 8, 8, 96
    h, c = torch.randn(B, H, W, C, generator=gen), torch.randn(B, H, W, C, generator=gen)
    gx = torch.randn(B, H, W, 4 * C, generator=gen)
    w4 = torch.randn(9, 4 * C, C, generator=gen) * 0.05
    tau = torch.rand(H, W, C, generator=gen) + 0.5
    phase, t = torch.rand(H, W, C, generator=gen), torch.rand(B, generator=gen)
    plan = LstmPlan(4, 4, 2, 1, 32)
    calls = (
        (lambda **kw: gru_hside.conv_lstm_hside_res(h, c, gx, w4, **kw),
         gru_hside.conv_lstm_hside_res_plain(h, c, gx, w4)),
        (lambda **kw: phased_cell.conv_lstm_phased_res(h, c, gx, w4, tau, phase, t, **kw),
         phased_cell.conv_lstm_phased_res_plain(h, c, gx, w4, tau, phase, t)),
        (lambda **kw: gru_hside.conv_lstm_hside(h, c, gx, w4, **kw),
         gru_hside.conv_lstm_hside_plain(h, c, gx, w4)),
        (lambda **kw: phased_cell.conv_lstm_phased(h, c, gx, w4, tau, phase, t, **kw),
         phased_cell.conv_lstm_phased_plain(h, c, gx, w4, tau, phase, t)))
    for fn, want in calls:
        for a, b in zip(fn(_plan=plan), want):
            assert torch.equal(a, b)
        for bad in (LstmPlan(4, 4, 4, 1, 32), LstmPlan(4, 4, 1, 3, 32),
                    LstmPlan(4, 4, 1, 1, 64), LstmPlan(4, 4, 1, 1, 48),
                    LstmPlan(0, 4, 1, 1, 32), LstmPlan(64, 64, 1, 1, 32)):
            with pytest.raises(ValueError):
                fn(_plan=bad)
