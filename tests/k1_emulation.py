"""The decomposition the port's kernels run on K1's tile
(rpg_ramnet_tpu_torch/csrc/gru_hside_tile.cuh), in plain torch: K1 and
K10a (one tile per block, ``k1_emulated``), K11 (every tile of every
step, in the order a persistent grid's clusters walk them,
``k11_emulated``) and K9 and K10b (every block of both scales' grid
through its block -> scale, item, tile and rank map, ``k9_emulated``), and
the plans the CPU tests run them under.  Shared by
tests/test_torch_gru_hside_plan.py, test_torch_gru_variants_plan.py and
test_torch_gru_pair_plan.py, which hold them against the JAX Pallas
kernels in interpret mode.
"""
import torch
import torch.nn.functional as F

from rpg_ramnet_tpu_torch.ops import gru_hside, gru_pair
from rpg_ramnet_tpu_torch.ops.gru_hside import K1Plan

# images the JAX kernels take (H % 4 == 0, W % 8 == 0) under tiles that
# leave ragged edges, a tile beyond the image, 1x1 tiles, splits of 2
EMULATED = ((1, 12, 16, 16, K1Plan(5, 7, 1, 0, 16)),
            (2, 8, 24, 32, K1Plan(2, 8, 2, 1, 16)),
            (1, 12, 16, 64, K1Plan(7, 8, 2, 2, 16)),
            (1, 4, 8, 48, K1Plan(16, 16, 1, 2, 16)),
            (1, 4, 8, 32, K1Plan(1, 1, 2, 0, 32)),
            (2, 8, 16, 64, K1Plan(3, 4, 2, 1, 32)))


def _oihw(w):
    return w.reshape(3, 3, w.shape[1], w.shape[2]).permute(2, 3, 0, 1)


def _padded(h, gx, plan):
    """NCHW h with its 2-pixel halo, gx with its 1-pixel ring (zeros
    outside, and past the last tile), and the image's mask on the ring."""
    _, H, W, _ = h.shape
    th, tw = plan.tile_h, plan.tile_w
    nchw = lambda t: t.permute(0, 3, 1, 2)   # noqa: E731
    return (F.pad(nchw(h), (2, 2 + tw, 2, 2 + th)),
            F.pad(nchw(gx), (1, 1 + tw, 1, 1 + th)),
            F.pad(torch.ones(1, 1, H, W, dtype=h.dtype),
                  (1, 1 + tw, 1, 1 + th)))


def tile_emulated(hp, gp, inside, w_ur, w_o, plan, y0, x0):
    """One output tile at image (y0, x0) as a cluster of plan.split blocks
    computes it, NCHW [B, C, th, tw]: the h tile with its 2-pixel halo
    (zeros outside); per rank, r on the tile plus its 1-pixel ring and its
    slice of a = r*h (0 outside the image); the a tile from every rank's
    slice; then each rank's z, o and h' channels.  hp, gp, inside: from
    ``_padded``."""
    th, tw, split = plan.tile_h, plan.tile_w, plan.split
    C = hp.shape[1]
    cn = C // split
    ht = hp[:, :, y0:y0 + th + 4, x0:x0 + tw + 4]
    ring = (slice(None), slice(None), slice(y0, y0 + th + 2),
            slice(x0, x0 + tw + 2))
    a_tile = []
    for rank in range(split):
        rows = slice(C + rank * cn, C + (rank + 1) * cn)
        r = torch.sigmoid(F.conv2d(ht, _oihw(w_ur[:, rows])) + gp[ring][:, rows])
        a_tile.append(r * ht[:, rank * cn:(rank + 1) * cn, 1:-1, 1:-1]
                      * inside[ring])
    a_tile = torch.cat(a_tile, 1)
    out = []
    for rank in range(split):
        ch = slice(rank * cn, (rank + 1) * cn)
        g = gp[:, :, y0 + 1:y0 + th + 1, x0 + 1:x0 + tw + 1]
        z = torch.sigmoid(F.conv2d(ht[:, :, 1:-1, 1:-1], _oihw(w_ur[:, ch]))
                          + g[:, ch])
        o = torch.tanh(F.conv2d(a_tile, _oihw(w_o[:, ch]))
                       + g[:, 2 * C + rank * cn:2 * C + (rank + 1) * cn])
        hv = ht[:, ch, 2:-2, 2:-2]
        out.append(hv * (1 - z) + o * z)
    return torch.cat(out, 1)


def k1_emulated(h, gx, w_ur, w_o, plan):
    """K1's decomposition (K10a's on gx_seq[sel]): ``tile_emulated`` on
    every output tile of NHWC h, gx; the inputs' dtype."""
    B, H, W, C = h.shape
    th, tw = plan.tile_h, plan.tile_w
    hp, gp, inside = _padded(h, gx, plan)
    out = torch.zeros(B, C, H + th, W + tw, dtype=h.dtype)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            out[:, :, y0:y0 + th, x0:x0 + tw] = tile_emulated(
                hp, gp, inside, w_ur, w_o, plan, y0, x0)
    return out[:, :, :H, :W].permute(0, 2, 3, 1)


def k11_walk(plan, H, W, clusters):
    """The tiles (y0, x0) of one step in the order K11's grid of
    ``clusters`` clusters walks them (csrc/gru_chunk.cu): cluster c takes
    tile c, then c + clusters, ...; the clusters in index order."""
    tiles_x = -(-W // plan.tile_w)
    tiles = tiles_x * -(-H // plan.tile_h)
    return [((t // tiles_x) * plan.tile_h, (t % tiles_x) * plan.tile_w)
            for c in range(clusters) for t in range(c, tiles, clusters)]


def k11_emulated(w_ev, w_im, gx_steps, h0, K, plan, clusters):
    """K11's decomposition: S = gx_steps.shape[0] steps, step s from the
    previous step's snapshot (h0 at s = 0) with the image weights where
    s % (K+1) == K, else the events weights, each tile as ``k11_walk``
    visits it (each exactly once per step).  w_ev, w_im: (w_ur, w_o);
    gx_steps [S, H, W, 3C]; h0 [1, H, W, C] -> snaps [S, H, W, C]."""
    _, H, W, C = h0.shape
    th, tw = plan.tile_h, plan.tile_w
    walk = k11_walk(plan, H, W, clusters)
    assert sorted(walk) == [(y, x) for y in range(0, H, th)
                            for x in range(0, W, tw)]
    snaps, h = [], h0
    for s in range(gx_steps.shape[0]):
        w_ur, w_o = w_im if s % (K + 1) == K else w_ev
        hp, gp, inside = _padded(h, gx_steps[s:s + 1], plan)
        out = torch.zeros(1, C, H + th, W + tw, dtype=h0.dtype)
        for y0, x0 in walk:
            out[:, :, y0:y0 + th, x0:x0 + tw] = tile_emulated(
                hp, gp, inside, w_ur, w_o, plan, y0, x0)
        h = out[:, :, :H, :W].permute(0, 2, 3, 1)
        snaps.append(h)
    return torch.cat(snaps)


def pair_blocks(plans, B, hw0, hw1, first):
    """K9's grid (``gru_pair.pair_grid``) and its blocks in the order they
    are dispatched (x, then y, then z), each as
    csrc/gru_hside_tile.cuh's PairTile maps it: (scale, batch item, tile
    origin (y0, x0), cluster rank), or None for a padding block."""
    grid = gru_pair.pair_grid(plans, B, hw0, hw1, first)
    gx, gy, gz = grid.grid
    blocks = []
    for z in range(gz):
        for y in range(gy):
            s = 0 if grid.row0[0] <= y < grid.row0[0] + grid.rows[0] else 1
            p = plans[s]
            for x in range(gx):
                blocks.append((s, z, ((y - grid.row0[s]) * p.tile_h,
                                      (x // p.split) * p.tile_w), x % p.split)
                              if x < grid.cols[s] else None)
    return grid, blocks


def _gx_planes(h, gx, step):
    """Each batch item's gx plane [H, W, 3C] as the kernel addresses it:
    item b at b * gx_bstride elements (K9, ``gru_hside._gx_bstride``), or
    every item at the clamped step of gx_seq (K10b, step not None)."""
    B, H, W, C = h.shape
    if step is not None:
        return [gx[min(max(step, 0), gx.shape[0] - 1)]] * B
    bstride = gru_hside._gx_bstride(h, gx)
    return [torch.as_strided(gx, (H, W, 3 * C), (W * 3 * C, 3 * C, 1),
                             gx.storage_offset() + b * bstride)
            for b in range(B)]


def k9_emulated(scales, plans, first, step=None):
    """K9's decomposition (K10b's with step: both scales' gx read at the
    step of their gx_seq, clamped): every block of the pair grid
    (``pair_blocks``) computes its rank's channel slice of its tile
    (``tile_emulated``) under its scale's plan; padding blocks nothing.
    scales: per scale (h [B, H, W, C], gx, w_ur, w_o), gx [B, H, W, 3C]
    (any batch stride) or gx_seq [S, H, W, 3C]; the outputs NHWC."""
    B = scales[0][0].shape[0]
    grid, blocks = pair_blocks(plans, B, scales[0][0].shape[1:3],
                               scales[1][0].shape[1:3], first)
    padded, outs = {}, []
    for (h, gx, _, _), p in zip(scales, plans):
        _, H, W, C = h.shape
        outs.append(torch.zeros(B, C, H + p.tile_h, W + p.tile_w, dtype=h.dtype))
    for block in blocks:
        if block is None:
            continue
        s, b, (y0, x0), rank = block
        h, gx, w_ur, w_o = scales[s]
        p = plans[s]
        if (s, b) not in padded:
            padded[(s, b)] = _padded(h[b:b + 1], _gx_planes(h, gx, step)[b][None], p)
        cn = h.shape[-1] // p.split
        tile = tile_emulated(*padded[(s, b)], w_ur, w_o, p, y0, x0)
        outs[s][b, rank * cn:(rank + 1) * cn, y0:y0 + p.tile_h,
                x0:x0 + p.tile_w] = tile[0, rank * cn:(rank + 1) * cn]
    return tuple(o[:, :, :h.shape[1], :h.shape[2]].permute(0, 2, 3, 1)
                 for o, (h, _, _, _) in zip(outs, scales))
