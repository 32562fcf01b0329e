// The tile of kernel K5 (gru_full.cu): one block computes the whole
// ConvGRU cell on a TH x TW output tile, for all output channels or, in a
// thread-block cluster of 2 blocks, for its C/2 of them.
//
//     z = sigmoid(conv3x3([x|h], Wz) + bz)    r = sigmoid(conv3x3([x|h], Wr) + br)
//     a = bf16(r * h)                          o = tanh(conv3x3([x|a], Wo) + bo)
//     h' = h * (1 - z) + o * z
//
// What bounds it on this card.  Per pixel the cell must move x, h and h'
// (6*C bytes) and do 54*C^2 multiply-adds (36*C^2 for [z|r] with a
// contraction of 2C, 18*C^2 for o): 18*C flop per byte, far above the H100's
// bf16 ridge (~295 flop/B) at C = 64, 128, 256, so its bound is the tensor
// cores'.  What held the first design at 3-7% of it was the weight feed:
// each warp item of 32 pixels x 16 channels read its 9*2C*16 B fragments
// with 4-byte loads from L1/L2, about 1.2 GB of weights per launch at
// 1x32x64x256, and its 4x4 tiles there filled half of each 32-row item.
//
// What the design does about it, after K1's tile (gru_hside_tile.cuh):
//   * the x and h tiles with their 2-pixel halo arrive by cp.async (zero
//     outside the image) at pixel pitch C + kPad, with the first weight
//     slab;
//   * the weights stream through a ring of two slabs in shared memory by
//     cp.async (the next slab loads while the warps consume this one), a
//     slab one tap x ks input channels x the block's output rows: Cn reset
//     rows of w_ur in phase r; Cn update rows of w_ur, then Cn rows of w_o,
//     in phase z/o.  The K walk covers the 2C inputs, the x slabs (9 taps x
//     C/ks) first, then the h slabs, so each weight byte crosses L2 -> SM
//     once per block and pass; B fragments come from the ring by ldmatrix;
//   * phase r computes r on the tile plus its 1-pixel ring and writes a =
//     bf16(r*h) into the a tile (0 outside the image, where h is 0: the
//     zero padding of the out gate's conv).  Phase z/o computes z over
//     [x | h] and o over [x | a] into two accumulators; on the x slabs both
//     read the same A fragments, loaded once per k16 step;
//   * a warp owns one job per pass: 16*MR pixels x 8*NR channels of r,
//     16*MC pixels x 8*NC channels of both z and o, its accumulators held
//     across the whole K walk, the next k16 step's fragments loaded while
//     the current step's products issue.  Where the tile has more jobs than
//     warps, the block makes further passes over the weights;
//   * the biases are read into registers per job; h' is staged in shared
//     memory and written 16 bytes a lane; the gates run on the special
//     function unit (gate_sigmoid, gate_tanh; -DRAMNET_K5_EXACT_GATES builds
//     the IEEE forms, against which gru_hside_timing.py --full --gates
//     measures these); the staging and output loops are walked without
//     division (Walk), the slab coordinates carried as counters;
//   * with a split of 2 (C >= 128) the blocks of a cluster share a pixel
//     tile and take C/2 output channels each: after phase r each copies
//     its peer's a channels through distributed shared memory (K1's two
//     cluster barriers), so each streams half the weight rows.
// The wrapper plans the tile, the split, the warp jobs and the slab width
// per shape (ops/gru_hside.py::plan_k5) and passes the plan.
#pragma once

#include "lstm_hside_tile.cuh"   // K1's tile helpers and Walk

namespace {

// The launch's arguments.  x, h, out [B,H,W,C]; w_ur [9,2C,2C] (update
// rows, then reset rows; x columns, then h columns), w_o [9,C,2C] (x
// columns, then a columns), [tap][out][in]; b_ur [2C], b_o [C] float32.
struct K5Args {
  const bf16* x;
  const bf16* h;
  const bf16* w_ur;
  const bf16* w_o;
  const float* b_ur;
  const float* b_o;
  bf16* out;
  int H, W, C;
  int TH, TW;   // output tile
  int split;    // blocks per cluster, each C / split output channels
  int ks;       // input channels per weight slab: 16, 32 or 64
};

// Shared memory of one block in bytes, bf16: the x and h tiles with their
// 2-pixel halo and the a tile with its 1-pixel ring (pixel pitch C + kPad),
// the weight ring (kStages x 2*(C/split) rows at pitch ks + kPad) and h' at
// the output tile (pitch C/split + kPad).  ops/gru_hside.py::k5_smem_bytes
// computes the same.
inline size_t k5_smem_bytes(int TH, int TW, int C, int split, int ks) {
  const size_t cn = C / split;
  return ((size_t)(TH + 4) * (TW + 4) * 2 * (C + kPad) +
          (size_t)(TH + 2) * (TW + 2) * (C + kPad) + (size_t)kStages * 2 * cn * (ks + kPad) +
          (size_t)TH * TW * (cn + kPad)) *
         sizeof(bf16);
}

#ifdef RAMNET_K5_EXACT_GATES
__device__ __forceinline__ float k5_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float k5_tanh(float x) { return tanhf(x); }
#else
__device__ __forceinline__ float k5_sigmoid(float x) { return gate_sigmoid(x); }

__device__ __forceinline__ float k5_tanh(float x) { return gate_tanh(x); }
#endif

// Where a slab lies in the K walk: the input half (0: x, 1: h or a), the
// tap and the ks-wide chunk of the half's C inputs; next() steps to the
// following slab, after the last of a pass back to the first.
struct K5Slab {
  int half = 0, tap = 0, kq = 0;
  __device__ __forceinline__ void next(int kc) {
    if (++kq == kc) {
      kq = 0;
      if (++tap == 9) {
        tap = 0;
        half ^= 1;
      }
    }
  }
};

// Weight slab p of a phase into the ring buffer at dst: phase r (zo false)
// the block's Cn reset rows of w_ur; phase z/o its Cn update rows of w_ur,
// then its Cn rows of w_o; input columns half*C + kq*ks ..., row pitch ks +
// kPad.  A thread copies 16 bytes of every (kThreads*8/ks)-th row: ks/8 is a
// power of two, so its column is fixed.
__device__ __forceinline__ void load_k5_slab(const K5Args& a, bool zo, const K5Slab& p, int Cn,
                                             int c0, uint32_t dst) {
  const int C = a.C, C2 = 2 * C, ks = a.ks;
  const int lv = ks == 64 ? 3 : ks == 32 ? 2 : 1;   // log2 of the vectors per row
  const int v = threadIdx.x & ((1 << lv) - 1), rstep = kThreads >> lv;
  const int k0 = p.half * C + p.kq * ks + v * 8;
  const int rp = ks + kPad, rows = zo ? 2 * Cn : Cn;
  const bf16* w1 = a.w_ur + ((size_t)p.tap * C2 + (zo ? 0 : C) + c0) * C2 + k0;
  const bf16* w2 = a.w_o + ((size_t)p.tap * C + c0) * C2 + k0;   // phase z/o, rows >= Cn
  for (int r = threadIdx.x >> lv; r < rows; r += rstep)
    cp_async16_zfill(dst + 2 * (r * rp + v * 8),
                     r < Cn ? w1 + (size_t)r * C2 : w2 + (size_t)(r - Cn) * C2, true);
}

// Per-channel biases of a job's NT n8 tiles (this lane's two channels of
// each), 0 past the block's Cn channels.
template <int NT>
__device__ __forceinline__ void load_bias(float2 (&bv)[NT], const float* __restrict__ b, int n0,
                                          int Cn, int t) {
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
    bv[ni] = n0 + ni * 8 < Cn ? __ldg(reinterpret_cast<const float2*>(b + n0 + ni * 8 + 2 * t))
                              : make_float2(0.0f, 0.0f);
}

// One block of the cell.  Grid: x = tile column * split + cluster rank, y =
// tile row, z = batch item.  MR x NR: a warp's r job in m16 x n8 tiles;
// MC x NC its z/o job (z and o each).  NR and NC even (ldmatrix.x4 loads
// two n8 tiles of B).
template <int MR, int NR, int MC, int NC>
__global__ void __launch_bounds__(kThreads, 1) k5_kernel(const K5Args a) {
  static_assert(NR % 2 == 0 && NC % 2 == 0, "B fragments come in n8 pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, H = a.H, W = a.W, TH = a.TH, TW = a.TW;
  const int split = a.split;
  const int rank = blockIdx.x % split;   // the block's rank in its cluster
  const int Cn = C / split, c0 = rank * Cn;
  const int y0 = blockIdx.y * TH, x0 = (blockIdx.x / split) * TW;
  const size_t img = (size_t)blockIdx.z * H * W;   // the batch item's first pixel

  const int ps = C + kPad;              // pixel pitch of the x, h and a tiles
  const int hw = TW + 4, hh = TH + 4;   // x and h tiles with a 2-pixel halo
  const int aw = TW + 2, ah = TH + 2;   // a tile with a 1-pixel ring
  const int rp = a.ks + kPad;           // row pitch of a weight slab
  const int po = Cn + kPad;             // pixel pitch of the staged h'
  const int n_a = ah * aw, n_c = TH * TW;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + hh * hw * ps;
  bf16* as = hs + hh * hw * ps;
  bf16* ring = as + n_a * ps;
  bf16* os = ring + kStages * 2 * Cn * rp;
  const uint32_t xs_u = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t as_u = (uint32_t)__cvta_generic_to_shared(as);
  const uint32_t ring_u = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t tile_b = 2u * hh * hw * ps;   // bytes from the x tile to the h tile
  const uint32_t slab_b = 2u * 2 * Cn * rp;    // bytes of one ring buffer
  const int vc = C / 8;                        // 16-byte vectors of a pixel

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = C / a.ks;    // slabs per tap and half
  const int S = 2 * 9 * kc;   // slabs per pass over the weights
  // this lane's ldmatrix row of a B fragment pair: output row
  // (lane >> 4) * 8 + (lane & 7) of the pair, input column ((lane >> 3) & 1) * 8
  const uint32_t b_lane = 2u * ((((lane >> 4) & 1) * 8 + (lane & 7)) * rp + ((lane >> 3) & 1) * 8);

  // 1. The x and h tiles: image rows y0-2 .. y0+TH+1 (and columns alike), 0
  //    outside.  They join the first weight slab's cp.async group.
  {
    const int dims[4] = {2, hh, hw, vc};
    for (Walk<4> w(dims); w.valid(); w.next()) {
      const int src_h = w.i[0], py = w.i[1], px = w.i[2], v = w.i[3];
      const int gy = y0 - 2 + py, gx_ = x0 - 2 + px;
      const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
      const bf16* base = src_h ? a.h : a.x;
      const bf16* src = inside ? base + (img + (size_t)gy * W + gx_) * C + v * 8 : base;
      cp_async16_zfill(xs_u + src_h * tile_b + 2 * ((py * hw + px) * ps + v * 8), src, inside);
    }
  }

  // 2. Phase r on the a tile's pixels: a-tile pixel (ry, rx) is image
  //    (y0-1+ry, x0-1+rx); its taps start at x/h-tile pixel (ry, rx).
  {
    const int mj = (n_a + 16 * MR - 1) / (16 * MR), nj = (Cn + 8 * NR - 1) / (8 * NR);
    const int jobs = mj * nj;
    const int total = ((jobs + kWarps - 1) / kWarps) * S;
    K5Slab cur, nxt;
    load_k5_slab(a, false, nxt, Cn, c0, ring_u);
    cp_async_commit_group();
    float acc[MR][NR][4];
    float2 br[NR];
    uint32_t a_addr[MR];
    int m0 = 0, n0 = 0;
    bool busy = false;
    for (int s = 0, ss = 0, pass = 0; s < total; ++s) {
      if (ss == 0) {   // a new pass: this warp's job
        const int job = pass * kWarps + warp;
        busy = job < jobs;
        m0 = (job / nj) * 16 * MR;
        n0 = (job % nj) * 8 * NR;
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          const int q = min(m0 + mi * 16 + (lane & 15), n_a - 1);
          const int ry = q / aw, rx = q - ry * aw;
          a_addr[mi] = xs_u + 2 * ((ry * hw + rx) * ps + (lane >> 4) * 8);
        }
        load_bias<NR>(br, a.b_ur + C + c0, n0, Cn, t);
#pragma unroll
        for (int mi = 0; mi < MR; ++mi)
#pragma unroll
          for (int ni = 0; ni < NR; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
      nxt.next(kc);
      if (s + 1 < total) load_k5_slab(a, false, nxt, Cn, c0, ring_u + ((s + 1) & 1) * slab_b);
      cp_async_commit_group();
      if (busy) {
        const int ky = cur.tap / 3, kx = cur.tap - ky * 3;
        const uint32_t off = cur.half * tile_b + 2 * ((ky * hw + kx) * ps + cur.kq * a.ks);
        const uint32_t bb = ring_u + (s & 1) * slab_b + b_lane + 2 * n0 * rp;
        // k16 steps in pairs, each step's fragments loaded while the
        // previous step's products issue
        uint32_t a0[MR][4], a1[MR][4], b0[NR / 2][4], b1[NR / 2][4];
        load_a<MR>(a0, a_addr, off);
        load_b<NR>(b0, bb, rp, n0, Cn);
        for (int kk = 0; kk < a.ks; kk += 32) {
          const bool odd = kk + 16 < a.ks;
          if (odd) {
            load_a<MR>(a1, a_addr, off + 2 * (kk + 16));
            load_b<NR>(b1, bb + 2 * (kk + 16), rp, n0, Cn);
          }
          mma_job<MR, NR>(acc, a0, b0, n0, Cn);
          if (kk + 32 < a.ks) {
            load_a<MR>(a0, a_addr, off + 2 * (kk + 32));
            load_b<NR>(b0, bb + 2 * (kk + 32), rp, n0, Cn);
          }
          if (odd) mma_job<MR, NR>(acc, a1, b1, n0, Cn);
        }
      }
      if (ss == S - 1 && busy) {   // the pass's epilogue: r, then a = bf16(r*h)
        // per m16 tile: every load, then the gates, then every store
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          uint32_t hv[2][NR];
          int qs[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = min(m0 + mi * 16 + g + 8 * half, n_a - 1);
            const int ry = q / aw, rx = q - ry * aw;
            qs[half] = m0 + mi * 16 + g + 8 * half < n_a ? q : -1;
            // h at the pixel: 0 outside the image, so a is too
            const bf16* hp = hs + ((ry + 1) * hw + rx + 1) * ps + c0 + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NR; ++ni)
              hv[half][ni] = n0 + ni * 8 < Cn ? ld_u32(hp + ni * 8) : 0u;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int ni = 0; ni < NR; ++ni) {
              const float2 h2 = unpack_bf2(hv[half][ni]);
              const float r0 = k5_sigmoid(acc[mi][ni][2 * half] + br[ni].x);
              const float r1 = k5_sigmoid(acc[mi][ni][2 * half + 1] + br[ni].y);
              hv[half][ni] = pack_bf2(r0 * h2.x, r1 * h2.y);
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (qs[half] < 0) continue;
            bf16* ap = as + qs[half] * ps + c0 + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NR; ++ni)
              if (n0 + ni * 8 < Cn) st_u32(ap + ni * 8, hv[half][ni]);
          }
        }
      }
      cur.next(kc);
      if (++ss == S) {
        ss = 0;
        ++pass;
      }
    }
  }
  __syncthreads();   // the ring is free and the block's a slice written

  // 3. Phase z/o on the output tile: output pixel (cy, cx) is image
  //    (y0+cy, x0+cx); its taps start at x/h-tile pixel (cy+1, cx+1) and
  //    a-tile pixel (cy, cx).
  const int mj = (n_c + 16 * MC - 1) / (16 * MC), nj = (Cn + 8 * NC - 1) / (8 * NC);
  const int jobs = mj * nj;
  const int total = ((jobs + kWarps - 1) / kWarps) * S;
  K5Slab cur, nxt;
  load_k5_slab(a, true, nxt, Cn, c0, ring_u);
  cp_async_commit_group();
  if (split > 1) {
    // every block's a slice is written: copy the peer's channels of the a
    // tile into this block's own, 16 bytes at a time
    cluster_arrive();
    cluster_wait();
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int peer = rank ^ 1;
    const int dims[2] = {n_a, Cn / 8};
    for (Walk<2> w(dims); w.valid(); w.next()) {
      bf16* p = as + w.i[0] * ps + peer * Cn + w.i[1] * 8;
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(p, peer));
    }
    cluster_arrive();   // done reading the peer; waited on before exit
    __syncthreads();
  }
  {
    float accz[MC][NC][4], acco[MC][NC][4];
    float2 bz[NC], bo[NC];
    uint32_t x_addr[MC], a_addr[MC];
    int m0 = 0, n0 = 0;
    bool busy = false;
    for (int s = 0, ss = 0, pass = 0; s < total; ++s) {
      if (ss == 0) {
        const int job = pass * kWarps + warp;
        busy = job < jobs;
        m0 = (job / nj) * 16 * MC;
        n0 = (job % nj) * 8 * NC;
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
          const int cy = q / TW, cx = q - cy * TW;
          x_addr[mi] = xs_u + 2 * (((cy + 1) * hw + cx + 1) * ps + (lane >> 4) * 8);
          a_addr[mi] = as_u + 2 * ((cy * aw + cx) * ps + (lane >> 4) * 8);
        }
        load_bias<NC>(bz, a.b_ur + c0, n0, Cn, t);
        load_bias<NC>(bo, a.b_o + c0, n0, Cn, t);
#pragma unroll
        for (int mi = 0; mi < MC; ++mi)
#pragma unroll
          for (int ni = 0; ni < NC; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) accz[mi][ni][e] = acco[mi][ni][e] = 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
      nxt.next(kc);
      if (s + 1 < total) load_k5_slab(a, true, nxt, Cn, c0, ring_u + ((s + 1) & 1) * slab_b);
      cp_async_commit_group();
      if (busy) {
        const int ky = cur.tap / 3, kx = cur.tap - ky * 3;
        const uint32_t offx = 2 * ((ky * hw + kx) * ps + cur.kq * a.ks);
        const uint32_t bzb = ring_u + (s & 1) * slab_b + b_lane + 2 * n0 * rp;
        const uint32_t bob = bzb + 2 * Cn * rp;
        uint32_t fz[NC / 2][4], fo[NC / 2][4];
        if (cur.half == 0) {
          // x slabs: z and o read the same A fragments, in pairs of k16
          // steps, each loaded while the previous step's products issue
          uint32_t f0[MC][4], f1[MC][4];
          load_a<MC>(f0, x_addr, offx);
          load_b<NC>(fz, bzb, rp, n0, Cn);
          load_b<NC>(fo, bob, rp, n0, Cn);
          for (int kk = 0; kk < a.ks; kk += 32) {
            const bool odd = kk + 16 < a.ks;
            if (odd) load_a<MC>(f1, x_addr, offx + 2 * (kk + 16));
            mma_job<MC, NC>(accz, f0, fz, n0, Cn);
            if (odd) load_b<NC>(fz, bzb + 2 * (kk + 16), rp, n0, Cn);
            mma_job<MC, NC>(acco, f0, fo, n0, Cn);
            if (odd) load_b<NC>(fo, bob + 2 * (kk + 16), rp, n0, Cn);
            if (kk + 32 < a.ks) load_a<MC>(f0, x_addr, offx + 2 * (kk + 32));
            if (odd) {
              mma_job<MC, NC>(accz, f1, fz, n0, Cn);
              if (kk + 32 < a.ks) load_b<NC>(fz, bzb + 2 * (kk + 32), rp, n0, Cn);
              mma_job<MC, NC>(acco, f1, fo, n0, Cn);
              if (kk + 32 < a.ks) load_b<NC>(fo, bob + 2 * (kk + 32), rp, n0, Cn);
            }
          }
        } else {
          // h slabs: z over h, o over a; per k16 step the out gate's
          // fragments load while the update gate's products issue, and the
          // next step's update fragments while the out gate's issue
          const uint32_t offa = 2 * ((ky * aw + kx) * ps + cur.kq * a.ks);
          uint32_t fh[MC][4], fa[MC][4];
          load_a<MC>(fh, x_addr, tile_b + offx);
          load_b<NC>(fz, bzb, rp, n0, Cn);
          for (int kk = 0; kk < a.ks; kk += 16) {
            load_a<MC>(fa, a_addr, offa + 2 * kk);
            load_b<NC>(fo, bob + 2 * kk, rp, n0, Cn);
            mma_job<MC, NC>(accz, fh, fz, n0, Cn);
            if (kk + 16 < a.ks) {
              load_a<MC>(fh, x_addr, tile_b + offx + 2 * (kk + 16));
              load_b<NC>(fz, bzb + 2 * (kk + 16), rp, n0, Cn);
            }
            mma_job<MC, NC>(acco, fa, fo, n0, Cn);
          }
        }
      }
      if (ss == S - 1 && busy) {   // the pass's epilogue: z, o, h' staged
        // per m16 tile: every load, then the gates, then every store
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          uint32_t hv[2][NC];
          int qs[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = min(m0 + mi * 16 + g + 8 * half, n_c - 1);
            const int cy = q / TW, cx = q - cy * TW;
            qs[half] = m0 + mi * 16 + g + 8 * half < n_c ? q : -1;
            const bf16* hp = hs + ((cy + 2) * hw + cx + 2) * ps + c0 + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NC; ++ni)
              hv[half][ni] = n0 + ni * 8 < Cn ? ld_u32(hp + ni * 8) : 0u;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int ni = 0; ni < NC; ++ni) {
              const float2 h2 = unpack_bf2(hv[half][ni]);
              const float z0 = k5_sigmoid(accz[mi][ni][2 * half] + bz[ni].x);
              const float z1 = k5_sigmoid(accz[mi][ni][2 * half + 1] + bz[ni].y);
              const float o0 = k5_tanh(acco[mi][ni][2 * half] + bo[ni].x);
              const float o1 = k5_tanh(acco[mi][ni][2 * half + 1] + bo[ni].y);
              hv[half][ni] = pack_bf2(h2.x * (1.0f - z0) + o0 * z0, h2.y * (1.0f - z1) + o1 * z1);
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (qs[half] < 0) continue;
            bf16* op = os + qs[half] * po + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NC; ++ni)
              if (n0 + ni * 8 < Cn) st_u32(op + ni * 8, hv[half][ni]);
          }
        }
      }
      cur.next(kc);
      if (++ss == S) {
        ss = 0;
        ++pass;
      }
    }
  }
  __syncthreads();
  // h' of the block's channels from the staged tile, 16 bytes a lane
  {
    const int dims[3] = {TH, TW, Cn / 8};
    for (Walk<3> w(dims); w.valid(); w.next()) {
      const int cy = w.i[0], cx = w.i[1], v = w.i[2];
      const int gy = y0 + cy, gx_ = x0 + cx;
      if (gy >= H || gx_ >= W) continue;
      *reinterpret_cast<uint4*>(a.out + (img + (size_t)gy * W + gx_) * C + c0 + v * 8) =
          *reinterpret_cast<const uint4*>(os + (cy * TW + cx) * po + v * 8);
    }
  }
  if (split > 1) cluster_wait();   // no peer reads this block's a tile now
}

}  // namespace
