// The tile of kernels K1, K1-res and K10a (gru_hside.cu), K11
// (gru_chunk.cu) and K9 and K10b (gru_cells.cu): one block computes the
// ConvGRU h-side cell on a TH x TW output tile, for all output channels
// or, in a thread-block cluster of N blocks, for its C/N of them.  k1_tile
// is that block's body, given its tile's origin, its cluster rank and the
// h, gx, output and weight pointers; K1, K1-res, K10a, K9 and K10b run it
// once per block (k1_kernel, k10a_kernel, k9_kernel), K11 once per tile
// and step of a persistent grid.
//
//     z = sigmoid(conv3x3(h, Wz) + gx_z)      r = sigmoid(conv3x3(h, Wr) + gx_r)
//     a = bf16(r * h)                          o = tanh(conv3x3(a, Wo) + gx_o)
//     h' = h * (1 - z) + o * z
//
// Each 3x3 conv is an implicit GEMM on mma.sync m16n8k16 (bf16 in, f32
// accumulate): M = the tile's pixels, N = the block's output channels,
// K = 9 taps x C input channels.  The block walks K in slabs (one tap x KS
// input channels) that every warp consumes together:
//
//   * the h tile with its 2-pixel halo arrives by cp.async (zero outside
//     the image), at pixel pitch C + kPad, as A operands read by ldmatrix;
//   * the weights stream through a ring of two slabs in shared memory by
//     cp.async (the next slab loads while the warps consume this one), each
//     slab one tap x KS input channels x the block's
//     output rows (Cn reset rows in the r phase; Cn update rows then Cn
//     out rows in the z/o phase), read by ldmatrix as B operands, so each
//     weight byte crosses L2 -> SM once per block and pass;
//   * a warp owns one job per pass: 16*MR pixels x 8*NR channels of r,
//     16*MC pixels x 8*NC channels of both z and o, its accumulators held
//     across the whole K walk, the next k16 step's fragments loaded while
//     the current step's products issue.  Where the tile has more jobs
//     than warps, the block makes further passes over the weights;
//   * each phase's gx arrives by cp.async with its first slab, so the
//     epilogue reads it from shared memory, and the outputs are staged
//     there too and written 16 bytes a lane.  The epilogue is
//     instruction-bound (the gates of every pixel and channel at two warps
//     per sub-partition): per m16 tile it loads, then computes the gates
//     on the special-function unit, then stores.
//
// Phase r computes r and a = bf16(r*h) on the tile plus a 1-pixel ring
// (a is 0 outside the image: the zero padding of conv(r*h)) into the a
// tile, K1-res also stores r at the tile.  With N > 1 the blocks of a
// cluster then exchange their a slices through distributed shared memory:
// after a cluster barrier each block copies its peers' channels into its
// own a tile (ldmatrix reads only the block's own shared memory), arrives
// at a second barrier and waits on it at the body's end, so no peer reads
// an a tile whose block is gone or has moved on to its next tile.  Phase
// z/o then computes z, o and h' (K1-res also z and o) for the block's
// channels.
//
// The body reads h, gx and the weights only by cp.async.cg, which caches
// in L2 and not in L1: K11 reads h that other SMs wrote in the previous
// step of the same launch, ordered by its grid barrier.  The body ends
// without a block barrier: a block that runs it again calls
// __syncthreads() first, since its last stores read the gx tile that the
// next body's cp.async overwrites.
#pragma once

#include <cooperative_groups.h>

#include "mma_conv.cuh"

namespace {

// The launch's arguments.  h, out [B,H,W,C]; gx [H,W,3C] per batch item,
// items gx_bstride elements apart (K10a: steps); w_ur [9,2C,C] (update
// rows, then reset rows), w_o [9,C,C], [tap][out][in]; acts [B,H,W,3C]
// (K1-res).  K11 passes h0, its snapshots as out and the events weights;
// K9 and K10b one K1Args per scale.
struct K1Args {
  const bf16* h;
  const bf16* gx;
  const bf16* w_ur;
  const bf16* w_o;
  bf16* out;
  bf16* acts;
  int H, W, C;
  long long gx_bstride;
  int TH, TW;    // output tile
  int split;     // blocks per cluster, each C / split output channels
  int ks;        // input channels per weight slab: 16, 32 or 64
};

constexpr int kStages = 2;   // weight slabs in the ring
constexpr size_t kSmemMax = 232448;   // bytes a block may use on Hopper

// The launch configuration of a grid of blocks in clusters of `split`
// (K1, K1-res, K10a, K9, K10b and K5), and cooperative (K11).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  ClusterLaunch(dim3 grid, size_t smem, int split, cudaStream_t stream,
                bool cooperative = false) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = split > 1 ? attr : attr + 1;
    cfg.numAttrs = (split > 1 ? 1 : 0) + (cooperative ? 1 : 0);
  }
};

// How many clusters of `split` blocks of `kern` with `smem` bytes of
// dynamic shared memory fit on the device at once
// (cudaOccupancyMaxActiveClusters; a cluster of 1 is one block), or -1
// where the query fails.
template <typename Kernel>
int max_active_clusters(Kernel kern, size_t smem, int split) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  ClusterLaunch c(dim3(split * 1024), smem, split, nullptr);
  c.cfg.attrs = c.attr;   // the query takes the cluster's size from the attribute
  c.cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &c.cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// Shared memory of one block in bytes, bf16: the h tile with its 2-pixel
// halo and the a tile with its 1-pixel ring (both at pixel pitch C + kPad),
// the weight ring (kStages x 2*(C/split) rows at pitch ks + kPad) and the gx
// tile: gx_r of the a tile's pixels at pitch Cn + kPad in phase r, [gx_z |
// gx_o] of the output tile at pitch 2*Cn + kPad in phase z/o (K1-res:
// [z | o | h'] at 3*Cn + kPad), where the outputs are staged.
// ops/gru_hside.py::k1_smem_bytes computes the same.
inline size_t k1_smem_bytes(int TH, int TW, int C, int split, int ks, bool res) {
  const size_t cn = C / split;
  const size_t gx_r = (size_t)(TH + 2) * (TW + 2) * (cn + kPad);
  const size_t gx_c = (size_t)TH * TW * ((res ? 3 : 2) * cn + kPad);
  return ((size_t)(TH + 4) * (TW + 4) * (C + kPad) +
          (size_t)(TH + 2) * (TW + 2) * (C + kPad) +
          (size_t)kStages * 2 * cn * (ks + kPad) + (gx_r > gx_c ? gx_r : gx_c)) *
         sizeof(bf16);
}

// Whether the tile runs a K1 plan (tile_h x tile_w output tile, split
// blocks per cluster, ks input channels per weight slab) at width C: C %
// 16, split 1 or 2 dividing C/16, ks 16, 32 or 64 dividing C.
inline bool k1_plan_ok(int C, int tile_h, int tile_w, int split, int ks) {
  return C % 16 == 0 && (split == 1 || split == 2) && (C / 16) % split == 0 &&
         (ks == 16 || ks == 32 || ks == 64) && C % ks == 0 && tile_h >= 1 && tile_w >= 1;
}

// The arguments of a K1 plan on one scale, or false where the tile cannot
// run it (k1_plan_ok).  gx_bstride: elements between the gx planes of
// consecutive batch items (K10a, K11, K10b: steps).
inline bool make_k1_args(K1Args& a, const void* h, const void* gx, const void* w_ur,
                         const void* w_o, void* out, void* acts, int H, int W, int C,
                         long long gx_bstride, int tile_h, int tile_w, int split, int ks) {
  if (!k1_plan_ok(C, tile_h, tile_w, split, ks)) return false;
  a.h = static_cast<const bf16*>(h);
  a.gx = static_cast<const bf16*>(gx);
  a.w_ur = static_cast<const bf16*>(w_ur);
  a.w_o = static_cast<const bf16*>(w_o);
  a.out = static_cast<bf16*>(out);
  a.acts = static_cast<bf16*>(acts);
  a.H = H;
  a.W = W;
  a.C = C;
  a.gx_bstride = gx_bstride;
  a.TH = tile_h;
  a.TW = tile_w;
  a.split = split;
  a.ks = ks;
  return true;
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's cp.async groups have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Two bf16 in one 32-bit word: loads, stores and conversions.
__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st_u32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The gates.  On the special-function unit: sigmoid(x) = 1 / (1 + 2^(-x
// log2 e)) by ex2.approx and rcp.approx (relative error ~2^-22), tanh(x) =
// 1 - 2 sigmoid(-2x) (absolute error ~2^-22): f32 rounding level, where
// tanh.approx's 2^-11 is a quarter of bf16's rounding error (2^-9).
// Defined RAMNET_K1_EXACT_GATES, the IEEE forms (expf, a correctly rounded
// division, tanhf), against which gru_hside_timing.py --gates measures
// these.
#ifdef RAMNET_K1_EXACT_GATES
__device__ __forceinline__ float gate_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float gate_tanh(float x) { return tanhf(x); }
#else
__device__ __forceinline__ float gate_sigmoid(float x) {
  float e, y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(1.0f + e));
  return y;
}

__device__ __forceinline__ float gate_tanh(float x) {
  float e, y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * 2.8853900817779268f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(1.0f + e));
  return fmaf(-2.0f, y, 1.0f);
}
#endif

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A fragments of MT m16 tiles: ldmatrix at each row address plus off bytes.
template <int MT>
__device__ __forceinline__ void load_a(uint32_t (&af)[MT][4], const uint32_t (&addr)[MT],
                                       uint32_t off) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(addr[mi] + off, af[mi]);
}

// B fragments of NT n8 tiles from a weight slab, a pair of tiles per
// ldmatrix.x4; base: this lane's row address of the job's first pair.
// Pairs at or past the block's Cn channels are not loaded.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&bf)[NT / 2][4], uint32_t base, int rp,
                                       int n0, int Cn) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    if (n0 + np * 16 < Cn) ldmatrix_x4(base + 2 * np * 16 * rp, bf[np]);
}

// acc += a x b over one k16 step of an MT x NT job.
template <int MT, int NT>
__device__ __forceinline__ void mma_job(float (&acc)[MT][NT][4], const uint32_t (&af)[MT][4],
                                        const uint32_t (&bf)[NT / 2][4], int n0, int Cn) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (n0 + np * 16 >= Cn) continue;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      mma_bf16(acc[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
      mma_bf16(acc[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
    }
  }
}

// Weight slab s (tap s / kc, input channels (s % kc) * ks ...) of a phase
// into the ring buffer at dst: phase r (zo false) the block's Cn reset
// rows of w_ur; phase z/o its Cn update rows of w_ur, then its Cn rows of
// w_o.  Row pitch ks + kPad.  A thread copies 16 bytes of every
// (kThreads*8/ks)-th row: ks/8 is a power of two, so its column is fixed.
__device__ __forceinline__ void load_slab(const K1Args& a, bool zo, int s, int kc, int Cn,
                                          int c0, uint32_t dst) {
  const int C = a.C, ks = a.ks;
  const int lv = ks == 64 ? 3 : ks == 32 ? 2 : 1;   // log2 of the vectors per row
  const int v = threadIdx.x & ((1 << lv) - 1), rstep = kThreads >> lv;
  const int tap = s / kc, k0 = (s - tap * kc) * ks + v * 8;
  const int rp = ks + kPad, rows = zo ? 2 * Cn : Cn;
  const bf16* w1 = a.w_ur + ((size_t)tap * 2 * C + (zo ? 0 : C) + c0) * C + k0;
  const bf16* w2 = a.w_o + ((size_t)tap * C + c0) * C + k0;   // phase z/o, rows >= Cn
  for (int r = threadIdx.x >> lv; r < rows; r += rstep)
    cp_async16_zfill(dst + 2 * (r * rp + v * 8), r < Cn ? w1 + r * C : w2 + (r - Cn) * C,
                     true);
}

// The block's body: the cell on one output tile of one [H,W,C] plane, for
// the C/split output channels of the block's cluster rank.  a: the
// widths, the plan and the weights; `at` (GridTile, K10aTile, PairTile, or
// K11's ChunkTile) says where: the block's rank, the tile's origin (y0, x0) in
// the image, and the plane's h, gx [H,W,3C], h' and (kRes) acts [H,W,3C],
// each in the order below, as K1 computed them before it had a body of its
// own.
// MR x NR: a warp's r job in m16 x n8 tiles; MC x NC its z/o job (z and o
// each).  NR and NC even (ldmatrix.x4 loads two n8 tiles of B).
template <bool kRes, int MR, int NR, int MC, int NC, typename At>
__device__ __forceinline__ void k1_tile(const K1Args& a, const At& at) {
  static_assert(NR % 2 == 0 && NC % 2 == 0, "B fragments come in n8 pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, H = a.H, W = a.W, TH = a.TH, TW = a.TW;
  const int split = a.split;
  const int rank = at.rank(a);   // the block's rank in its cluster
  const int Cn = C / split, c0 = rank * Cn;
  const int y0 = at.y0(a), x0 = at.x0(a);
  const bf16* hb = at.h(a);
  const bf16* gb = at.gx(a);
  bf16* ob = at.out(a);
  bf16* actb = kRes ? at.acts(a) : nullptr;
  const int C3 = 3 * C;

  const int ps = C + kPad;              // pixel pitch of the h and a tiles
  const int hw = TW + 4, hh = TH + 4;   // h tile with a 2-pixel halo
  const int aw = TW + 2, ah = TH + 2;   // a tile with a 1-pixel ring
  const int rp = a.ks + kPad;           // row pitch of a weight slab
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = hs + hh * hw * ps;
  bf16* ring = as + ah * aw * ps;
  bf16* gxs = ring + kStages * 2 * Cn * rp;
  const int pr = Cn + kPad;                      // gx tile pitch, phase r
  const int pz = (kRes ? 3 : 2) * Cn + kPad;     // gx tile pitch, phase z/o
  const uint32_t hs_u = (uint32_t)__cvta_generic_to_shared(hs);
  const uint32_t as_u = (uint32_t)__cvta_generic_to_shared(as);
  const uint32_t ring_u = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t gxs_u = (uint32_t)__cvta_generic_to_shared(gxs);
  const int vc = Cn / 8;   // 16-byte vectors of one pixel's channel slice
  const uint32_t slab_b = 2u * 2 * Cn * rp;   // bytes of one ring buffer

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = C / a.ks;   // slabs per tap
  const int S = 9 * kc;      // slabs per pass over the weights
  // this lane's ldmatrix row of a B fragment pair: output row
  // (lane >> 4) * 8 + (lane & 7) of the pair, input column ((lane >> 3) & 1) * 8
  const uint32_t b_lane = 2u * ((((lane >> 4) & 1) * 8 + (lane & 7)) * rp + ((lane >> 3) & 1) * 8);

  // 1. The h tile: image rows y0-2 .. y0+TH+1 (and columns alike), 0
  //    outside, and gx_r.  They join the first weight slab's cp.async
  //    group.
  {
    const int n_vec = C / 8;
    for (int i = threadIdx.x; i < hh * hw * n_vec; i += kThreads) {
      const int pix = i / n_vec, v = i - pix * n_vec;
      const int py = pix / hw, px = pix - py * hw;
      const int gy = y0 - 2 + py, gx_ = x0 - 2 + px;
      const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
      const bf16* src = inside ? hb + ((size_t)gy * W + gx_) * C + v * 8 : hb;
      cp_async16_zfill(hs_u + 2 * (pix * ps + v * 8), src, inside);
    }
    // gx_r of the block's channels at the a tile's pixels, 0 outside
    for (int i = threadIdx.x; i < ah * aw * vc; i += kThreads) {
      const int pix = i / vc, v = i - pix * vc;
      const int ry = pix / aw, rx = pix - ry * aw;
      const int gy = y0 - 1 + ry, gx_ = x0 - 1 + rx;
      const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
      const bf16* src = inside ? gb + ((size_t)gy * W + gx_) * C3 + C + c0 + v * 8 : gb;
      cp_async16_zfill(gxs_u + 2 * (pix * pr + v * 8), src, inside);
    }
  }

  // 2. Phase r on the a tile's pixels: a-tile pixel (ry, rx) is image
  //    (y0-1+ry, x0-1+rx); its taps start at h-tile pixel (ry, rx).
  {
    const int n_a = ah * aw;
    const int mj = (n_a + 16 * MR - 1) / (16 * MR), nj = (Cn + 8 * NR - 1) / (8 * NR);
    const int jobs = mj * nj;
    const int total = ((jobs + kWarps - 1) / kWarps) * S;
    if (total > 0) load_slab(a, false, 0, kc, Cn, c0, ring_u);
    cp_async_commit_group();
    float acc[MR][NR][4];
    uint32_t a_addr[MR];
    int m0 = 0, n0 = 0;
    bool busy = false;
    for (int s = 0; s < total; ++s) {
      const int ss = s % S;
      if (ss == 0) {   // a new pass: this warp's job
        const int job = (s / S) * kWarps + warp;
        busy = job < jobs;
        m0 = (job / nj) * 16 * MR;
        n0 = (job % nj) * 8 * NR;
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          const int q = min(m0 + mi * 16 + (lane & 15), n_a - 1);
          const int ry = q / aw, rx = q - ry * aw;
          a_addr[mi] = hs_u + 2 * ((ry * hw + rx) * ps + (lane >> 4) * 8);
        }
#pragma unroll
        for (int mi = 0; mi < MR; ++mi)
#pragma unroll
          for (int ni = 0; ni < NR; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
      {
        if (s + 1 < total) load_slab(a, false, (s + 1) % S, kc, Cn, c0, ring_u + ((s + 1) & 1) * slab_b);
        cp_async_commit_group();
      }
      if (busy) {
        const int tap = ss / kc, k0 = (ss - tap * kc) * a.ks;
        const int ky = tap / 3, kx = tap - ky * 3;
        const uint32_t off = 2 * ((ky * hw + kx) * ps + k0);
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
      if (ss == S - 1 && busy) {   // the pass's epilogue: r, a, K1-res's r
        // per m16 tile: every load, then the gates, then every store, so
        // the 2*NR gate chains overlap
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          uint32_t gv[2][NR], hv[2][NR];
          int qs[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = min(m0 + mi * 16 + g + 8 * half, n_a - 1);
            const int ry = q / aw, rx = q - ry * aw;
            const int gy = y0 - 1 + ry, gx_ = x0 - 1 + rx;
            const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
            qs[half] = m0 + mi * 16 + g + 8 * half < n_a ? q : -1;
            const bf16* gp = gxs + q * pr + n0 + 2 * t;
            const bf16* hp = hs + ((ry + 1) * hw + rx + 1) * ps + c0 + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NR; ++ni) {
              const bool ok = n0 + ni * 8 < Cn;   // the same for the whole warp
              gv[half][ni] = ok ? ld_u32(gp + ni * 8) : 0u;
              hv[half][ni] = ok && inside ? ld_u32(hp + ni * 8) : 0u;
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int ni = 0; ni < NR; ++ni) {
              const float2 gr = unpack_bf2(gv[half][ni]), h2 = unpack_bf2(hv[half][ni]);
              const float r0 = gate_sigmoid(acc[mi][ni][2 * half] + gr.x);
              const float r1 = gate_sigmoid(acc[mi][ni][2 * half + 1] + gr.y);
              gv[half][ni] = pack_bf2(r0, r1);             // r (K1-res's acts)
              hv[half][ni] = pack_bf2(r0 * h2.x, r1 * h2.y);   // a, 0 outside
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (qs[half] < 0) continue;
            bf16* ap = as + qs[half] * ps + c0 + n0 + 2 * t;
            bf16* rp_ = gxs + qs[half] * pr + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NR; ++ni) {
              if (n0 + ni * 8 >= Cn) continue;
              st_u32(ap + ni * 8, hv[half][ni]);
              if (kRes) st_u32(rp_ + ni * 8, gv[half][ni]);
            }
          }
        }
      }
    }
  }
  __syncthreads();   // the ring is free and the block's a slice written
  const int n_c = TH * TW;
  if (kRes) {   // K1-res: r at the output tile, 16 bytes a lane
    for (int i = threadIdx.x; i < n_c * vc; i += kThreads) {
      const int pix = i / vc, v = i - pix * vc;
      const int cy = pix / TW, cx = pix - cy * TW;
      const int gy = y0 + cy, gx_ = x0 + cx;
      if (gy < H && gx_ < W)
        *reinterpret_cast<uint4*>(actb + ((size_t)gy * W + gx_) * C3 + C + c0 + v * 8) =
            *reinterpret_cast<const uint4*>(gxs + ((cy + 1) * aw + cx + 1) * pr + v * 8);
    }
    __syncthreads();
  }

  // 3. Phase z/o on the output tile: output pixel (cy, cx) is image
  //    (y0+cy, x0+cx); its taps start at h-tile pixel (cy+1, cx+1) and
  //    a-tile pixel (cy, cx).  Its gx_z and gx_o join the first slab's
  //    group.
  for (int i = threadIdx.x; i < n_c * 2 * vc; i += kThreads) {
    const int pix = i / (2 * vc), rest = i - pix * 2 * vc;
    const int part = rest / vc, v = rest - part * vc;   // part 0: z, 1: o
    const int cy = pix / TW, cx = pix - cy * TW;
    const int gy = y0 + cy, gx_ = x0 + cx;
    const bool inside = gy < H && gx_ < W;
    const bf16* src = inside ? gb + ((size_t)gy * W + gx_) * C3 + part * 2 * C + c0 + v * 8 : gb;
    cp_async16_zfill(gxs_u + 2 * (pix * pz + part * Cn + v * 8), src, inside);
  }
  const int mj = (n_c + 16 * MC - 1) / (16 * MC), nj = (Cn + 8 * NC - 1) / (8 * NC);
  const int jobs = mj * nj;
  const int total = ((jobs + kWarps - 1) / kWarps) * S;
  if (total > 0) load_slab(a, true, 0, kc, Cn, c0, ring_u);
  cp_async_commit_group();
  if (split > 1) {
    // every block's a slice is written: copy the peers' channels of the a
    // tile into this block's own, 16 bytes at a time
    cluster_arrive();
    cluster_wait();
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int vec = Cn / 8, peers = split - 1;
    for (int i = threadIdx.x; i < ah * aw * peers * vec; i += kThreads) {
      const int v = i % vec, rest = i / vec;
      const int peer = (rank + 1 + rest % peers) % split, pix = rest / peers;
      bf16* p = as + pix * ps + peer * Cn + v * 8;
      *reinterpret_cast<uint4*>(p) =
          *reinterpret_cast<const uint4*>(cluster.map_shared_rank(p, peer));
    }
    cluster_arrive();   // done reading the peers; waited on before exit
    __syncthreads();
  }
  {
    float accz[MC][NC][4], acco[MC][NC][4];
    uint32_t h_addr[MC], a_addr[MC];
    int m0 = 0, n0 = 0;
    bool busy = false;
    for (int s = 0; s < total; ++s) {
      const int ss = s % S;
      if (ss == 0) {
        const int job = (s / S) * kWarps + warp;
        busy = job < jobs;
        m0 = (job / nj) * 16 * MC;
        n0 = (job % nj) * 8 * NC;
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
          const int cy = q / TW, cx = q - cy * TW;
          h_addr[mi] = hs_u + 2 * (((cy + 1) * hw + cx + 1) * ps + (lane >> 4) * 8);
          a_addr[mi] = as_u + 2 * ((cy * aw + cx) * ps + (lane >> 4) * 8);
        }
#pragma unroll
        for (int mi = 0; mi < MC; ++mi)
#pragma unroll
          for (int ni = 0; ni < NC; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) accz[mi][ni][e] = acco[mi][ni][e] = 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
      {
        if (s + 1 < total) load_slab(a, true, (s + 1) % S, kc, Cn, c0, ring_u + ((s + 1) & 1) * slab_b);
        cp_async_commit_group();
      }
      if (busy) {
        const int tap = ss / kc, k0 = (ss - tap * kc) * a.ks;
        const int ky = tap / 3, kx = tap - ky * 3;
        const uint32_t offh = 2 * ((ky * hw + kx) * ps + k0);
        const uint32_t offa = 2 * ((ky * aw + kx) * ps + k0);
        const uint32_t bz = ring_u + (s & 1) * slab_b + b_lane + 2 * n0 * rp;
        const uint32_t bo = bz + 2 * Cn * rp;
        // per k16 step the out gate's fragments load while the update
        // gate's products issue, and the next step's update fragments
        // while the out gate's issue
        uint32_t fh[MC][4], fa[MC][4], fz[NC / 2][4], fo[NC / 2][4];
        load_a<MC>(fh, h_addr, offh);
        load_b<NC>(fz, bz, rp, n0, Cn);
        for (int kk = 0; kk < a.ks; kk += 16) {
          load_a<MC>(fa, a_addr, offa + 2 * kk);
          load_b<NC>(fo, bo + 2 * kk, rp, n0, Cn);
          mma_job<MC, NC>(accz, fh, fz, n0, Cn);
          if (kk + 16 < a.ks) {
            load_a<MC>(fh, h_addr, offh + 2 * (kk + 16));
            load_b<NC>(fz, bz + 2 * (kk + 16), rp, n0, Cn);
          }
          mma_job<MC, NC>(acco, fa, fo, n0, Cn);
        }
      }
      if (ss == S - 1 && busy) {   // the pass's epilogue: z, o, h' staged
        // per m16 tile: every load, then the gates, then every store
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          uint32_t zv[2][NC], ov[2][NC], hv[2][NC];
          int qs[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = min(m0 + mi * 16 + g + 8 * half, n_c - 1);
            const int cy = q / TW, cx = q - cy * TW;
            qs[half] = m0 + mi * 16 + g + 8 * half < n_c && y0 + cy < H && x0 + cx < W ? q : -1;
            const bf16* sp = gxs + q * pz + n0 + 2 * t;
            const bf16* hp = hs + ((cy + 2) * hw + cx + 2) * ps + c0 + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NC; ++ni) {
              const bool ok = n0 + ni * 8 < Cn;   // the same for the whole warp
              zv[half][ni] = ok ? ld_u32(sp + ni * 8) : 0u;
              ov[half][ni] = ok ? ld_u32(sp + Cn + ni * 8) : 0u;
              hv[half][ni] = ok ? ld_u32(hp + ni * 8) : 0u;
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int ni = 0; ni < NC; ++ni) {
              const float2 gz = unpack_bf2(zv[half][ni]), go = unpack_bf2(ov[half][ni]);
              const float2 h2 = unpack_bf2(hv[half][ni]);
              const float z0 = gate_sigmoid(accz[mi][ni][2 * half] + gz.x);
              const float z1 = gate_sigmoid(accz[mi][ni][2 * half + 1] + gz.y);
              const float o0 = gate_tanh(acco[mi][ni][2 * half] + go.x);
              const float o1 = gate_tanh(acco[mi][ni][2 * half + 1] + go.y);
              zv[half][ni] = pack_bf2(z0, z1);
              ov[half][ni] = pack_bf2(o0, o1);
              hv[half][ni] = pack_bf2(h2.x * (1.0f - z0) + o0 * z0, h2.y * (1.0f - z1) + o1 * z1);
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (qs[half] < 0) continue;
            bf16* sp = gxs + qs[half] * pz + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NC; ++ni) {
              if (n0 + ni * 8 >= Cn) continue;
              if (kRes) {
                st_u32(sp + ni * 8, zv[half][ni]);
                st_u32(sp + Cn + ni * 8, ov[half][ni]);
                st_u32(sp + 2 * Cn + ni * 8, hv[half][ni]);
              } else {
                st_u32(sp + ni * 8, hv[half][ni]);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();
  // h' (K1-res also z and o) from the gx tile, 16 bytes a lane
  {
    const int slots = kRes ? 3 : 1;
    for (int i = threadIdx.x; i < n_c * slots * vc; i += kThreads) {
      const int pix = i / (slots * vc), rest = i - pix * slots * vc;
      const int slot = rest / vc, v = rest - slot * vc;
      const int cy = pix / TW, cx = pix - cy * TW;
      const int gy = y0 + cy, gx_ = x0 + cx;
      if (gy >= H || gx_ >= W) continue;
      const size_t px = (size_t)gy * W + gx_;
      bf16* dst = kRes && slot < 2 ? actb + px * C3 + slot * 2 * C + c0 + v * 8
                                   : ob + px * C + c0 + v * 8;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(gxs + pix * pz + slot * Cn + v * 8);
    }
  }
  if (split > 1) cluster_wait();   // no peer reads this block's a tile now
}

// K1 and K1-res: one block per tile and cluster rank.  Grid: x = tile
// column * split + cluster rank, y = tile row, z = batch item.
struct GridTile {
  __device__ int rank(const K1Args& a) const { return blockIdx.x % a.split; }
  __device__ int y0(const K1Args& a) const { return blockIdx.y * a.TH; }
  __device__ int x0(const K1Args& a) const { return (blockIdx.x / a.split) * a.TW; }
  __device__ const bf16* h(const K1Args& a) const {
    const int b = blockIdx.z;
    const size_t plane = (size_t)a.H * a.W * a.C;
    return a.h + b * plane;
  }
  __device__ const bf16* gx(const K1Args& a) const {
    const int b = blockIdx.z;
    return a.gx + (size_t)b * a.gx_bstride;
  }
  __device__ bf16* out(const K1Args& a) const {
    const int b = blockIdx.z;
    const size_t plane = (size_t)a.H * a.W * a.C;
    return a.out + b * plane;
  }
  __device__ bf16* acts(const K1Args& a) const {
    const int b = blockIdx.z;
    const size_t plane = (size_t)a.H * a.W * a.C;
    return a.acts + 3 * b * plane;
  }
};

// K9 and K10b (gru_cells.cu): the cell on two scales in one grid, each
// scale under its own K1 plan (tile, split, slab) on one warp-job combo,
// so the two scales' K1Args differ and one body serves both.  Grid: x =
// tile column * split + cluster rank, y = tile row, z = batch item, as
// K1's, with the two scales' tile rows stacked along y: scale s on rows
// [row0[s], row0[s] + rows[s]), the scale whose blocks come first on the
// lower rows (blocks are dispatched in x, y, z order).  A launch has one
// cluster size, the larger of the two splits, along x, and x's extent is
// the larger scale's columns rounded up to a multiple of it, so a cluster
// never spans two rows and never holds blocks of two scales.  A scale
// planned at split 1 inside clusters of 2 gives each block of a cluster
// its own tile; its K1Args.split stays 1, so the body takes none of its
// cluster barriers or exchanges.  A padding block (x past its scale's
// cols = tile columns * split) returns before the body, so before any
// barrier; a split-2 scale's columns are even, so its clusters are whole.
// The scale is read at run time, s, from the launch's arguments (a
// __grid_constant__ parameter, so p.s[s] needs no copy); the rest comes
// from blockIdx as GridTile's does.  K10b reads both scales' gx at its
// step.
struct PairArgs {
  K1Args s[2];
  int row0[2], rows[2], cols[2];
};

template <bool kSel>
struct PairTile {
  const PairArgs& p;
  int s;
  long long step;   // K10b: the step of gx_seq, clamped; K9: 0
  __device__ int rank(const K1Args& a) const { return blockIdx.x % a.split; }
  __device__ int y0(const K1Args& a) const { return (blockIdx.y - p.row0[s]) * a.TH; }
  __device__ int x0(const K1Args& a) const { return (blockIdx.x / a.split) * a.TW; }
  __device__ const bf16* h(const K1Args& a) const {
    return a.h + blockIdx.z * ((size_t)a.H * a.W * a.C);
  }
  __device__ const bf16* gx(const K1Args& a) const {
    return a.gx + (kSel ? step : (long long)blockIdx.z) * a.gx_bstride;
  }
  __device__ bf16* out(const K1Args& a) const {
    return a.out + blockIdx.z * ((size_t)a.H * a.W * a.C);
  }
  __device__ bf16* acts(const K1Args&) const { return nullptr; }
};

template <bool kRes, int MR, int NR, int MC, int NC>
__global__ void __launch_bounds__(kThreads, 1) k1_kernel(const K1Args a) {
  k1_tile<kRes, MR, NR, MC, NC>(a, GridTile());
}

}  // namespace
