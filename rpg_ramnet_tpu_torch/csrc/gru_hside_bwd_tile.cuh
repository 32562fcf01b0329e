// The tile of kernel K2 (gru_hside_bwd.cu): one block computes the ConvGRU
// h-side cell's backward on a TH x TW output tile, for all C channels.
//
//     dpre_o = g * z * (1 - o^2)
//     da     = convT3x3(bf16(dpre_o), Wo)
//     dpre_r = da * h * r * (1 - r)          dpre_z = g * (o - h) * z * (1 - z)
//     dh     = g * (1 - z) + da * r + convT3x3(bf16([dpre_z | dpre_r]), Wur)
//     dgx    = bf16([dpre_z | dpre_r | dpre_o])
//
// What bounds it on this card.  Per pixel it must read g, h, acts and write
// dh, dgx (18*C bytes) and do 27*C^2 multiply-adds (9*C^2 for da, 18*C^2 for
// dh): 3*C flop per byte, at or above the bf16 ridge (~295 flop/B) at C >=
// 128, so the bound is the tensor cores' there and the bytes' at C = 64.
// What held the first design at 3-8% of it: its warps read the B
// fragments with 4-byte loads from L1/L2 for every 32-pixel x 16-channel
// item, 1.85-3.7 GB of weights per launch at the training shapes against
// 58-231 MB of maps; g, h and acts were read gate by gate, 4 bytes a lane,
// up to three times; the wrapper folded the weights (flip, transpose) in
// two extra kernels per call.
//
// What the design does about it, after K1's tile (gru_hside_tile.cuh):
//   * the weights stream once per block and phase through a ring of two
//     slabs in shared memory by cp.async (the next slab loads while the
//     warps consume this one), a slab one tap x ks contraction rows x all
//     C output channels.  They are read in the forward layout the Function
//     saves, w[tap][out][in]: convT's contraction runs over the forward's
//     output channel and its tap is 8 - tap, so a slab is ks rows `out` of
//     tap 8 - tap, each row the C inputs contiguous (16-byte copies), and
//     the B fragments come from it by ldmatrix.trans;
//   * phase o (elementwise) forms dpre_o for all C channels on the tile
//     plus a 2-pixel ring (0 outside the image) into the A tile of phase
//     da, and dpre_z on the tile plus a 1-pixel ring into the A tile of
//     phase dh, from g, z, o and h read 16 bytes a lane; it writes dgx's z
//     and o parts at the tile and stages g * (1 - z) there in f32;
//   * phase da: an implicit GEMM on mma.sync m16n8k16 over the dpre_o tile
//     (M = the tile plus its 1-pixel ring, N = C, K = 9*C).  h and r on
//     that ring arrive by cp.async with its first slab; the epilogue forms
//     dpre_r (0 outside the image, where h is 0) into the [dpre_z | dpre_r]
//     tile and adds da * r to the staged g * (1 - z).  dgx's r part leaves
//     from that tile, 16 bytes a lane;
//   * phase dh: an implicit GEMM over the [dpre_z | dpre_r] tile (M = the
//     tile, N = C, K = 9*2C); dh = the staged f32 terms + the sum, staged
//     in shared memory and written 16 bytes a lane;
//   * a warp owns one job per pass, 16*MR pixels x 8*NR channels in phase
//     da and 16*MC x 8*NC in phase dh, its accumulators held across the
//     whole K walk, the next k16 step's fragments loaded while the current
//     step's products issue.  Where the tile has more jobs than warps the
//     block makes further passes over the weights.
// K2 splits no channels over a cluster, as K1 does at C >= 128: timed
// against the best unsplit plan, a split of 2 gained less than the
// run-to-run spread (PERF.md §6).  The tile and slab loops are walked
// without division (Walk).  The wrapper plans the tile, the warp jobs and
// the slab width per shape (ops/gru_hside.py::plan_k2) and passes the
// plan.
#pragma once

#include "lstm_hside_tile.cuh"   // K1's tile helpers and Walk

namespace {

// The launch's arguments.  g, h, dh [B,H,W,C]; acts, dgx [B,H,W,3C];
// w_ur [9,2C,C] (update rows, then reset rows) and w_o [9,C,C], the forward
// layout [tap][out][in].
struct K2Args {
  const bf16* g;
  const bf16* h;
  const bf16* acts;
  const bf16* w_ur;
  const bf16* w_o;
  bf16* dh;
  bf16* dgx;
  int H, W, C;
  int TH, TW;   // output tile
  int ks;       // contraction rows per weight slab: 16, 32 or 64
};

// Shared memory of one block in bytes: the dpre_o tile with its 2-pixel
// ring at pixel pitch C + kPad, the [dpre_z | dpre_r] tile with its 1-pixel
// ring at 2*C + kPad, the weight ring (kStages x ks rows at pitch C +
// kPad), the io tile (h and r on the 1-pixel ring at pitch 2*C + kPad in
// phase da; in phase dh dh staged at the tile at C + kPad, which fits in
// it), bf16, and g * (1 - z) + da * r at the tile in f32.
// ops/gru_hside.py::k2_smem_bytes computes the same.
inline size_t k2_smem_bytes(int TH, int TW, int C, int ks) {
  const size_t ring = (size_t)(TH + 2) * (TW + 2), px = (size_t)TH * TW;
  return ((size_t)(TH + 4) * (TW + 4) * (C + kPad) + 2 * ring * (2 * C + kPad) +
          (size_t)kStages * ks * (C + kPad)) *
             sizeof(bf16) +
         px * C * sizeof(float);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B fragments of NT n8 tiles from a slab stored [k][n] (n contiguous), a
// pair of tiles per ldmatrix.x4.trans; base: this lane's row address of the
// job's first pair.  Pairs at or past the C channels are not loaded.
template <int NT>
__device__ __forceinline__ void load_bt(uint32_t (&bf)[NT / 2][4], uint32_t base, int n0,
                                        int C) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    if (n0 + np * 16 < C) ldmatrix_x4_trans(base + 2 * np * 16, bf[np]);
}

// acc += one slab's products for an MT x NT job: ks contraction rows, the
// A fragments at a_addr + off, the B fragments at bb (row pitch rp), k16
// steps in pairs, each step's fragments loaded while the previous step's
// products issue.
template <int MT, int NT>
__device__ __forceinline__ void slab_mma(float (&acc)[MT][NT][4], const uint32_t (&a_addr)[MT],
                                         uint32_t off, uint32_t bb, int rp, int ks, int n0,
                                         int C) {
  uint32_t a0[MT][4], a1[MT][4], b0[NT / 2][4], b1[NT / 2][4];
  load_a<MT>(a0, a_addr, off);
  load_bt<NT>(b0, bb, n0, C);
  for (int kk = 0; kk < ks; kk += 32) {
    const bool odd = kk + 16 < ks;
    if (odd) {
      load_a<MT>(a1, a_addr, off + 2 * (kk + 16));
      load_bt<NT>(b1, bb + 2 * (kk + 16) * rp, n0, C);
    }
    mma_job<MT, NT>(acc, a0, b0, n0, C);
    if (kk + 32 < ks) {
      load_a<MT>(a0, a_addr, off + 2 * (kk + 32));
      load_bt<NT>(b0, bb + 2 * (kk + 32) * rp, n0, C);
    }
    if (odd) mma_job<MT, NT>(acc, a1, b1, n0, C);
  }
}

// Weight slab s of a phase into the ring buffer at dst: tap t = s / kc,
// contraction rows k0 = (s % kc) * ks ... of the transposed conv, which are
// rows k0 ... of the forward weight w [9][rows][C] at tap 8 - t, each its
// C inputs (16-byte copies), at row pitch C + kPad.  walk: this thread's
// start in the slab's [ks][C / 8] vectors.
__device__ __forceinline__ void load_k2_slab(const bf16* __restrict__ w, int rows, int C,
                                             int s, int kc, int ks, int rp,
                                             const Walk<2>& walk, uint32_t dst) {
  const int tap = s / kc, k0 = (s - tap * kc) * ks;
  const bf16* src = w + ((size_t)(8 - tap) * rows + k0) * C;
  for (Walk<2> v = walk; v.valid(); v.next())
    cp_async16_zfill(dst + 2 * (v.i[0] * rp + v.i[1] * 8), src + (size_t)v.i[0] * C + v.i[1] * 8,
                     true);
}

// One block of the backward.  Grid: x = tile column, y = tile row, z =
// batch item.  MR x NR: a warp's phase-da job in m16 x n8
// tiles; MC x NC its phase-dh job.  NR and NC even (ldmatrix.x4 loads two
// n8 tiles of B).
template <int MR, int NR, int MC, int NC>
__global__ void __launch_bounds__(kThreads, 1) k2_kernel(const K2Args a) {
  static_assert(NR % 2 == 0 && NC % 2 == 0, "B fragments come in n8 pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, H = a.H, W = a.W, TH = a.TH, TW = a.TW, ks = a.ks;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t img = (size_t)blockIdx.z * H * W;   // the batch item's first pixel
  const int C3 = 3 * C;

  const int ps_o = C + kPad, ps_u = 2 * C + kPad;   // pixel pitches of the A tiles
  const int ow = TW + 4, oh = TH + 4;   // dpre_o: the tile plus a 2-pixel ring
  const int uw = TW + 2, uh = TH + 2;   // [dpre_z | dpre_r]: plus a 1-pixel ring
  const int rp = C + kPad;              // row pitch of a weight slab
  const int pio = 2 * C + kPad;         // io tile pitch, phase da (h | r)
  const int pdh = C + kPad;             // io tile pitch, phase dh (dh)
  const int n_u = uh * uw, n_c = TH * TW;
  bf16* os = reinterpret_cast<bf16*>(smem_raw);
  bf16* us = os + oh * ow * ps_o;
  bf16* ring = us + n_u * ps_u;
  bf16* io = ring + kStages * ks * rp;
  float* base = reinterpret_cast<float*>(io + n_u * pio);   // [n_c][C]
  const uint32_t os_u = (uint32_t)__cvta_generic_to_shared(os);
  const uint32_t us_u = (uint32_t)__cvta_generic_to_shared(us);
  const uint32_t ring_u = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t io_u = (uint32_t)__cvta_generic_to_shared(io);
  const int vc = C / 8;                      // 16-byte vectors of a pixel's channels
  const uint32_t slab_b = 2u * ks * rp;      // bytes of one ring buffer

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix.trans row of a B fragment pair: contraction row
  // lane & 15, output column (lane >> 4) * 8
  const uint32_t b_lane = 2u * ((lane & 15) * rp + (lane >> 4) * 8);
  const int slab_dims[2] = {ks, vc};
  const Walk<2> slab_walk(slab_dims);

  // 1. h and r on the 1-pixel ring (0 outside the image) and phase da's
  //    first weight slab, one cp.async group
  {
    const int dims[4] = {uh, uw, 2, vc};
    for (Walk<4> w(dims); w.valid(); w.next()) {
      const int ry = w.i[0], rx = w.i[1], slot = w.i[2], v = w.i[3];
      const int gy = y0 - 1 + ry, gx_ = x0 - 1 + rx;
      const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
      const size_t p = img + (size_t)gy * W + gx_;
      const bf16* src = !inside ? a.h
                        : slot == 0 ? a.h + p * C + v * 8
                                    : a.acts + p * C3 + C + v * 8;
      cp_async16_zfill(io_u + 2 * ((ry * uw + rx) * pio + slot * C + v * 8), src, inside);
    }
  }
  const int kc_o = C / ks, S_o = 9 * kc_o;   // phase da: slabs per tap, per pass
  load_k2_slab(a.w_o, C, C, 0, kc_o, ks, rp, slab_walk, ring_u);
  cp_async_commit_group();

  // 2. Phase o: dpre_o on the 2-pixel ring, dpre_z on the 1-pixel ring (all
  //    C channels, 0 outside the image); at the tile, dgx's z and o parts
  //    and g * (1 - z).  Ring pixel (py, px) is image (y0-2+py, x0-2+px).
  {
    const int dims[3] = {oh, ow, vc};
    for (Walk<3> w(dims); w.valid(); w.next()) {
      const int py = w.i[0], px = w.i[1], v = w.i[2];
      const int gy = y0 - 2 + py, gx_ = x0 - 2 + px;
      const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
      const bool ring1 = py >= 1 && py <= TH + 2 && px >= 1 && px <= TW + 2;
      const bool center = py >= 2 && py < TH + 2 && px >= 2 && px < TW + 2;
      uint4 dpo = make_uint4(0, 0, 0, 0), dpz = dpo;
      float gz[8];
      if (inside) {
        const size_t p = img + (size_t)gy * W + gx_;
        const uint4 gv = *reinterpret_cast<const uint4*>(a.g + p * C + v * 8);
        const uint4 zv = *reinterpret_cast<const uint4*>(a.acts + p * C3 + v * 8);
        const uint4 ov = *reinterpret_cast<const uint4*>(a.acts + p * C3 + 2 * C + v * 8);
        const uint4 hv = ring1 ? *reinterpret_cast<const uint4*>(a.h + p * C + v * 8) : dpo;
        const uint32_t* gw = &gv.x;
        const uint32_t* zw = &zv.x;
        const uint32_t* ow_ = &ov.x;
        const uint32_t* hw_ = &hv.x;
        uint32_t* po = &dpo.x;
        uint32_t* pz = &dpz.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 g2 = unpack_bf2(gw[j]), z2 = unpack_bf2(zw[j]);
          const float2 o2 = unpack_bf2(ow_[j]), h2 = unpack_bf2(hw_[j]);
          po[j] = pack_bf2(g2.x * z2.x * (1.0f - o2.x * o2.x), g2.y * z2.y * (1.0f - o2.y * o2.y));
          pz[j] = pack_bf2(g2.x * (o2.x - h2.x) * z2.x * (1.0f - z2.x),
                           g2.y * (o2.y - h2.y) * z2.y * (1.0f - z2.y));
          gz[2 * j] = g2.x * (1.0f - z2.x);
          gz[2 * j + 1] = g2.y * (1.0f - z2.y);
        }
        if (center) {
          *reinterpret_cast<uint4*>(a.dgx + p * C3 + v * 8) = dpz;
          *reinterpret_cast<uint4*>(a.dgx + p * C3 + 2 * C + v * 8) = dpo;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) gz[j] = 0.0f;
      }
      *reinterpret_cast<uint4*>(os + (py * ow + px) * ps_o + v * 8) = dpo;
      if (ring1) *reinterpret_cast<uint4*>(us + ((py - 1) * uw + px - 1) * ps_u + v * 8) = dpz;
      if (center) {
        float4* bp = reinterpret_cast<float4*>(base + ((py - 2) * TW + px - 2) * C + v * 8);
        bp[0] = make_float4(gz[0], gz[1], gz[2], gz[3]);
        bp[1] = make_float4(gz[4], gz[5], gz[6], gz[7]);
      }
    }
  }

  // 3. Phase da on the 1-pixel ring: ring pixel (ry, rx) is image (y0-1+ry,
  //    x0-1+rx); its taps start at dpre_o pixel (ry, rx).
  {
    const int mj = (n_u + 16 * MR - 1) / (16 * MR), nj = (C + 8 * NR - 1) / (8 * NR);
    const int jobs = mj * nj;
    const int total = ((jobs + kWarps - 1) / kWarps) * S_o;
    float acc[MR][NR][4];
    uint32_t a_addr[MR];
    int m0 = 0, n0 = 0;
    bool busy = false;
    for (int s = 0, ss = 0, tap = 0, kq = 0; s < total; ++s) {
      if (ss == 0) {   // a new pass: this warp's job
        const int job = (s / S_o) * kWarps + warp;
        busy = job < jobs;
        m0 = (job / nj) * 16 * MR;
        n0 = (job % nj) * 8 * NR;
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          const int q = min(m0 + mi * 16 + (lane & 15), n_u - 1);
          const int ry = q / uw, rx = q - ry * uw;
          a_addr[mi] = os_u + 2 * ((ry * ow + rx) * ps_o + (lane >> 4) * 8);
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
      if (s + 1 < total)
        load_k2_slab(a.w_o, C, C, ss + 1 < S_o ? ss + 1 : 0, kc_o, ks, rp, slab_walk,
                     ring_u + ((s + 1) & 1) * slab_b);
      cp_async_commit_group();
      if (busy) {
        const int ky = tap / 3, kx = tap - ky * 3;
        slab_mma<MR, NR>(acc, a_addr, 2 * ((ky * ow + kx) * ps_o + kq * ks),
                         ring_u + (s & 1) * slab_b + b_lane + 2 * n0, rp, ks, n0, C);
      }
      if (ss == S_o - 1 && busy) {   // the pass's epilogue: dpre_r, da * r
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = m0 + mi * 16 + g + 8 * half;
            if (q >= n_u) continue;
            const int ry = q / uw, rx = q - ry * uw;
            const bool center = ry >= 1 && ry <= TH && rx >= 1 && rx <= TW;
            const bf16* hp = io + q * pio + n0 + 2 * t;
            bf16* up = us + q * ps_u + C + n0 + 2 * t;
            const int bq = center ? ((ry - 1) * TW + rx - 1) * C + n0 + 2 * t : 0;
#pragma unroll
            for (int ni = 0; ni < NR; ++ni) {
              if (n0 + ni * 8 >= C) continue;
              const float2 h2 = unpack_bf2(ld_u32(hp + ni * 8));
              const float2 r2 = unpack_bf2(ld_u32(hp + C + ni * 8));
              const float d0 = acc[mi][ni][2 * half], d1 = acc[mi][ni][2 * half + 1];
              st_u32(up + ni * 8, pack_bf2(d0 * h2.x * r2.x * (1.0f - r2.x),
                                           d1 * h2.y * r2.y * (1.0f - r2.y)));
              if (center) {
                float2* b2 = reinterpret_cast<float2*>(base + bq + ni * 8);
                const float2 v = *b2;
                *b2 = make_float2(v.x + d0 * r2.x, v.y + d1 * r2.y);
              }
            }
          }
        }
      }
      if (++kq == kc_o) {
        kq = 0;
        ++tap;
      }
      if (++ss == S_o) {
        ss = 0;
        tap = 0;
      }
    }
  }
  __syncthreads();   // the ring is free, dpre_r written

  // 4. dgx's r part at the tile, 16 bytes a lane; phase dh's first slab
  const int kc_u = 2 * C / ks, S_u = 9 * kc_u;   // phase dh: slabs per tap, per pass
  load_k2_slab(a.w_ur, 2 * C, C, 0, kc_u, ks, rp, slab_walk, ring_u);
  cp_async_commit_group();
  {
    const int dims[3] = {TH, TW, vc};
    for (Walk<3> w(dims); w.valid(); w.next()) {
      const int cy = w.i[0], cx = w.i[1], v = w.i[2];
      const int gy = y0 + cy, gx_ = x0 + cx;
      if (gy >= H || gx_ >= W) continue;
      *reinterpret_cast<uint4*>(a.dgx + (img + (size_t)gy * W + gx_) * C3 + C + v * 8) =
          *reinterpret_cast<const uint4*>(us + ((cy + 1) * uw + cx + 1) * ps_u + C + v * 8);
    }
  }

  // 5. Phase dh on the tile: output pixel (cy, cx) is image (y0+cy, x0+cx);
  //    its taps start at ring pixel (cy, cx) of [dpre_z | dpre_r].
  {
    const int mj = (n_c + 16 * MC - 1) / (16 * MC), nj = (C + 8 * NC - 1) / (8 * NC);
    const int jobs = mj * nj;
    const int total = ((jobs + kWarps - 1) / kWarps) * S_u;
    float acc[MC][NC][4];
    uint32_t a_addr[MC];
    int m0 = 0, n0 = 0;
    bool busy = false;
    for (int s = 0, ss = 0, tap = 0, kq = 0; s < total; ++s) {
      if (ss == 0) {
        const int job = (s / S_u) * kWarps + warp;
        busy = job < jobs;
        m0 = (job / nj) * 16 * MC;
        n0 = (job % nj) * 8 * NC;
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
          const int cy = q / TW, cx = q - cy * TW;
          a_addr[mi] = us_u + 2 * ((cy * uw + cx) * ps_u + (lane >> 4) * 8);
        }
#pragma unroll
        for (int mi = 0; mi < MC; ++mi)
#pragma unroll
          for (int ni = 0; ni < NC; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < total)
        load_k2_slab(a.w_ur, 2 * C, C, ss + 1 < S_u ? ss + 1 : 0, kc_u, ks, rp, slab_walk,
                     ring_u + ((s + 1) & 1) * slab_b);
      cp_async_commit_group();
      if (busy) {
        const int ky = tap / 3, kx = tap - ky * 3;
        slab_mma<MC, NC>(acc, a_addr, 2 * ((ky * uw + kx) * ps_u + kq * ks),
                         ring_u + (s & 1) * slab_b + b_lane + 2 * n0, rp, ks, n0, C);
      }
      if (ss == S_u - 1 && busy) {   // the pass's epilogue: dh staged
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = m0 + mi * 16 + g + 8 * half;
            if (q >= n_c) continue;
            const float* bp = base + q * C + n0 + 2 * t;
            bf16* dp = io + q * pdh + n0 + 2 * t;
#pragma unroll
            for (int ni = 0; ni < NC; ++ni) {
              if (n0 + ni * 8 >= C) continue;
              const float2 b2 = *reinterpret_cast<const float2*>(bp + ni * 8);
              st_u32(dp + ni * 8, pack_bf2(b2.x + acc[mi][ni][2 * half],
                                           b2.y + acc[mi][ni][2 * half + 1]));
            }
          }
        }
      }
      if (++kq == kc_u) {
        kq = 0;
        ++tap;
      }
      if (++ss == S_u) {
        ss = 0;
        tap = 0;
      }
    }
  }
  __syncthreads();
  // dh from the io tile, 16 bytes a lane
  {
    const int dims[3] = {TH, TW, vc};
    for (Walk<3> w(dims); w.valid(); w.next()) {
      const int cy = w.i[0], cx = w.i[1], v = w.i[2];
      const int gy = y0 + cy, gx_ = x0 + cx;
      if (gy >= H || gx_ >= W) continue;
      *reinterpret_cast<uint4*>(a.dh + (img + (size_t)gy * W + gx_) * C + v * 8) =
          *reinterpret_cast<const uint4*>(io + (cy * TW + cx) * pdh + v * 8);
    }
  }
}

}  // namespace
