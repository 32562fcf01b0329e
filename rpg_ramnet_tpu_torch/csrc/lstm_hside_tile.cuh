// The tile of the ConvLSTM kernels (lstm_hside.cu): K3 and K4 for
// inference, K3-res and K4-res for training.  One block computes the
// ConvLSTM h-side cell (K4, K4-res: the phased cell) on a TH x TW output
// tile, for all C channels or, with a split of 2 or 4, for its C/split of
// them.
//
//     g = conv3x3(h, W4) + gx      i, f, o = sigmoid(g_i, g_f, g_o)   u = tanh(g_u)
//     c' = f * c + i * u           h' = o * tanh(c')
//
// K4 and K4-res then blend (c', h') with the state by the time gate k(t);
// the training variants also write the gate activations acts = (i, f, o,
// u) [B,H,W,4C] for the backward (the template flag kActs).
//
// What bounds them on this card.  Per pixel the cell does 36*C^2
// multiply-adds and must move 16*C bytes (K3; K4 20*C and 8*C of f32 tau
// and phase; K3-res 24*C, K4-res 26*C): 4.5*C flop per byte for K3, 3*C for
// K3-res, at or above the H100's bf16 ridge (~295 flop/B) at C = 128 and
// 256, so the conv belongs on the tensor cores and its bound is theirs.
// The inference kernels run at B = 1 (1408 to 32768 pixels), where a launch
// of one block per SM fills one or two waves of 132 SMs at most and the
// weights (4C x 9C bf16, 4.7 MB at C = 256) are read by every block: the
// weight bytes through L2, not the maps, then set the time.  What held the
// first design (a kernel of its own, which K3 and K4 ran until this tile
// took them) at 1.7-6% of the bound was that weight feed: each warp item of 32
// pixels x 16 channels x 4 gates read its B fragments with 4-byte loads
// from L1/L2, 9*4*16*C bf16 per item, so a launch re-read 2.25*B*H*W*C^2
// bytes of weights; its epilogue loaded gx and c and stored the outputs 4
// bytes a lane at pitches C and 4C, and computed the gates in IEEE
// arithmetic.
//
// What the design does about it, after K1's tile (gru_hside_tile.cuh):
//   * a block owns the (pixel, channel) pairs of its tile and its channel
//     slice c0 .. c0 + Cn (Cn = C / split): the four gate rows q*C + c of a
//     channel meet in one thread's registers, where the cell update and the
//     time-gate blend run, so a split is by channel and never by gate.  The
//     LSTM has one conv and no exchange between channel slices, so a split
//     is a plain grid axis, no cluster: it costs only the h tile, which
//     every block of a pixel tile stages whole, and lets a larger tile
//     (fewer weight passes per launch) keep the blocks of a wave;
//   * the weights stream once per block and pass through a ring of two
//     slabs in shared memory by cp.async (the next slab loads while the
//     warps consume this one), each slab one tap x KS input channels x the
//     block's 4*Cn gate rows, read straight from the folded [9][4C][C]
//     weight with 16-byte copies; B fragments come from the ring by
//     ldmatrix;
//   * a warp owns one job per pass: 16*MR pixels x 16 channels x 4 gates,
//     its accumulators (16*MR f32 per thread) held across the whole K walk
//     of 9 taps x C inputs, the next k16 step's fragments loaded while the
//     current step's products issue.  Where the tile has more jobs than
//     warps, the block makes further passes over the weights;
//   * the h tile with its 1-pixel halo (zero outside the image: the conv's
//     padding), gx and c of the block's channels arrive by cp.async with the
//     first weight slab, into the io tile's 5 input slots [gx_i | gx_f |
//     gx_o | gx_u | c].  K4's tau and phase (f32, one [H,W,C] for the whole
//     batch, so L2-resident) are read in the epilogue through L1: staged,
//     they took 8*Cn bytes of shared memory per pixel, narrower slabs and
//     smaller tiles;
//   * the epilogue reads gx and c from shared memory, computes the gates on
//     the special-function unit (ex2 and rcp, tanh as 1 - 2 sigmoid(-2x):
//     gate_sigmoid, gate_tanh; -DRAMNET_LSTM_EXACT_GATES builds the IEEE
//     forms, against which gru_hside_timing.py --lstm --gates measures
//     these) and stages the outputs in the io tile in place (a thread
//     writes only the (pixel, channel) pairs it read), from where the
//     block writes them 16 bytes a lane.  K3 and K4 stage their 2 or 3
//     outputs over the input slots (pixel pitch 5*Cn + kPad) and store no
//     acts; K3-res and K4-res add the 4 acts slots ahead of the outputs
//     (6*Cn or 7*Cn + kPad).  The time gate stays correctly rounded
//     (time_gate: a contracted or approximate op there can move phi across
//     a region boundary).
// Measured (PERF.md §6), the training variants' weight bytes per launch
// fell from 925 MB to 231-604 MB and the kernels to 12-22% of their bound;
// K3's and K4's at B=1 from 208-604 MB to 38-151 MB (a split of 4 at C >=
// 128) and the kernels to 9-20% of their bound, 1.7-5.6x the first design.
// What is left: one block of 8 warps per SM (154-245 registers, up to 231
// KB of shared memory), so a block's loads, products, epilogue and stores
// follow each other rather than overlap, and at B=1 a launch is one wave
// or two, so nothing hides the first slab's and the last store's latency.
// The wrapper plans the tile, the split, the warp jobs and the slab width
// per kernel and shape (ops/gru_hside.py::plan_lstm) and passes the plan.
#pragma once

#include "gru_hside_tile.cuh"

namespace {

// The launch's arguments.  h, c [B,H,W,C]: the conv operand and the cell
// input (K4, K4-res: c0 and h0); gx [H,W,4C] per batch item, items
// gx_bstride elements apart; w4 [9,4C,C] ([tap][gate*C + out][in]); K4's
// tau, phase [H,W,C] and times [B] (f32); outputs [B,H,W,C]: K3 (h', c'),
// K4 (h_t, h_new, c_new); K3-res and K4-res also acts [B,H,W,4C] (null
// for K3 and K4).
struct LstmArgs {
  const bf16* h;
  const bf16* c;
  const bf16* gx;
  const bf16* w4;
  const float* tau;
  const float* phase;
  const float* times;
  bf16* out[3];
  bf16* acts;
  int H, W, C;
  long long gx_bstride;
  int TH, TW;   // output tile
  int split;    // blocks per tile, each C / split channels: 1, 2 or 4
  int ks;       // input channels per weight slab: 16, 32 or 64
  float leak, ratio_on;
};

// Shared memory of one block in bytes: the h tile with its 1-pixel halo at
// pixel pitch C + kPad, the weight ring (kStages x 4*Cn rows at pitch
// ks + kPad) and the io tile, per output pixel [gx_i | gx_f | gx_o | gx_u |
// c] in, Cn each, and out [out0 | out1 (| out2)] over them (K3, K4: 5 slots)
// or [i | f | o | u | out0 | out1 (| out2)] (acts: K3-res 6 slots, K4-res
// 7), at pitch slots*Cn + kPad, bf16.  ops/gru_hside.py::lstm_smem_bytes
// computes the same.
inline size_t lstm_smem_bytes(int TH, int TW, int C, int split, int ks, bool phased,
                              bool acts) {
  const size_t cn = C / split, px = (size_t)TH * TW;
  return ((size_t)(TH + 2) * (TW + 2) * (C + kPad) + (size_t)kStages * 4 * cn * (ks + kPad) +
          px * ((acts ? (phased ? 7 : 6) : 5) * cn + kPad)) * sizeof(bf16);
}

#ifdef RAMNET_LSTM_EXACT_GATES
__device__ __forceinline__ float lstm_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float lstm_tanh(float x) { return tanhf(x); }
#else
__device__ __forceinline__ float lstm_sigmoid(float x) { return gate_sigmoid(x); }

__device__ __forceinline__ float lstm_tanh(float x) { return gate_tanh(x); }
#endif

// k(t) of one feature (phased_cell.py::_phased_cell_math's time gate),
// correctly rounded: phi = |fmod(t - phase, tau)| / tau.
__device__ __forceinline__ float time_gate(float t, float tau, float phase,
                                           float leak, float ratio_on) {
  const float phi = __fdiv_rn(fabsf(fmodf(__fsub_rn(t, phase), tau)), tau);
  const float k_up = __fdiv_rn(__fmul_rn(2.0f, phi), ratio_on);
  const float k = phi < ratio_on ? __fsub_rn(2.0f, k_up) : __fmul_rn(leak, phi);
  return phi < __fmul_rn(0.5f, ratio_on) ? k_up : k;
}

__device__ __forceinline__ float blend(float k, float a, float b) {
  return __fadd_rn(__fmul_rn(k, a), __fmul_rn(__fsub_rn(1.0f, k), b));
}

// The indices threadIdx.x, + kThreads, ... of a row-major [n0][n1]..[nN-1]
// space as coordinates i[0..N-1], each step carried digit by digit: the
// divisions are taken once, not per 16 bytes.
template <int N>
struct Walk {
  int i[N], d[N], n[N];
  __device__ __forceinline__ explicit Walk(const int (&dims)[N]) {
    int e = threadIdx.x, step = kThreads;
#pragma unroll
    for (int k = N - 1; k > 0; --k) {
      n[k] = dims[k];
      i[k] = e % n[k];
      e /= n[k];
      d[k] = step % n[k];
      step /= n[k];
    }
    n[0] = dims[0];
    i[0] = e;
    d[0] = step;
  }
  __device__ __forceinline__ bool valid() const { return i[0] < n[0]; }
  __device__ __forceinline__ void next() {
    int carry = 0;
#pragma unroll
    for (int k = N - 1; k > 0; --k) {
      i[k] += d[k] + carry;   // < 2 n[k]: one subtraction carries
      carry = i[k] >= n[k];
      if (carry) i[k] -= n[k];
    }
    i[0] += d[0] + carry;
  }
};

// Weight slab s (tap s / kc, input channels (s % kc) * ks ...) into the
// ring buffer at dst: for each gate q the block's Cn rows q*C + c0 ... of
// w4, at row q*Cn + j, pitch ks + kPad.  A thread copies 16 bytes of every
// (kThreads*8/ks)-th row of each gate: ks/8 is a power of two, so its
// column is fixed.
__device__ __forceinline__ void load_lstm_slab(const LstmArgs& a, int s, int kc, int Cn, int c0,
                                               uint32_t dst) {
  const int C = a.C, ks = a.ks;
  const int lv = ks == 64 ? 3 : ks == 32 ? 2 : 1;   // log2 of the vectors per row
  const int v = threadIdx.x & ((1 << lv) - 1), rstep = kThreads >> lv;
  const int tap = s / kc, k0 = (s - tap * kc) * ks + v * 8;
  const int rp = ks + kPad;
  const bf16* w = a.w4 + ((size_t)tap * 4 * C + c0) * C + k0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int r = threadIdx.x >> lv; r < Cn; r += rstep)
      cp_async16_zfill(dst + 2 * ((q * Cn + r) * rp + v * 8), w + ((size_t)q * C + r) * C, true);
}

// One block of the cell.  Grid: x = tile column * split + rank, y = tile
// row, z = batch item.  kPhased: K4 (K4-res); kActs: the training variant,
// which also writes acts.  MR: a warp's job in m16 tiles (16*MR pixels);
// its 16 channels are two n8 tiles of each gate.
template <bool kPhased, bool kActs, int MR>
__global__ void __launch_bounds__(kThreads, 1) lstm_kernel(const LstmArgs a) {
  constexpr int NR = 2;
  constexpr int kOuts = kPhased ? 3 : 2;               // output maps
  constexpr int kFirst = kActs ? 4 : 0;                // io slot of out0
  constexpr int kSlots = kActs ? kFirst + kOuts : 5;   // io slots per pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, H = a.H, W = a.W, TH = a.TH, TW = a.TW;
  const int split = a.split;
  const int rank = blockIdx.x % split;
  const int Cn = C / split, c0 = rank * Cn;
  const int y0 = blockIdx.y * TH, x0 = (blockIdx.x / split) * TW;
  const int b = blockIdx.z;
  const size_t plane = (size_t)H * W * C;
  const bf16* hb = a.h + b * plane;
  const bf16* cb = a.c + b * plane;
  const bf16* gb = a.gx + (size_t)b * a.gx_bstride;
  const int C4 = 4 * C;

  const int ps = C + kPad;              // pixel pitch of the h tile
  const int hw = TW + 2, hh = TH + 2;   // h tile with a 1-pixel halo
  const int rp = a.ks + kPad;           // row pitch of a weight slab
  const int iop = kSlots * Cn + kPad;   // pixel pitch of the io tile
  const int n_c = TH * TW;
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = hs + hh * hw * ps;
  bf16* io = ring + kStages * 4 * Cn * rp;
  const uint32_t hs_u = (uint32_t)__cvta_generic_to_shared(hs);
  const uint32_t ring_u = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t io_u = (uint32_t)__cvta_generic_to_shared(io);
  const int vc = Cn / 8;                         // 16-byte vectors of a channel slice
  const uint32_t slab_b = 2u * 4 * Cn * rp;      // bytes of one ring buffer
  const uint32_t gate_b = 2u * Cn * rp;          // bytes of one gate's rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kc = C / a.ks;   // slabs per tap
  const int S = 9 * kc;      // slabs per pass over the weights
  // this lane's ldmatrix row of a B fragment pair, as in K1
  const uint32_t b_lane = 2u * ((((lane >> 4) & 1) * 8 + (lane & 7)) * rp + ((lane >> 3) & 1) * 8);

  // 1. The h tile: image rows y0-1 .. y0+TH (and columns alike), 0
  //    outside; gx (4 gates) and c of the block's channels at the output
  //    tile, 0 outside the image
  {
    const int dims[3] = {hh, hw, C / 8};
    for (Walk<3> w(dims); w.valid(); w.next()) {
      const int py = w.i[0], px = w.i[1], v = w.i[2];
      const int gy = y0 - 1 + py, gx_ = x0 - 1 + px;
      const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
      const bf16* src = inside ? hb + ((size_t)gy * W + gx_) * C + v * 8 : hb;
      cp_async16_zfill(hs_u + 2 * ((py * hw + px) * ps + v * 8), src, inside);
    }
  }
  {
    const int dims[4] = {TH, TW, 5, vc};
    for (Walk<4> w(dims); w.valid(); w.next()) {
      const int cy = w.i[0], cx = w.i[1], slot = w.i[2], v = w.i[3];
      const int gy = y0 + cy, gx_ = x0 + cx;
      const bool inside = gy < H && gx_ < W;
      const size_t px = (size_t)gy * W + gx_;
      const bf16* src = !inside ? hb
                        : slot < 4 ? gb + px * C4 + slot * C + c0 + v * 8
                                   : cb + px * C + c0 + v * 8;
      cp_async16_zfill(io_u + 2 * ((cy * TW + cx) * iop + slot * Cn + v * 8), src, inside);
    }
  }

  // 2. The gates, the cell update (and the time-gate blend): output pixel
  //    (cy, cx) is image (y0+cy, x0+cx); its taps start at h-tile pixel
  //    (cy, cx).
  const int mj = (n_c + 16 * MR - 1) / (16 * MR), nj = Cn / (8 * NR);
  const int jobs = mj * nj;
  const int total = ((jobs + kWarps - 1) / kWarps) * S;
  load_lstm_slab(a, 0, kc, Cn, c0, ring_u);
  cp_async_commit_group();
  const float t_b = kPhased ? a.times[b] : 0.0f;
  float acc[4][MR][NR][4];
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
        const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
        const int cy = q / TW, cx = q - cy * TW;
        a_addr[mi] = hs_u + 2 * ((cy * hw + cx) * ps + (lane >> 4) * 8);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int mi = 0; mi < MR; ++mi)
#pragma unroll
          for (int ni = 0; ni < NR; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][mi][ni][e] = 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < total) load_lstm_slab(a, (s + 1) % S, kc, Cn, c0, ring_u + ((s + 1) & 1) * slab_b);
    cp_async_commit_group();
    if (busy) {
      const int tap = ss / kc, k0 = (ss - tap * kc) * a.ks;
      const int ky = tap / 3, kx = tap - ky * 3;
      const uint32_t off = 2 * ((ky * hw + kx) * ps + k0);
      const uint32_t bb = ring_u + (s & 1) * slab_b + b_lane + 2 * n0 * rp;
      // k16 steps in pairs, each step's fragments loaded while the
      // previous step's products issue
      uint32_t a0[MR][4], a1[MR][4], b0[4][NR / 2][4], b1[4][NR / 2][4];
      load_a<MR>(a0, a_addr, off);
#pragma unroll
      for (int q = 0; q < 4; ++q) load_b<NR>(b0[q], bb + q * gate_b, rp, n0, Cn);
      for (int kk = 0; kk < a.ks; kk += 32) {
        const bool odd = kk + 16 < a.ks;
        if (odd) {
          load_a<MR>(a1, a_addr, off + 2 * (kk + 16));
#pragma unroll
          for (int q = 0; q < 4; ++q) load_b<NR>(b1[q], bb + q * gate_b + 2 * (kk + 16), rp, n0, Cn);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_job<MR, NR>(acc[q], a0, b0[q], n0, Cn);
        if (kk + 32 < a.ks) {
          load_a<MR>(a0, a_addr, off + 2 * (kk + 32));
#pragma unroll
          for (int q = 0; q < 4; ++q) load_b<NR>(b0[q], bb + q * gate_b + 2 * (kk + 32), rp, n0, Cn);
        }
        if (odd) {
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_job<MR, NR>(acc[q], a1, b1[q], n0, Cn);
        }
      }
    }
    if (ss == S - 1 && busy) {   // the pass's epilogue, staged in the io tile
#pragma unroll
      for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = m0 + mi * 16 + g + 8 * half;
          if (q >= n_c) continue;
          bf16* sp = io + q * iop + n0 + 2 * t;
          const int cy = q / TW, cx = q - cy * TW;
          const bf16* c0p = hs + ((cy + 1) * hw + cx + 1) * ps + c0 + n0 + 2 * t;
          // tau and phase of the pixel (clamped inside the image: a pixel
          // outside is computed but not written)
          const size_t tq = ((size_t)min(y0 + cy, H - 1) * W + min(x0 + cx, W - 1)) * C + c0 +
                            n0 + 2 * t;
#pragma unroll
          for (int ni = 0; ni < NR; ++ni) {
            const int o = ni * 8;
            const float2 pre[4] = {unpack_bf2(ld_u32(sp + o)), unpack_bf2(ld_u32(sp + Cn + o)),
                                   unpack_bf2(ld_u32(sp + 2 * Cn + o)),
                                   unpack_bf2(ld_u32(sp + 3 * Cn + o))};
            const float2 cv = unpack_bf2(ld_u32(sp + 4 * Cn + o));
            const int e = 2 * half;
            float act[4][2], cell[2], hid[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float p0 = j ? pre[0].y : pre[0].x, p1 = j ? pre[1].y : pre[1].x;
              const float p2 = j ? pre[2].y : pre[2].x, p3 = j ? pre[3].y : pre[3].x;
              act[0][j] = lstm_sigmoid(acc[0][mi][ni][e + j] + p0);
              act[1][j] = lstm_sigmoid(acc[1][mi][ni][e + j] + p1);
              act[2][j] = lstm_sigmoid(acc[2][mi][ni][e + j] + p2);
              act[3][j] = lstm_tanh(acc[3][mi][ni][e + j] + p3);
              cell[j] = act[1][j] * (j ? cv.y : cv.x) + act[0][j] * act[3][j];
              hid[j] = act[2][j] * lstm_tanh(cell[j]);
            }
            // the outputs over this thread's own input slots (after the
            // acts where they are kept)
            if (kActs) {
#pragma unroll
              for (int k = 0; k < 4; ++k) st_u32(sp + k * Cn + o, pack_bf2(act[k][0], act[k][1]));
            }
            bf16* op = sp + kFirst * Cn + o;
            if (!kPhased) {
              st_u32(op, pack_bf2(hid[0], hid[1]));
              st_u32(op + Cn, pack_bf2(cell[0], cell[1]));
            } else {
              // h_t = cell', c_t = hidden'; h0 = c (the cell input), c0 = h
              // (the conv operand, at the tile's centre)
              const float2 cz = unpack_bf2(ld_u32(c0p + o));
              const float2 ta = __ldg(reinterpret_cast<const float2*>(a.tau + tq + o));
              const float2 ph = __ldg(reinterpret_cast<const float2*>(a.phase + tq + o));
              const float2 k = make_float2(time_gate(t_b, ta.x, ph.x, a.leak, a.ratio_on),
                                           time_gate(t_b, ta.y, ph.y, a.leak, a.ratio_on));
              st_u32(op, pack_bf2(cell[0], cell[1]));
              st_u32(op + Cn, pack_bf2(blend(k.x, cell[0], cv.x), blend(k.y, cell[1], cv.y)));
              st_u32(op + 2 * Cn, pack_bf2(blend(k.x, hid[0], cz.x), blend(k.y, hid[1], cz.y)));
            }
          }
        }
      }
    }
  }
  __syncthreads();
  // 3. the outputs (and acts) from the io tile, 16 bytes a lane
  {
    const int dims[4] = {TH, TW, kFirst + kOuts, vc};
    for (Walk<4> w(dims); w.valid(); w.next()) {
      const int cy = w.i[0], cx = w.i[1], slot = w.i[2], v = w.i[3];
      const int pix = cy * TW + cx;
      const int gy = y0 + cy, gx_ = x0 + cx;
      if (gy >= H || gx_ >= W) continue;
      const size_t px = (size_t)gy * W + gx_;
      const int k = slot - kFirst;
      bf16* out = k == 0 ? a.out[0] : k == 1 ? a.out[1] : a.out[2];
      bf16* dst = k < 0 ? a.acts + ((size_t)b * H * W + px) * C4 + slot * C + c0 + v * 8
                        : out + b * plane + px * C + c0 + v * 8;
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(io + pix * iop + slot * Cn + v * 8);
    }
  }
}

}  // namespace
