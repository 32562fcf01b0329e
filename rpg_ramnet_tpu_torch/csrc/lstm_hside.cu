// Fused ConvLSTM h-side cell (kernel K3) and the phased ConvLSTM cell
// (kernel K4) for NVIDIA Hopper, sm_90a, and their residual variants for
// training (K3-res, K4-res).
//
// Replaces the Pallas TPU kernels rpg_ramnet_tpu/ops/gru_hside.py::_run_lstm
// (_lstm_kernel, K3; _lstm_kernel_res, K3-res) and
// rpg_ramnet_tpu/ops/phased_cell.py::_run_phased (_phased_kernel, K4;
// _phased_kernel_res, K4-res).  From the conv operand h [B,H,W,C], the
// cell input c [B,H,W,C] and the precomputed x-side gate pre-activations
// gx [B,H,W,4C] (in | remember | out | cell, biases folded in):
//
//     g = conv3x3(h, W4) + gx                 i, f, o = sigmoid(g_i, g_f, g_o)
//     u = tanh(g_u)                           c' = f * c + i * u
//     h' = o * tanh(c')
//
// with zero padding at the image border, f32 accumulation and bf16 I/O.  K3
// writes (h', c').  K4 is the same kernel with a compile-time flag: the
// phased cell feeds its state (c0, h0) into the LSTM's (hidden, cell) slots,
// so h = c0 and c = h0, and blends the LSTM's outputs with that state by
// the time gate k(t) of the per-feature period tau and phase [H,W,C] (f32)
// at the batch item's timestamp t:
//
//     phi = |fmod(t - phase, tau)| / tau
//     k   = 2 phi / r_on            where phi < r_on / 2
//           2 - 2 phi / r_on        where r_on / 2 <= phi < r_on
//           leak * phi              elsewhere
//     h_t = c'   c_t = h'   h_new = k h_t + (1 - k) h0   c_new = k c_t + (1 - k) c0
//
// and writes (h_t, h_new, c_new).  t - phase, the divisions and the region
// products are taken with __fsub_rn / __fdiv_rn / __fmul_rn: a contracted
// FMA there could move phi across a region boundary.
//
// The residual variants for training, K3-res and K4-res, also write acts =
// (i, f, o, u) [B,H,W,4C] in bf16, the gate activations the backward
// (ops/gru_hside.py::conv_lstm_hside_bwd) reads.  They run on their own
// tile (lstm_hside_tile.cuh, whose header says what bounds them and what
// its design does about it) under a plan the wrapper passes; K3 and K4 keep
// the first design below.
//
// What bounds K3 and K4 on this card.  Per pixel the cell must move h, c,
// gx and its outputs (16*C bytes for K3; 20*C plus 8*C of f32 tau and phase
// for K4) and do 36*C^2 multiply-adds: 4.5*C flop per byte for K3, 288 to
// 1152 at the phased widths C = 64, 128, 256, at or above the H100's bf16
// ridge (~295 flop/B).  So the conv belongs on the tensor cores, fed from shared memory.
//
// What the design does about it.  As on the TPU, nothing but the inputs and
// the outputs touches device memory (c' of K4 never leaves registers): one
// launch per cell, one block per TH x TW output tile.  There is no reset
// chain, so the block stages only h with a 1-pixel halo (0 outside the
// image: the conv's zero padding) and runs one implicit GEMM (mma.sync
// m16n8k16, ldmatrix rows from the staged tile, mma_conv.cuh) with K = 9C.
// A warp item is 32 pixels x 16 channels, and the warp accumulates all four
// gates of those channels in four accumulators (weight rows q*C + c of the
// folded [9][4C][C] weight), from one A fragment per tap and k-step: every
// gate of a (pixel, channel) lands in the same thread's registers, so the
// cell update and the time-gate blend run there.  The wrapper picks the
// tile per C (ops/gru_hside.py::smem_bytes_lstm); wgmma and TMA weight
// staging are the next steps.

#include "lstm_hside_tile.cuh"

namespace {

// acc[q] += the 3x3 conv for gate q of a 32-pixel x 16-channel warp item:
// weight rows q*C + co0 .. of w [9][4C][C] (tap, output row, input
// channel).  a_addr, row_b, pix_b as conv3x3_mma_ld; the contraction is C.
__device__ __forceinline__ void conv3x3_mma_gates(Acc (&acc)[4],
                                                  const uint32_t (&a_addr)[kMI],
                                                  int row_b, int pix_b,
                                                  const bf16* __restrict__ w, int C,
                                                  int co0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const uint32_t off = (uint32_t)(ky * row_b + kx * pix_b);
      const bf16* wt = w + ((size_t)(ky * 3 + kx) * 4 * C + co0 + g) * C + 2 * t;
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) ldmatrix_x4(a_addr[mi] + off + 2 * k0, a[mi]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni) {
            const bf16* wp = wt + ((size_t)q * C + ni * 8) * C + k0;
            const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
            const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi) mma_bf16(acc[q][mi][ni], a[mi], b0, b1);
          }
        }
      }
    }
  }
}

template <bool kPhased>
__global__ void __launch_bounds__(kThreads)
lstm_hside_kernel(const bf16* __restrict__ h, const bf16* __restrict__ c,
                  const bf16* __restrict__ gx, const bf16* __restrict__ w4,
                  const float* __restrict__ tau, const float* __restrict__ phase,
                  const float* __restrict__ times, bf16* __restrict__ out0,
                  bf16* __restrict__ out1, bf16* __restrict__ out2, int H, int W, int C,
                  long long gx_bstride, int TH, int TW, float leak,
                  float ratio_on) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ps = C + kPad;              // pixel pitch in shared memory
  const int hw = TW + 2, hh = TH + 2;   // h tile with a 1-pixel halo
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t hs_u = (uint32_t)__cvta_generic_to_shared(hs);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W * C;
  const bf16* hb = h + (size_t)b * plane;
  const bf16* cb = c + (size_t)b * plane;
  const bf16* gb = gx + (size_t)b * gx_bstride;
  const int C4 = 4 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = C / (8 * kNI);
  const float t_b = kPhased ? times[b] : 0.0f;

  // 1. h tile: image rows y0-1 .. y0+TH (and columns alike), 0 outside.
  const int n_vec = C / 8;
  for (int i = threadIdx.x; i < hh * hw * n_vec; i += kThreads) {
    const int pix = i / n_vec, v = i - pix * n_vec;
    const int py = pix / hw, px = pix - py * hw;
    const int gy = y0 - 1 + py, gx_ = x0 - 1 + px;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx_ >= 0 && gx_ < W) {
      val = __ldg(reinterpret_cast<const uint4*>(hb + ((size_t)gy * W + gx_) * C + v * 8));
    }
    *reinterpret_cast<uint4*>(hs + pix * ps + v * 8) = val;
  }
  __syncthreads();

  // 2. The four gates, the cell update (and the time-gate blend) for the
  //    TH x TW tile: output pixel (cy, cx) is image (y0+cy, x0+cx); its
  //    taps start at h-tile pixel (cy, cx).
  const int n_c = TH * TW;
  const int items = ((n_c + 16 * kMI - 1) / (16 * kMI)) * n_groups;
  for (int item = warp; item < items; item += kWarps) {
    const int m0 = (item / n_groups) * 16 * kMI;
    const int co0 = (item % n_groups) * 8 * kNI;
    uint32_t a_addr[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
      const int cy = q / TW, cx = q - cy * TW;
      a_addr[mi] = hs_u + 2 * ((cy * hw + cx) * ps + (lane >> 4) * 8);
    }
    Acc acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) zero(acc[q]);
    conv3x3_mma_gates(acc, a_addr, 2 * hw * ps, 2 * ps, w4, C, co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + g + 8 * half;
        if (q >= n_c) continue;
        const int cy = q / TW, cx = q - cy * TW;
        const int gy = y0 + cy, gx_ = x0 + cx;
        if (gy >= H || gx_ >= W) continue;
        const size_t pix = (size_t)gy * W + gx_;
        const bf16* gp = gb + pix * C4;
        const size_t o = (size_t)b * plane + pix * C;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          const float2 gi = ld_bf2(gp + ch);
          const float2 gf = ld_bf2(gp + C + ch);
          const float2 go = ld_bf2(gp + 2 * C + ch);
          const float2 gu = ld_bf2(gp + 3 * C + ch);
          const float2 cv = ld_bf2(cb + pix * C + ch);
          const int e = 2 * half;
          float cell[2], hid[2];
          const float pre[4][2] = {{gi.x, gi.y}, {gf.x, gf.y}, {go.x, go.y}, {gu.x, gu.y}};
          const float cin[2] = {cv.x, cv.y};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float ig = sigmoid_f(acc[0][mi][ni][e + j] + pre[0][j]);
            const float fg = sigmoid_f(acc[1][mi][ni][e + j] + pre[1][j]);
            const float og = sigmoid_f(acc[2][mi][ni][e + j] + pre[2][j]);
            const float ug = tanhf(acc[3][mi][ni][e + j] + pre[3][j]);
            cell[j] = fg * cin[j] + ig * ug;
            hid[j] = og * tanhf(cell[j]);
          }
          if (!kPhased) {
            st_bf2(out0 + o + ch, hid[0], hid[1]);
            st_bf2(out1 + o + ch, cell[0], cell[1]);
          } else {
            // h_t = cell', c_t = hidden'; h0 = c (the cell input), c0 = h
            // (the conv operand, at the tile's centre in shared memory)
            const float2 c0 = ld_bf2(hs + ((cy + 1) * hw + cx + 1) * ps + ch);
            const float2 ta = *reinterpret_cast<const float2*>(tau + pix * C + ch);
            const float2 ph = *reinterpret_cast<const float2*>(phase + pix * C + ch);
            const float k0 = time_gate(t_b, ta.x, ph.x, leak, ratio_on);
            const float k1 = time_gate(t_b, ta.y, ph.y, leak, ratio_on);
            st_bf2(out0 + o + ch, cell[0], cell[1]);
            st_bf2(out1 + o + ch, blend(k0, cell[0], cin[0]), blend(k1, cell[1], cin[1]));
            st_bf2(out2 + o + ch, blend(k0, hid[0], c0.x), blend(k1, hid[1], c0.y));
          }
        }
      }
    }
  }
}

template <bool kPhased>
int launch(const void* h, const void* c, const void* gx, const void* w4,
           const void* tau, const void* phase, const void* times, void* out0,
           void* out1, void* out2, int B, int H, int W, int C, long long gx_bstride,
           int tile_h, int tile_w, float leak, float ratio_on, void* stream) {
  // the h tile with its 1-pixel halo (ops/gru_hside.py::smem_bytes_lstm)
  const size_t smem = (size_t)(tile_h + 2) * (tile_w + 2) * (size_t)(C + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_hside_kernel<kPhased>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  lstm_hside_kernel<kPhased><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(c),
      static_cast<const bf16*>(gx), static_cast<const bf16*>(w4),
      static_cast<const float*>(tau), static_cast<const float*>(phase),
      static_cast<const float*>(times), static_cast<bf16*>(out0),
      static_cast<bf16*>(out1), static_cast<bf16*>(out2), H, W, C, gx_bstride, tile_h,
      tile_w, leak, ratio_on);
  return (int)cudaGetLastError();
}

// A warp's job in m16 tiles (MR) per plan "combo", ops/gru_hside.py::
// LSTM_COMBOS in the same order; null for none.
template <bool kPhased>
void (*lstm_kernel_of(int combo))(const LstmArgs) {
  switch (combo) {
    case 0: return lstm_kernel<kPhased, 4>;
    case 1: return lstm_kernel<kPhased, 3>;
    case 2: return lstm_kernel<kPhased, 2>;
    default: return nullptr;
  }
}

// K3-res (phased false) or K4-res on the tile under a plan: the tile_h x
// tile_w output tile, `split` blocks per tile (1 or 2, (C/16) % split ==
// 0), the warp jobs `combo` and ks input channels per weight slab (16, 32
// or 64, dividing C).
template <bool kPhased>
int launch_res(const void* h, const void* c, const void* gx, const void* w4,
               const void* tau, const void* phase, const void* times, void* out0,
               void* out1, void* out2, void* acts, int B, int H, int W, int C,
               long long gx_bstride, int tile_h, int tile_w, int split, int combo, int ks,
               float leak, float ratio_on, void* stream) {
  void (*kern)(const LstmArgs) = lstm_kernel_of<kPhased>(combo);
  if (!kern || C % 16 || (split != 1 && split != 2) || (C / 16) % split ||
      (ks != 16 && ks != 32 && ks != 64) || C % ks || tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  LstmArgs a;
  a.h = static_cast<const bf16*>(h);
  a.c = static_cast<const bf16*>(c);
  a.gx = static_cast<const bf16*>(gx);
  a.w4 = static_cast<const bf16*>(w4);
  a.tau = static_cast<const float*>(tau);
  a.phase = static_cast<const float*>(phase);
  a.times = static_cast<const float*>(times);
  a.out[0] = static_cast<bf16*>(out0);
  a.out[1] = static_cast<bf16*>(out1);
  a.out[2] = static_cast<bf16*>(out2);
  a.acts = static_cast<bf16*>(acts);
  a.H = H;
  a.W = W;
  a.C = C;
  a.gx_bstride = gx_bstride;
  a.TH = tile_h;
  a.TW = tile_w;
  a.split = split;
  a.ks = ks;
  a.leak = leak;
  a.ratio_on = ratio_on;
  const size_t smem = lstm_smem_bytes(tile_h, tile_w, C, split, ks, kPhased);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + tile_w - 1) / tile_w) * split, (H + tile_h - 1) / tile_h, B);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: one ConvLSTM h-side cell on `stream`.  h, c, hid, cell: [B,H,W,C]
// contiguous; gx: [H,W,4C] contiguous per batch item, batch items
// gx_bstride elements apart; w4 [9,4C,C] ([tap][gate*C + out][in], gates in
// gx's order).  All bf16, all 16-byte aligned, C % 16 == 0 (the wrapper
// checks).  Returns the cudaError_t of the launch.
int ramnet_lstm_hside_forward(const void* h, const void* c, const void* gx,
                              const void* w4, void* hid, void* cell, int B, int H,
                              int W, int C, long long gx_bstride, int tile_h,
                              int tile_w, void* stream) {
  return launch<false>(h, c, gx, w4, nullptr, nullptr, nullptr, hid, cell, nullptr, B, H,
                       W, C, gx_bstride, tile_h, tile_w, 0.0f, 0.0f, stream);
}

// K3-res: the cell on the tile (lstm_hside_tile.cuh), also writing acts
// [B,H,W,4C] bf16 contiguous, 16-byte aligned: the gate activations (i, f,
// o, u).  The plan: tile_h x tile_w output tile, split, combo, ks
// (launch_res).  Otherwise as ramnet_lstm_hside_forward.
int ramnet_lstm_hside_forward_res(const void* h, const void* c, const void* gx,
                                  const void* w4, void* hid, void* cell, void* acts,
                                  int B, int H, int W, int C, long long gx_bstride,
                                  int tile_h, int tile_w, int split, int combo, int ks,
                                  void* stream) {
  return launch_res<false>(h, c, gx, w4, nullptr, nullptr, nullptr, hid, cell, nullptr,
                           acts, B, H, W, C, gx_bstride, tile_h, tile_w, split, combo, ks,
                           0.0f, 0.0f, stream);
}

// K4: one phased ConvLSTM cell from the state (c0, h0): c0 is the conv
// operand, h0 the LSTM's cell input.  tau, phase: [H,W,C] float32
// contiguous; t: [B] float32; outputs h_t, h_new, c_new [B,H,W,C] bf16.
// Otherwise as ramnet_lstm_hside_forward.
int ramnet_lstm_phased_forward(const void* c0, const void* h0, const void* gx,
                               const void* w4, const void* tau, const void* phase,
                               const void* t, void* h_t, void* h_new, void* c_new,
                               int B, int H, int W, int C, long long gx_bstride,
                               int tile_h, int tile_w, float leak, float ratio_on,
                               void* stream) {
  return launch<true>(c0, h0, gx, w4, tau, phase, t, h_t, h_new, c_new, B, H, W, C,
                      gx_bstride, tile_h, tile_w, leak, ratio_on, stream);
}

// K4-res: the phased cell on the tile, also writing acts as
// ramnet_lstm_hside_forward_res, under its plan.  Otherwise as
// ramnet_lstm_phased_forward.
int ramnet_lstm_phased_forward_res(const void* c0, const void* h0, const void* gx,
                                   const void* w4, const void* tau, const void* phase,
                                   const void* t, void* h_t, void* h_new, void* c_new,
                                   void* acts, int B, int H, int W, int C,
                                   long long gx_bstride, int tile_h, int tile_w, int split,
                                   int combo, int ks, float leak, float ratio_on,
                                   void* stream) {
  return launch_res<true>(c0, h0, gx, w4, tau, phase, t, h_t, h_new, c_new, acts, B, H, W,
                          C, gx_bstride, tile_h, tile_w, split, combo, ks, leak, ratio_on,
                          stream);
}

// How many blocks of a K3-res (phased 0) or K4-res plan fit on one SM at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 where the
// query fails.
int ramnet_lstm_blocks_per_sm(int phased, int C, int tile_h, int tile_w, int split, int combo,
                              int ks) {
  void (*kern)(const LstmArgs) =
      phased ? lstm_kernel_of<true>(combo) : lstm_kernel_of<false>(combo);
  if (!kern || split < 1) return -1;
  const size_t smem = lstm_smem_bytes(tile_h, tile_w, C, split, ks, phased != 0);
  int n = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
