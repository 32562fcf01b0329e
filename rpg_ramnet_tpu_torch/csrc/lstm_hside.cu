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
// (ops/gru_hside.py::conv_lstm_hside_bwd) reads.  All four are one kernel,
// lstm_kernel<kPhased, kActs, MR> on the tile of lstm_hside_tile.cuh (whose
// header says what bounds them and what its design does about it), under a
// plan per kernel and shape that the wrapper passes (ops/gru_hside.py::
// plan_lstm): the output tile, the blocks per tile, the warp jobs and the
// slab width.  This file holds the instances, the launch and the C entries.

#include "lstm_hside_tile.cuh"

namespace {

// A warp's job in m16 tiles (MR) per plan "combo", ops/gru_hside.py::
// LSTM_COMBOS in the same order; null for none.
template <bool kPhased, bool kActs>
void (*lstm_kernel_of(int combo))(const LstmArgs) {
  switch (combo) {
    case 0: return lstm_kernel<kPhased, kActs, 4>;
    case 1: return lstm_kernel<kPhased, kActs, 3>;
    case 2: return lstm_kernel<kPhased, kActs, 2>;
    default: return nullptr;
  }
}

// K3 (phased false) or K4, with kActs K3-res or K4-res, on the tile under a
// plan: the tile_h x tile_w output tile, `split` blocks per tile (1, 2 or
// 4, (C/16) % split == 0), the warp jobs `combo` and ks input channels per
// weight slab (16, 32 or 64, dividing C).  acts: null unless kActs.
template <bool kPhased, bool kActs>
int launch(const void* h, const void* c, const void* gx, const void* w4, const void* tau,
           const void* phase, const void* times, void* out0, void* out1, void* out2,
           void* acts, int B, int H, int W, int C, long long gx_bstride, int tile_h,
           int tile_w, int split, int combo, int ks, float leak, float ratio_on,
           void* stream) {
  void (*kern)(const LstmArgs) = lstm_kernel_of<kPhased, kActs>(combo);
  if (!kern || C % 16 || (split != 1 && split != 2 && split != 4) || (C / 16) % split ||
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
  const size_t smem = lstm_smem_bytes(tile_h, tile_w, C, split, ks, kPhased, kActs);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + tile_w - 1) / tile_w) * split, (H + tile_h - 1) / tile_h, B);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: one ConvLSTM h-side cell on `stream` under its plan (launch).  h, c,
// hid, cell: [B,H,W,C] contiguous; gx: [H,W,4C] contiguous per batch item,
// batch items gx_bstride elements apart; w4 [9,4C,C] ([tap][gate*C +
// out][in], gates in gx's order).  All bf16, all 16-byte aligned, C % 16
// == 0 (the wrapper checks).  Returns the cudaError_t of the launch.
int ramnet_lstm_hside_forward(const void* h, const void* c, const void* gx,
                              const void* w4, void* hid, void* cell, int B, int H,
                              int W, int C, long long gx_bstride, int tile_h,
                              int tile_w, int split, int combo, int ks, void* stream) {
  return launch<false, false>(h, c, gx, w4, nullptr, nullptr, nullptr, hid, cell, nullptr,
                              nullptr, B, H, W, C, gx_bstride, tile_h, tile_w, split, combo,
                              ks, 0.0f, 0.0f, stream);
}

// K3-res: K3 also writing acts [B,H,W,4C] bf16 contiguous, 16-byte
// aligned: the gate activations (i, f, o, u).  Otherwise as
// ramnet_lstm_hside_forward.
int ramnet_lstm_hside_forward_res(const void* h, const void* c, const void* gx,
                                  const void* w4, void* hid, void* cell, void* acts,
                                  int B, int H, int W, int C, long long gx_bstride,
                                  int tile_h, int tile_w, int split, int combo, int ks,
                                  void* stream) {
  return launch<false, true>(h, c, gx, w4, nullptr, nullptr, nullptr, hid, cell, nullptr,
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
                               int tile_h, int tile_w, int split, int combo, int ks,
                               float leak, float ratio_on, void* stream) {
  return launch<true, false>(c0, h0, gx, w4, tau, phase, t, h_t, h_new, c_new, nullptr, B,
                             H, W, C, gx_bstride, tile_h, tile_w, split, combo, ks, leak,
                             ratio_on, stream);
}

// K4-res: K4 also writing acts as ramnet_lstm_hside_forward_res.
// Otherwise as ramnet_lstm_phased_forward.
int ramnet_lstm_phased_forward_res(const void* c0, const void* h0, const void* gx,
                                   const void* w4, const void* tau, const void* phase,
                                   const void* t, void* h_t, void* h_new, void* c_new,
                                   void* acts, int B, int H, int W, int C,
                                   long long gx_bstride, int tile_h, int tile_w, int split,
                                   int combo, int ks, float leak, float ratio_on,
                                   void* stream) {
  return launch<true, true>(c0, h0, gx, w4, tau, phase, t, h_t, h_new, c_new, acts, B, H, W,
                            C, gx_bstride, tile_h, tile_w, split, combo, ks, leak, ratio_on,
                            stream);
}

// How many blocks of a K3 (phased 0, acts 0), K4, K3-res (acts 1) or K4-res
// plan fit on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 where the query fails.
int ramnet_lstm_blocks_per_sm(int phased, int acts, int C, int tile_h, int tile_w, int split,
                              int combo, int ks) {
  void (*kern)(const LstmArgs) =
      phased ? (acts ? lstm_kernel_of<true, true>(combo) : lstm_kernel_of<true, false>(combo))
             : (acts ? lstm_kernel_of<false, true>(combo) : lstm_kernel_of<false, false>(combo));
  if (!kern || split < 1) return -1;
  const size_t smem = lstm_smem_bytes(tile_h, tile_w, C, split, ks, phased != 0, acts != 0);
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
