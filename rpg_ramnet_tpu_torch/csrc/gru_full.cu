// The whole ConvGRU cell (kernel K5) for NVIDIA Hopper, sm_90a: the
// per-package streaming path, where no precomputed x-side gates exist.
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_hside.py::_run_full
// with _full_kernel (entry point conv_gru_full_fused).  From the encoder
// output x [B,H,W,C] and the state h [B,H,W,C] (the encoder width equals
// the hidden width on every RAM-Net scale), with the gate weights on
// cat(x, h) and float32 biases:
//
//     z = sigmoid(conv3x3([x|h], Wz) + bz)    r = sigmoid(conv3x3([x|h], Wr) + br)
//     a = bf16(r * h)                          o = tanh(conv3x3([x|a], Wo) + bo)
//     h' = h * (1 - z) + o * z
//
// with zero padding at the image border, f32 accumulation and gates, bf16
// I/O.  The x half of the out gate's operand is x itself, not r * x.  One
// launch per cell, one block (or cluster of two) per output tile, nothing
// but x, h and h' in device memory; the TPU kernel recomputes its row halo
// the same way (gru_hside.py:751-773), blocks here exchange nothing outside
// a cluster.  What bounds it on this card and what the design does about
// it: the header of gru_full_tile.cuh.

#include "gru_full_tile.cuh"

namespace {

// A warp's jobs (phase r: MR x NR m16 x n8 tiles; phase z/o: MC x NC) per
// plan "combo", ops/gru_hside.py::K5_COMBOS in the same order; null for
// none.
void (*k5_kernel_of(int combo))(const K5Args) {
  switch (combo) {
    case 0: return k5_kernel<6, 4, 4, 4>;
    case 1: return k5_kernel<4, 4, 2, 4>;
    case 2: return k5_kernel<2, 4, 2, 2>;
    case 3: return k5_kernel<3, 4, 1, 4>;
    default: return nullptr;
  }
}

// Whether K5 can run the plan at width C (ops/gru_hside.py::check_k5_plan).
bool k5_plan_ok(int C, int tile_h, int tile_w, int split, int combo, int ks) {
  return C % 16 == 0 && (split == 1 || split == 2) && (C / 16) % split == 0 &&
         (ks == 16 || ks == 32 || ks == 64) && C % ks == 0 && tile_h >= 1 && tile_w >= 1 &&
         k5_kernel_of(combo) != nullptr && k5_smem_bytes(tile_h, tile_w, C, split, ks) <= kSmemMax;
}

}  // namespace

extern "C" {

// Launches one cell on `stream`.  x, h, out: [B,H,W,C] contiguous bf16;
// w_ur [9,2C,2C] (update rows, then reset rows; x columns, then h
// columns), w_o [9,C,2C], each [tap][out][in] bf16; b_ur [2C], b_o [C]
// float32.  All 16-byte aligned.  The plan: the tile_h x tile_w output
// tile, `split` blocks per cluster (1 or 2, (C/16) % split == 0), the warp
// jobs `combo` and ks input channels per weight slab (16, 32 or 64,
// dividing C); a plan over the shared memory of a block, or that breaks
// these, returns cudaErrorInvalidValue without a launch.  Returns the
// cudaError_t of the launch (cudaGetLastError's after it).
int ramnet_gru_full_forward(const void* x, const void* h, const void* w_ur,
                            const void* w_o, const void* b_ur, const void* b_o,
                            void* out, int B, int H, int W, int C, int tile_h,
                            int tile_w, int split, int combo, int ks,
                            void* stream) {
  if (!k5_plan_ok(C, tile_h, tile_w, split, combo, ks)) return (int)cudaErrorInvalidValue;
  K5Args a;
  a.x = static_cast<const bf16*>(x);
  a.h = static_cast<const bf16*>(h);
  a.w_ur = static_cast<const bf16*>(w_ur);
  a.w_o = static_cast<const bf16*>(w_o);
  a.b_ur = static_cast<const float*>(b_ur);
  a.b_o = static_cast<const float*>(b_o);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.C = C;
  a.TH = tile_h;
  a.TW = tile_w;
  a.split = split;
  a.ks = ks;
  void (*kern)(const K5Args) = k5_kernel_of(combo);
  const size_t smem = k5_smem_bytes(tile_h, tile_w, C, split, ks);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + tile_w - 1) / tile_w) * split, (H + tile_h - 1) / tile_h, B);
  ClusterLaunch c(grid, smem, split, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&c.cfg, kern, a);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
