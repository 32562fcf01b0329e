// Backward of the fused ConvGRU h-side cell (kernel K2) for NVIDIA Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_hside.py::_run_bwd
// with _bwd_kernel.  From the cotangent g of h' [B,H,W,C], the state h
// [B,H,W,C] and the forward's gate activations acts = (z, r, o) [B,H,W,3C]
// (K1-res, gru_hside.cu), it computes the state and x-gate cotangents:
//
//     dpre_o = g * z * (1 - o^2)
//     da     = convT3x3(bf16(dpre_o), Wo)            (the cotangent of a = r*h)
//     dpre_r = da * h * r * (1 - r)
//     dpre_z = g * (o - h) * z * (1 - z)
//     dh     = g * (1 - z) + da * r + convT3x3(bf16([dpre_z | dpre_r]), Wur)
//     dgx    = bf16([dpre_z | dpre_r | dpre_o])
//
// convT is the cotangent of a 3x3 'same' conv with zero padding: a
// correlation with the spatially flipped, in/out-swapped weights, which the
// kernel reads from the forward's own layout (tap 8 - t, B fragments by
// ldmatrix.trans).  f32 accumulation, bf16 I/O.  The weight gradients are
// library convolutions in the wrapper (as the JAX package leaves _dconv_w
// to XLA).  What bounds it on this card and what the design does about it:
// the header of gru_hside_bwd_tile.cuh.

#include "gru_hside_bwd_tile.cuh"

namespace {

// A warp's jobs (phase da: MR x NR m16 x n8 tiles; phase dh: MC x NC) per
// plan "combo", ops/gru_hside.py::K2_COMBOS in the same order; null for
// none.
void (*k2_kernel_of(int combo))(const K2Args) {
  switch (combo) {
    case 0: return k2_kernel<4, 4, 2, 8>;
    case 1: return k2_kernel<3, 4, 2, 4>;
    case 2: return k2_kernel<2, 4, 1, 4>;
    default: return nullptr;
  }
}

// Whether K2 can run the plan at width C (ops/gru_hside.py::check_k2_plan).
bool k2_plan_ok(int C, int tile_h, int tile_w, int combo, int ks) {
  return C % 16 == 0 && (ks == 16 || ks == 32 || ks == 64) && C % ks == 0 && tile_h >= 1 &&
         tile_w >= 1 && k2_kernel_of(combo) != nullptr &&
         k2_smem_bytes(tile_h, tile_w, C, ks) <= kSmemMax;
}

}  // namespace

extern "C" {

// Launches one cell's backward on `stream`.  g, h, dh: [B,H,W,C]; acts,
// dgx: [B,H,W,3C]; w_ur [9,2C,C] (update rows, then reset rows), w_o
// [9,C,C], each [tap][out][in] as the forward reads them.  All bf16,
// contiguous, 16-byte aligned.  The plan: the tile_h x tile_w output tile,
// the warp jobs `combo` and ks contraction rows per weight slab (16, 32 or
// 64, dividing C); a plan over the shared memory of a block, or that
// breaks these, returns cudaErrorInvalidValue without a launch.  Returns
// the cudaError_t of the launch (cudaGetLastError's after it).
int ramnet_gru_hside_backward(const void* g, const void* h, const void* acts,
                              const void* w_ur, const void* w_o, void* dh,
                              void* dgx, int B, int H, int W, int C, int tile_h,
                              int tile_w, int combo, int ks, void* stream) {
  if (!k2_plan_ok(C, tile_h, tile_w, combo, ks)) return (int)cudaErrorInvalidValue;
  K2Args a;
  a.g = static_cast<const bf16*>(g);
  a.h = static_cast<const bf16*>(h);
  a.acts = static_cast<const bf16*>(acts);
  a.w_ur = static_cast<const bf16*>(w_ur);
  a.w_o = static_cast<const bf16*>(w_o);
  a.dh = static_cast<bf16*>(dh);
  a.dgx = static_cast<bf16*>(dgx);
  a.H = H;
  a.W = W;
  a.C = C;
  a.TH = tile_h;
  a.TW = tile_w;
  a.ks = ks;
  void (*kern)(const K2Args) = k2_kernel_of(combo);
  const size_t smem = k2_smem_bytes(tile_h, tile_w, C, ks);
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
