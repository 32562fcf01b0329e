// Fused ConvGRU h-side cell (kernel K1) for NVIDIA Hopper, sm_90a, and its
// residual variant for training (K1-res).
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_hside.py::_run with
// _kernel (K1) and _kernel_res (K1-res).  From the state h [B,H,W,C] and the
// precomputed x-side gate pre-activations gx [B,H,W,3C] (update | reset |
// out, biases folded in):
//
//     z = sigmoid(conv3x3(h, Wz) + gx_z)      r = sigmoid(conv3x3(h, Wr) + gx_r)
//     a = bf16(r * h)                          o = tanh(conv3x3(a, Wo) + gx_o)
//     h' = h * (1 - z) + o * z
//
// with zero padding at the image border, f32 accumulation and bf16 I/O.
// K1-res also stores acts = bf16(concat(z, r, o)) [B,H,W,3C] at the tile's
// own pixels: the gate activations the backward (K2, gru_hside_bwd.cu)
// reads instead of recomputing the forward.  It is the same kernel with a
// compile-time flag.
//
// What bounds it on this card.  Per pixel the cell must move h, gx and h'
// (10*C bytes; 16*C with acts) and do 27*C^2 multiply-adds: 5.4*C flop per
// byte, 346 to 1382 at the flagship widths C = 64, 128, 256, above the
// H100's bf16 tensor-core ridge (~295 flop/B).  So the convs belong on the
// tensor cores, and the cell is bound by how well they are fed: the
// operand loads from shared memory (h, a) and from L1/L2 (the weights).
//
// What the design does about it.  As on the TPU, nothing but h, gx, h' (and
// acts) touches device memory: one launch per cell, one block per TH x TW
// output tile, whose device code (gru_cell.cuh) the launch variants K9,
// K10a, K10b (gru_cells.cu) and K11 (gru_chunk.cu) share.  The block
// stages h with a 2-pixel halo in shared memory, keeps a = bf16(r*h) on
// the tile plus a 1-pixel ring there, and runs each 3x3 conv as an
// implicit GEMM on the tensor cores (mma_conv.cuh).  wgmma and TMA are the
// next steps.  The wrapper picks the tile per C (ops/gru_hside.py).

#include "gru_cell.cuh"

namespace {

// One block per TH x TW output tile of one batch item (blockIdx.z).
template <bool kRes>
__global__ void __launch_bounds__(kThreads)
gru_hside_kernel(const bf16* __restrict__ h, const bf16* __restrict__ gx,
                 const bf16* __restrict__ w_ur, const bf16* __restrict__ w_o,
                 bf16* __restrict__ out, bf16* __restrict__ acts, int H, int W,
                 int C, long long gx_bstride, int TH, int TW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z;
  const size_t plane = (size_t)H * W * C;
  gru_cell_tile<kRes, false>(h + b * plane, gx + (size_t)b * gx_bstride, w_ur, w_o,
                             out + b * plane, kRes ? acts + 3 * b * plane : nullptr,
                             H, W, C, blockIdx.y * TH, blockIdx.x * TW, TH, TW,
                             smem_raw);
}

template <bool kRes>
int launch(const void* h, const void* gx, const void* w_ur, const void* w_o,
           void* out, void* acts, int B, int H, int W, int C,
           long long gx_bstride, int tile_h, int tile_w, void* stream) {
  const size_t smem = gru_cell_smem(tile_h, tile_w, C);
  cudaError_t err = cudaFuncSetAttribute(
      gru_hside_kernel<kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  gru_hside_kernel<kRes><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(gx),
      static_cast<const bf16*>(w_ur), static_cast<const bf16*>(w_o),
      static_cast<bf16*>(out), static_cast<bf16*>(acts), H, W, C, gx_bstride,
      tile_h, tile_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one cell on `stream`.  h, out: [B,H,W,C] contiguous; gx: [H,W,3C]
// contiguous per batch item, batch items gx_bstride elements apart;
// w_ur [9,2C,C] (update rows, then reset rows), w_o [9,C,C], each
// [tap][out][in].  All bf16, all 16-byte aligned, C % 16 == 0 (the
// wrapper checks).  Returns the cudaError_t of the launch.
int ramnet_gru_hside_forward(const void* h, const void* gx, const void* w_ur,
                             const void* w_o, void* out, int B, int H, int W,
                             int C, long long gx_bstride, int tile_h,
                             int tile_w, void* stream) {
  return launch<false>(h, gx, w_ur, w_o, out, nullptr, B, H, W, C, gx_bstride,
                       tile_h, tile_w, stream);
}

// The same cell, also writing acts [B,H,W,3C] = bf16(concat(z, r, o)),
// contiguous.
int ramnet_gru_hside_forward_res(const void* h, const void* gx, const void* w_ur,
                                 const void* w_o, void* out, void* acts, int B,
                                 int H, int W, int C, long long gx_bstride,
                                 int tile_h, int tile_w, void* stream) {
  return launch<true>(h, gx, w_ur, w_o, out, acts, B, H, W, C, gx_bstride,
                      tile_h, tile_w, stream);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
