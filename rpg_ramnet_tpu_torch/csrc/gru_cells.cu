// The ConvGRU h-side cell over two scales per launch, for NVIDIA Hopper,
// sm_90a: the cross-scale pair cell (kernel K9) and the two-scale
// gx-streaming cell (kernel K10b).
//
// Replaces the Pallas TPU kernels rpg_ramnet_tpu/ops/gru_pair.py::_run_pair
// (_pair_kernel, K9) and rpg_ramnet_tpu/ops/gru_stream.py::_run_stream_pair
// (_stream_pair_kernel, K10b).  Each computes K1's cell on the first
// design's tile (gru_cell.cuh) on two scales' (h, gx):
//
//   K9    scales 0 and 1 in one launch, any batch; gx [B,H,W,3C] with
//         batch items gx_bstride elements apart (the per-step views of the
//         chunk's gx buffers need no copy);
//   K10b  batch 1; each scale's gx block read from its whole-chunk buffer
//         gx_seq [S,H,W,3C] at the step that the device int32 *sel holds
//         (K10a's indexing: one sel for both scales), so no per-step slice
//         is made and the launch arguments stay the same from step to step
//         but for h and h'.
//
// The one-scale streaming cell K10a runs K1's tile (gru_hside.cu).
//
// The TPU kernels feed the reset gate's one-row halo from side arrays,
// because a BlockSpec cannot fetch it; here the block reads those rows
// straight from the gx plane, so there are none.
//
// What bounds them on this card: as K1, the tensor cores' feed (27*C^2
// multiply-adds per pixel against 10*C bytes).  What the design does: the
// blocks of both scales form one grid, block index first over scale 0's
// tiles, then scale 1's; each block runs K1's tile code at its scale's C
// and tile, with dynamic shared memory sized for the larger of the two.
// The step index is read on the device and clamped to [0, S).

#include <algorithm>

#include "gru_cell.cuh"

namespace {

// One scale of a launch: its planes, widths, tile and gx stride (between
// batch items for K9, between steps for K10b).
struct CellArgs {
  const bf16* h;
  const bf16* gx;
  const bf16* w_ur;
  const bf16* w_o;
  bf16* out;
  int H, W, C;
  long long gx_stride;
  int TH, TW;
  int tiles_x, tiles;   // tiles along W, and per plane
};

// Block j of one scale: batch item j / tiles (K9) or the step *sel
// (K10b), tile j % tiles.
template <bool kSel>
__device__ __forceinline__ void cell_block(const CellArgs& a, int j, const int* sel,
                                           int n_steps, unsigned char* smem) {
  const int b = kSel ? 0 : j / a.tiles;
  const int tile = j - b * a.tiles;
  const long long gx_at = kSel ? (long long)min(max(__ldg(sel), 0), n_steps - 1) : b;
  const size_t plane = (size_t)a.H * a.W * a.C;
  gru_cell_tile(a.h + b * plane, a.gx + gx_at * a.gx_stride, a.w_ur, a.w_o,
                a.out + b * plane, a.H, a.W, a.C, (tile / a.tiles_x) * a.TH,
                (tile % a.tiles_x) * a.TW, a.TH, a.TW, smem);
}

template <bool kSel>
__global__ void __launch_bounds__(kThreads)
gru_cells_kernel(CellArgs a0, CellArgs a1, int B, const int* sel, int n_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = B * a0.tiles;
  if ((int)blockIdx.x < n0) {
    cell_block<kSel>(a0, blockIdx.x, sel, n_steps, smem_raw);
  } else {
    cell_block<kSel>(a1, blockIdx.x - n0, sel, n_steps, smem_raw);
  }
}

CellArgs make_args(const void* h, const void* gx, const void* w_ur, const void* w_o,
                   void* out, int H, int W, int C, long long gx_stride, int tile_h,
                   int tile_w) {
  CellArgs a;
  a.h = static_cast<const bf16*>(h);
  a.gx = static_cast<const bf16*>(gx);
  a.w_ur = static_cast<const bf16*>(w_ur);
  a.w_o = static_cast<const bf16*>(w_o);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.C = C;
  a.gx_stride = gx_stride;
  a.TH = tile_h;
  a.TW = tile_w;
  a.tiles_x = (W + tile_w - 1) / tile_w;
  a.tiles = a.tiles_x * ((H + tile_h - 1) / tile_h);
  return a;
}

// Two scales of B batch items: one block per tile per item.
template <bool kSel>
int launch(const CellArgs& a0, const CellArgs& a1, int B, const int* sel, int n_steps,
           void* stream) {
  const size_t smem =
      std::max(gru_cell_smem(a0.TH, a0.TW, a0.C), gru_cell_smem(a1.TH, a1.TW, a1.C));
  cudaError_t err = cudaFuncSetAttribute(
      gru_cells_kernel<kSel>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * (a0.tiles + a1.tiles);
  gru_cells_kernel<kSel><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      a0, a1, B, sel, n_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 on `stream`: per scale i, h_i and out_i [B,H_i,W_i,C_i] contiguous,
// gx_i [H_i,W_i,3C_i] contiguous per batch item with items gx_i_bstride
// elements apart, w_ur_i [9,2C_i,C_i] and w_o_i [9,C_i,C_i] ([tap][out]
// [in]), tile tile_h_i x tile_w_i.  All bf16, 16-byte aligned, C_i % 16 ==
// 0 (the wrapper checks).  Returns the cudaError_t of the launch.
int ramnet_gru_pair_forward(const void* h0, const void* gx0, const void* w0_ur,
                            const void* w0_o, void* out0, int H0, int W0, int C0,
                            long long gx0_bstride, int tile_h0, int tile_w0,
                            const void* h1, const void* gx1, const void* w1_ur,
                            const void* w1_o, void* out1, int H1, int W1, int C1,
                            long long gx1_bstride, int tile_h1, int tile_w1, int B,
                            void* stream) {
  return launch<false>(
      make_args(h0, gx0, w0_ur, w0_o, out0, H0, W0, C0, gx0_bstride, tile_h0, tile_w0),
      make_args(h1, gx1, w1_ur, w1_o, out1, H1, W1, C1, gx1_bstride, tile_h1, tile_w1), B,
      nullptr, 0, stream);
}

// K10b on `stream`: per scale i, h_i and out_i [1,H_i,W_i,C_i] contiguous,
// gx_i_seq [S,H_i,W_i,3C_i] contiguous, weights as K9's; sel a device int32
// (the step, clamped to [0, S)), one for both scales.
int ramnet_gru_stream_pair_forward(const void* h0, const void* gx0_seq, const void* w0_ur,
                                   const void* w0_o, void* out0, int H0, int W0, int C0,
                                   int tile_h0, int tile_w0, const void* h1,
                                   const void* gx1_seq, const void* w1_ur,
                                   const void* w1_o, void* out1, int H1, int W1, int C1,
                                   int tile_h1, int tile_w1, const void* sel, int S,
                                   void* stream) {
  return launch<true>(
      make_args(h0, gx0_seq, w0_ur, w0_o, out0, H0, W0, C0, (long long)H0 * W0 * 3 * C0,
                tile_h0, tile_w0),
      make_args(h1, gx1_seq, w1_ur, w1_o, out1, H1, W1, C1, (long long)H1 * W1 * 3 * C1,
                tile_h1, tile_w1),
      1, static_cast<const int*>(sel), S, stream);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
