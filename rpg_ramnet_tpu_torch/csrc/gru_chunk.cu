// The whole-chunk resident-state ConvGRU h-side cell (kernel K11) for
// NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_chunk.py::_run_chunk
// (_kernel).  It runs all S = L*(K+1) sequential h-side steps of one scale
// of a chunk in one launch: step s computes K1's cell (gru_cell.cuh) from
// h = snaps[s-1] (h0 at s = 0) and gx_steps[s], with the events weights
// where s % (K+1) < K and the image weights on each package's last step,
// and writes snaps[s].  snaps [S,H,W,C] is the trajectory the decoder
// reads; snaps[S-1] is the final state.
//
// What bounds it on this card: S of K1's cells, each bound by the tensor
// cores' feed (27*C^2 multiply-adds per pixel); what one launch can save
// is the S-1 launches and their gaps.  The TPU keeps h in VMEM across its
// sequential grid.  Here the blocks run in parallel, so the design is a
// persistent cooperative kernel: the grid is at most the blocks that can
// be resident at once (the occupancy at this tile's shared memory times
// the SMs), each block loops over the tiles, and a grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates the steps.  h lives
// in the snapshot plane, which is an output anyway and stays in the 50 MB
// L2 between steps (4 MB at the flagship scale 0).  L1 is not coherent
// across SMs, so h is read with ld.global.cg (the cell's kCoherent flag);
// gx and the weights are never written in the launch.

#include <algorithm>
#include <cooperative_groups.h>

#include "gru_cell.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(kThreads)
gru_chunk_kernel(const bf16* __restrict__ h0, const bf16* __restrict__ gx,
                 const bf16* __restrict__ w_ur2, const bf16* __restrict__ w_o2,
                 bf16* __restrict__ snaps, int S, int K, int H, int W, int C, int TH,
                 int TW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  const size_t plane = (size_t)H * W * C;
  for (int s = 0; s < S; ++s) {
    const bf16* h = s == 0 ? h0 : snaps + (s - 1) * plane;
    const int image = s % (K + 1) == K;
    const bf16* w_ur = w_ur2 + (size_t)image * 9 * 2 * C * C;
    const bf16* w_o = w_o2 + (size_t)image * 9 * C * C;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      gru_cell_tile<false, true>(h, gx + 3 * s * plane, w_ur, w_o, snaps + s * plane,
                                 nullptr, H, W, C, (tile / tiles_x) * TH,
                                 (tile % tiles_x) * TW, TH, TW, smem_raw);
      __syncthreads();
    }
    if (s + 1 < S) grid.sync();
  }
}

}  // namespace

extern "C" {

// K11 on `stream` as a cooperative launch: h0 [1,H,W,C] and snaps [S,H,W,C]
// contiguous, gx [S,H,W,3C] contiguous in step order, w_ur2 [2,9,2C,C] and
// w_o2 [2,9,C,C] (events, then image; [tap][out][in]), tile tile_h x
// tile_w.  All bf16, 16-byte aligned, C % 16 == 0 (the wrapper checks).
// blocks: the grid, or 0 for the tiles capped at the blocks that can be
// resident at once; a grid larger than that fails the launch
// (cudaErrorCooperativeLaunchTooLarge).  *grid_out: the grid launched.
// Returns the cudaError_t of the launch.
int ramnet_gru_chunk_forward(const void* h0, const void* gx, const void* w_ur2,
                             const void* w_o2, void* snaps, int S, int K, int H, int W,
                             int C, int tile_h, int tile_w, int blocks, int* grid_out,
                             void* stream) {
  const size_t smem = gru_cell_smem(tile_h, tile_w, C);
  cudaError_t err = cudaFuncSetAttribute(
      gru_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_chunk_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int tiles = ((W + tile_w - 1) / tile_w) * ((H + tile_h - 1) / tile_h);
  int grid = blocks > 0 ? blocks : std::min(tiles, per_sm * sms);
  if (grid < 1) grid = 1;
  *grid_out = grid;
  const bf16* h0_p = static_cast<const bf16*>(h0);
  const bf16* gx_p = static_cast<const bf16*>(gx);
  const bf16* w_ur_p = static_cast<const bf16*>(w_ur2);
  const bf16* w_o_p = static_cast<const bf16*>(w_o2);
  bf16* snaps_p = static_cast<bf16*>(snaps);
  void* args[] = {&h0_p, &gx_p, &w_ur_p, &w_o_p, &snaps_p, &S, &K, &H, &W, &C,
                  &tile_h, &tile_w};
  err = cudaLaunchCooperativeKernel((const void*)gru_chunk_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, (cudaStream_t)stream);
  cudaGetLastError();   // clear the launch's error state, returned here
  return (int)err;
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
