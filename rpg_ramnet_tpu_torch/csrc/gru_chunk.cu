// The whole-chunk resident-state ConvGRU h-side cell (kernel K11) for
// NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_chunk.py::_run_chunk
// (_kernel).  It runs all S = L*(K+1) sequential h-side steps of one scale
// of a chunk in one launch: step s computes K1's cell from h = snaps[s-1]
// (h0 at s = 0) and gx_steps[s], with the events weights where s % (K+1) <
// K and the image weights on each package's last step, and writes
// snaps[s].  snaps [S,H,W,C] is the trajectory the decoder reads;
// snaps[S-1] is the final state.
//
// What bounds it on this card: S of K1's cells, each bound by the tensor
// cores' feed (27*C^2 multiply-adds per pixel); what one launch can save
// over S launches of K1 is their gaps.  The TPU keeps h in VMEM across its
// sequential grid.  Here the blocks run in parallel, so the design is a
// persistent cooperative kernel on K1's tile (gru_hside_tile.cuh) under a
// K1 plan: each block, or cluster of `split` blocks sharing a pixel tile,
// takes tile = its cluster index (and, where the grid holds fewer clusters
// than tiles, every clusters-th tile after it), runs the tile body on it,
// and a grid-wide barrier (cooperative_groups::this_grid().sync())
// separates the steps.  ops/gru_chunk.py plans the grid: the planner's K1
// plan where its clusters all fit on the card at once, so each block keeps
// one tile for all S steps and streams its weight rows once per step, on
// the warp jobs whose K11 instance keeps its registers (combos 1 and 2,
// kernel_of below).
//
// h lives in the snapshot plane, which is an output anyway and stays in
// the 50 MB L2 between steps (4 MB at the flagship scale 0).  L1 is not
// coherent across SMs: the tile reads h only by cp.async.cg (L2), and the
// grid barrier orders the previous step's st.global outputs before it;
// gx and the weights are never written in the launch.

#include "gru_hside_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// K11's arguments: K1's (a.h: h0; a.out: snaps; a.gx: gx_steps, steps
// a.gx_bstride apart; a.w_ur [2,9,2C,C] and a.w_o [2,9,C,C]: the events,
// then the image weights, w_ur_at and w_o_at elements on), and the walk: S
// steps of K events steps and one image step per package, each step
// `plane` elements of snaps, `tiles` tiles of a plane (tiles_x along W),
// `clusters` clusters in the grid.
struct K11Args {
  K1Args a;
  long long plane, w_ur_at, w_o_at;
  int S, K, tiles_x, tiles, clusters;
};

// Where a block of K11 runs the tile body: the tile's origin and the
// block's rank; h, gx, h' and the weights come in the K1Args of the tile's
// step.
struct ChunkTile {
  int y0_, x0_, rank_;
  __device__ int rank(const K1Args&) const { return rank_; }
  __device__ int y0(const K1Args&) const { return y0_; }
  __device__ int x0(const K1Args&) const { return x0_; }
  __device__ const bf16* h(const K1Args& a) const { return a.h; }
  __device__ const bf16* gx(const K1Args& a) const { return a.gx; }
  __device__ bf16* out(const K1Args& a) const { return a.out; }
  __device__ bf16* acts(const K1Args&) const { return nullptr; }
};

// Grid: clusters * split blocks, 1-D; block x is rank x % split of cluster
// x / split, which takes tile x / split of each step and every
// clusters-th tile after it.  The block's first thread writes the tile's
// K1Args and ChunkTile into shared memory before each body; the block's
// walk (its step and tile) lives there too and is read after barriers, so
// that no register holds it across the body.
template <int MR, int NR, int MC, int NC>
__global__ void __launch_bounds__(kThreads, 1) k11_kernel(const K11Args p) {
  __shared__ K1Args a;
  __shared__ ChunkTile at;
  __shared__ int walk[3];   // step, tile, and 1 where the last tile ended a step
  if (threadIdx.x == 0) {
    walk[0] = 0;
    walk[1] = blockIdx.x / p.a.split;
  }
  __syncthreads();
  for (;;) {
    const int s = walk[0], t = walk[1];
    if (s >= p.S) break;
    if (t < p.tiles && threadIdx.x == 0) {
      const int ty = t / p.tiles_x;
      const bool image = s % (p.K + 1) == p.K;
      a = p.a;
      a.h = s == 0 ? p.a.h : p.a.out + (s - 1) * p.plane;
      a.gx = p.a.gx + s * p.a.gx_bstride;
      a.out = p.a.out + s * p.plane;
      a.w_ur = p.a.w_ur + (image ? p.w_ur_at : 0);
      a.w_o = p.a.w_o + (image ? p.w_o_at : 0);
      at = {ty * p.a.TH, (t - ty * p.tiles_x) * p.a.TW, (int)blockIdx.x % p.a.split};
    }
    __syncthreads();   // the tile's arguments are written, and every thread has read walk
    if (t < p.tiles) k1_tile<false, MR, NR, MC, NC>(a, at);
    if (threadIdx.x == 0) {   // the next tile of this step, or the first of the next
      const int next = walk[1] + p.clusters;
      walk[2] = next >= p.tiles;
      walk[0] += walk[2];
      walk[1] = walk[2] ? (int)blockIdx.x / p.a.split : next;
    }
    __syncthreads();   // the body's last stores read the gx tile the next fills
    if (walk[2] && walk[0] < p.S) cg::this_grid().sync();
  }
}

typedef void (*K11Kernel)(const K11Args);

// The warp jobs per plan combo, ops/gru_hside.py::K1_COMBOS's order.
// Combo 0 (6, 4, 4, 4) is not built: K1's instance of it takes 240 of the
// 255 registers, and inside K11's walk the compiler holds more (ptxas:
// about 1 KB spilled), so ops/gru_chunk.py plans K11 on combos 1 and 2.
K11Kernel kernel_of(int combo) {
  switch (combo) {
    case 1: return k11_kernel<3, 4, 2, 4>;
    case 2: return k11_kernel<2, 4, 2, 2>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// How many clusters of `split` blocks of K11 under the plan (tile_h,
// tile_w, split, combo, ks) fit on the current device at once
// (cudaOccupancyMaxActiveClusters of K11's own kernel instance; a cluster
// of 1 is one block), or -1 where the plan is not one the tile runs or the
// query fails.
int ramnet_gru_chunk_max_active_clusters(int C, int tile_h, int tile_w, int split, int combo,
                                         int ks) {
  const K11Kernel kern = kernel_of(combo);
  if (!kern || !k1_plan_ok(C, tile_h, tile_w, split, ks)) return -1;
  return max_active_clusters(kern, k1_smem_bytes(tile_h, tile_w, C, split, ks, false), split);
}

// K11 on `stream` as a cooperative launch of `blocks` blocks in clusters of
// `split`: h0 [1,H,W,C] and snaps [S,H,W,C] contiguous, gx [S,H,W,3C]
// contiguous in step order, w_ur2 [2,9,2C,C] and w_o2 [2,9,C,C] (events,
// then image; [tap][out][in]); the K1 plan (tile_h, tile_w, split, combo,
// ks).  All bf16, 16-byte aligned.  blocks: a positive multiple of split;
// more clusters than fit on the device at once fail the launch
// (cudaErrorCooperativeLaunchTooLarge).  Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for a plan or grid the kernel cannot run
// or whose occupancy the device does not report.
int ramnet_gru_chunk_forward(const void* h0, const void* gx, const void* w_ur2,
                             const void* w_o2, void* snaps, int S, int K, int H, int W,
                             int C, int tile_h, int tile_w, int split, int combo, int ks,
                             int blocks, void* stream) {
  K11Args p = {};
  K1Args& a = p.a;
  const K11Kernel kern = kernel_of(combo);
  if (!kern || !make_k1_args(a, h0, gx, w_ur2, w_o2, snaps, nullptr, H, W, C,
                             (long long)H * W * 3 * C, tile_h, tile_w, split, ks) ||
      S < 1 || K < 1 || blocks < 1 || blocks % split)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = k1_smem_bytes(tile_h, tile_w, C, split, ks, false);
  const int fit = max_active_clusters(kern, smem, split);
  if (fit < 0) return (int)cudaErrorInvalidValue;
  if (blocks / split > fit) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.plane = (long long)H * W * C;
  p.w_ur_at = (long long)9 * 2 * C * C;
  p.w_o_at = (long long)9 * C * C;
  p.S = S;
  p.K = K;
  p.tiles_x = (W + tile_w - 1) / tile_w;
  p.tiles = p.tiles_x * ((H + tile_h - 1) / tile_h);
  p.clusters = blocks / split;
  ClusterLaunch c(dim3(blocks), smem, split, (cudaStream_t)stream, true);
  err = cudaLaunchKernelEx(&c.cfg, kern, p);
  const cudaError_t last = cudaGetLastError();   // clears the launch's error state
  return (int)(err != cudaSuccess ? err : last);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
