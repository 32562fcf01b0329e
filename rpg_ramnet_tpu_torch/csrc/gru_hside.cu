// Fused ConvGRU h-side cell (kernel K1) for NVIDIA Hopper, sm_90a, its
// residual variant for training (K1-res) and its gx-streaming variant
// (K10a).
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_hside.py::_run with
// _kernel (K1) and _kernel_res (K1-res), and
// rpg_ramnet_tpu/ops/gru_stream.py::_run_stream (_stream_kernel, K10a):
// K1 at batch 1 reading its gx block from the whole chunk's buffer gx_seq
// [S,H,W,3C] at the step a device int32 holds.  From the state h [B,H,W,C] and the
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
// byte, above the H100's bf16 tensor-core ridge (~295 flop/B) at C = 64,
// 128, 256, so its bound is the tensor cores.  What held the first design
// far from it (3-7% of the bf16 peak) was the weight feed: each warp read
// its B fragments from L1/L2 for every 32-pixel item, so every block
// re-read the whole weight set (27*C^2*2 bytes) once per item, 255 to
// 2114 MB per launch at the flagship and training shapes, 1.8-2.7 TB/s
// over its times, against 5-128 MB of h, gx and h'.
//
// What the design does about it (gru_hside_tile.cuh):
//   1. The weights stream once per block through a shared-memory ring
//      (cp.async, two slabs of one tap x ks input channels x the block's
//      output rows), and every warp takes its B fragments from it
//      by ldmatrix.  Each warp holds one large job for the whole K walk
//      (up to 96 pixels x 32 channels of r, 64 pixels x 32 channels of both
//      z and o), so each A and B fragment feeds 4-12 mma.sync.  The h tile
//      and gx arrive by cp.async too, and the outputs leave from shared
//      memory 16 bytes a lane.
//   2. At C >= 128 a thread-block cluster of two blocks shares a pixel
//      tile and splits the output channels: each block streams only its
//      C/2 rows of the weights, computes its half of r and a, takes its
//      peer's half of a through distributed shared memory, then its half
//      of z, o and h'.  At the same block count the pixel tile doubles, so
//      the weight bytes per launch halve.  Clusters of four lost to two at
//      every shape timed (PERF.md §6) and are not built.
// Measured on the card (PERF.md §6), the weight bytes per launch fell
// 2.3-9x, and what is left bounds it: each slab's cp.async writes share
// shared memory's bandwidth with the ldmatrix reads, at about 0.6 us a
// slab.  The wrapper plans the tile, the split, the warp jobs and the slab
// width per shape (ops/gru_hside.py::plan_k1, a cost
// model fitted to timed plans) and passes the plan.  TMA multicast of the
// slabs and wgmma are the next steps.  K10a (here), the whole-chunk cell
// K11 (gru_chunk.cu) and the pair cells K9 and K10b (gru_cells.cu) run the
// same tile under K1's plans.

#include "gru_hside_tile.cuh"

namespace {

// A warp's jobs (r: MR x NR m16 x n8 tiles; z/o: MC x NC) per plan
// "combo", ops/gru_hside.py::K1_COMBOS in the same order; null for none.
template <bool kRes>
void (*kernel_of(int combo))(const K1Args) {
  switch (combo) {
    case 0: return k1_kernel<kRes, 6, 4, 4, 4>;
    case 1: return k1_kernel<kRes, 3, 4, 2, 4>;
    case 2: return k1_kernel<kRes, 2, 4, 2, 2>;
    default: return nullptr;
  }
}

// K10a: K1 at batch 1 on the gx block of step *sel of gx_seq, clamped to
// [0, n_steps) on the device, so the launch's arguments do not change with
// the step.  Grid as K1's.
struct K10aTile : GridTile {
  long long step;
  __device__ const bf16* gx(const K1Args& a) const { return a.gx + step * a.gx_bstride; }
};

template <int MR, int NR, int MC, int NC>
__global__ void __launch_bounds__(kThreads, 1)
k10a_kernel(const K1Args a, const int* sel, int n_steps) {
  K10aTile at;
  at.step = min(max(__ldg(sel), 0), n_steps - 1);
  k1_tile<false, MR, NR, MC, NC>(a, at);
}

void (*k10a_kernel_of(int combo))(const K1Args, const int*, int) {
  switch (combo) {
    case 0: return k10a_kernel<6, 4, 4, 4>;
    case 1: return k10a_kernel<3, 4, 2, 4>;
    case 2: return k10a_kernel<2, 4, 2, 2>;
    default: return nullptr;
  }
}

template <typename... Extra>
cudaError_t launch_kernel(void (*kern)(const K1Args, Extra...), const K1Args& a, dim3 grid,
                          size_t smem, cudaStream_t stream, Extra... extra) {
  if (!kern) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch c(grid, smem, a.split, stream);
  err = cudaLaunchKernelEx(&c.cfg, kern, a, extra...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

dim3 k1_grid(const K1Args& a, int B) {
  return dim3(((a.W + a.TW - 1) / a.TW) * a.split, (a.H + a.TH - 1) / a.TH, B);
}

template <bool kRes>
int launch(const void* h, const void* gx, const void* w_ur, const void* w_o, void* out,
           void* acts, int B, int H, int W, int C, long long gx_bstride, int tile_h,
           int tile_w, int split, int combo, int ks, void* stream) {
  K1Args a;
  if (!make_k1_args(a, h, gx, w_ur, w_o, out, acts, H, W, C, gx_bstride, tile_h, tile_w,
                    split, ks))
    return (int)cudaErrorInvalidValue;
  return (int)launch_kernel(kernel_of<kRes>(combo), a, k1_grid(a, B),
                            k1_smem_bytes(tile_h, tile_w, C, split, ks, kRes),
                            (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Launches one cell on `stream`.  h, out: [B,H,W,C] contiguous; gx: [H,W,3C]
// contiguous per batch item, batch items gx_bstride elements apart;
// w_ur [9,2C,C] (update rows, then reset rows), w_o [9,C,C], each
// [tap][out][in].  All bf16, all 16-byte aligned, C % 16 == 0.  The plan:
// the tile_h x tile_w output tile, `split` blocks per cluster (1 or 2,
// (C/16) % split == 0), the warp jobs `combo` and ks input channels per
// weight slab (16, 32 or 64, dividing C).
// Returns the cudaError_t of the launch (cudaGetLastError's after it).
int ramnet_gru_hside_forward(const void* h, const void* gx, const void* w_ur,
                             const void* w_o, void* out, int B, int H, int W,
                             int C, long long gx_bstride, int tile_h,
                             int tile_w, int split, int combo, int ks,
                             void* stream) {
  return launch<false>(h, gx, w_ur, w_o, out, nullptr, B, H, W, C, gx_bstride,
                       tile_h, tile_w, split, combo, ks, stream);
}

// The same cell, also writing acts [B,H,W,3C] = bf16(concat(z, r, o)),
// contiguous.
int ramnet_gru_hside_forward_res(const void* h, const void* gx, const void* w_ur,
                                 const void* w_o, void* out, void* acts, int B,
                                 int H, int W, int C, long long gx_bstride,
                                 int tile_h, int tile_w, int split, int combo,
                                 int ks, void* stream) {
  return launch<true>(h, gx, w_ur, w_o, out, acts, B, H, W, C, gx_bstride,
                      tile_h, tile_w, split, combo, ks, stream);
}

// K10a on `stream`: the cell of h, out [1,H,W,C] on step *sel of gx_seq
// [S,H,W,3C] (contiguous; sel a device int32, clamped to [0, S)), weights
// and plan as ramnet_gru_hside_forward's.  Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for a plan the tile cannot run.
int ramnet_gru_hside_forward_sel(const void* h, const void* gx_seq, const void* sel,
                                 const void* w_ur, const void* w_o, void* out, int H,
                                 int W, int C, int S, int tile_h, int tile_w, int split,
                                 int combo, int ks, void* stream) {
  K1Args a;
  if (S < 1 || !make_k1_args(a, h, gx_seq, w_ur, w_o, out, nullptr, H, W, C,
                             (long long)H * W * 3 * C, tile_h, tile_w, split, ks))
    return (int)cudaErrorInvalidValue;
  return (int)launch_kernel(k10a_kernel_of(combo), a, k1_grid(a, 1),
                            k1_smem_bytes(tile_h, tile_w, C, split, ks, false),
                            (cudaStream_t)stream, static_cast<const int*>(sel), S);
}

// Whether `device` can launch thread-block clusters (cudaDevAttrClusterLaunch).
int ramnet_cluster_launch_supported(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrClusterLaunch, device) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return v;
}

// How many clusters of a plan fit on the device at once
// (cudaOccupancyMaxActiveClusters; a cluster of 1 is one block), or -1
// where the query fails: the wave of blocks in ops/gru_hside.py's cost
// model.
int ramnet_gru_hside_max_active_clusters(int res, int C, int tile_h, int tile_w, int split,
                                         int combo, int ks) {
  void (*kern)(const K1Args) = res ? kernel_of<true>(combo) : kernel_of<false>(combo);
  if (!kern || split < 1) return -1;
  return max_active_clusters(kern, k1_smem_bytes(tile_h, tile_w, C, split, ks, res != 0),
                             split);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
