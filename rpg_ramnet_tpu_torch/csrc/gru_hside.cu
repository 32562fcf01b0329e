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
// slabs and wgmma are the next steps.  The launch variants K9, K10a, K10b
// and K11 keep the first design's tile (gru_cell.cuh).

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

template <bool kRes>
cudaError_t launch_combo(int combo, const K1Args& a, dim3 grid, size_t smem,
                         cudaStream_t stream) {
  void (*kern)(const K1Args) = kernel_of<kRes>(combo);
  if (!kern) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch c(grid, smem, a.split, stream);
  err = cudaLaunchKernelEx(&c.cfg, kern, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <bool kRes>
int launch(const void* h, const void* gx, const void* w_ur, const void* w_o, void* out,
           void* acts, int B, int H, int W, int C, long long gx_bstride, int tile_h,
           int tile_w, int split, int combo, int ks, void* stream) {
  if (C % 16 || (split != 1 && split != 2) || (C / 16) % split ||
      (ks != 16 && ks != 32 && ks != 64) || C % ks || tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  K1Args a;
  a.h = static_cast<const bf16*>(h);
  a.gx = static_cast<const bf16*>(gx);
  a.w_ur = static_cast<const bf16*>(w_ur);
  a.w_o = static_cast<const bf16*>(w_o);
  a.out = static_cast<bf16*>(out);
  a.acts = static_cast<bf16*>(acts);
  a.H = H;
  a.W = W;
  a.C = C;
  a.gx_bstride = gx_bstride;
  a.TH = tile_h;
  a.TW = tile_w;
  a.split = split;
  a.ks = ks;
  const dim3 grid(((W + tile_w - 1) / tile_w) * split, (H + tile_h - 1) / tile_h, B);
  const size_t smem = k1_smem_bytes(tile_h, tile_w, C, split, ks, kRes);
  return (int)launch_combo<kRes>(combo, a, grid, smem, (cudaStream_t)stream);
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
  const size_t smem = k1_smem_bytes(tile_h, tile_w, C, split, ks, res != 0);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  ClusterLaunch c(dim3(split * 1024), smem, split, nullptr);
  c.cfg.numAttrs = 1;   // the query takes the cluster's size from the attribute
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &c.cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
