// The ConvGRU h-side cell over two scales per launch, for NVIDIA Hopper,
// sm_90a: the cross-scale pair cell (kernel K9) and the two-scale
// gx-streaming cell (kernel K10b).
//
// Replaces the Pallas TPU kernels rpg_ramnet_tpu/ops/gru_pair.py::_run_pair
// (_pair_kernel, K9) and rpg_ramnet_tpu/ops/gru_stream.py::_run_stream_pair
// (_stream_pair_kernel, K10b).  Each computes K1's cell (gru_hside.cu) on
// two scales' (h, gx) in one launch:
//
//   K9    scales 0 and 1, any batch; gx [B,H,W,3C] with batch items
//         gx_bstride elements apart (the per-step views of the chunk's gx
//         buffers need no copy);
//   K10b  batch 1; each scale's gx block read from its whole-chunk buffer
//         gx_seq [S,H,W,3C] at the step that the device int32 *sel holds
//         (K10a's indexing: one sel for both scales, clamped to [0, S)), so
//         no per-step slice is made and the launch arguments stay the same
//         from step to step but for h and h'.
//
// The TPU kernels feed the reset gate's one-row halo from side arrays,
// because a BlockSpec cannot fetch it; the tile reads those rows straight
// from the gx plane, so there are none.
//
// What bounds them on this card: as K1, the tensor cores' feed (27*C^2
// multiply-adds per pixel against 10*C bytes).  What the design does: each
// block runs K1's tile body (gru_hside_tile.cuh: the weights streamed once
// per block through a two-slab cp.async ring, gx and h' staged, channels
// split over a cluster of 2 at C >= 128) under its scale's own K1 plan,
// both scales' blocks in one grid (PairTile: the two scales' tile rows
// stacked in K1's grid, and the cluster and padding rules), both plans on
// one warp-job combo, so that one body serves both.  Dynamic shared
// memory is the larger of the two plans' footprints.  The wrapper
// (ops/gru_pair.py::plan_k9) plans each scale as K1 would on each combo,
// takes the combo of least summed cost, and picks which scale's blocks
// come first.

#include "gru_hside_tile.cuh"

namespace {

// Each block runs the body on its scale, or returns (a padding block).
// One body serves both scales, so both run one combo: a kernel with a
// body per scale (its two K1 plans on different combos) ran one of the
// two bodies 15-25% slower than K1 does, which one by the code's layout
// and the block order, on an H100 (PERF.md §6).
template <bool kSel, int MR, int NR, int MC, int NC>
__global__ void __launch_bounds__(kThreads, 1)
k9_kernel(const __grid_constant__ PairArgs p, const int* sel, int n_steps) {
  const int s = (int)blockIdx.y - p.row0[0] >= 0 && (int)blockIdx.y - p.row0[0] < p.rows[0]
                    ? 0 : 1;
  if ((int)blockIdx.x >= p.cols[s]) return;
  const long long step = kSel ? min(max(__ldg(sel), 0), n_steps - 1) : 0;
  k1_tile<false, MR, NR, MC, NC>(p.s[s], PairTile<kSel>{p, s, step});
}

typedef void (*K9Kernel)(const PairArgs, const int*, int);

// The instance for the plans' warp-job combo (both scales run one),
// ops/gru_hside.py::K1_COMBOS in the same order.
template <bool kSel>
K9Kernel kernel_of(int combo) {
  switch (combo) {
    case 0: return k9_kernel<kSel, 6, 4, 4, 4>;
    case 1: return k9_kernel<kSel, 3, 4, 2, 4>;
    case 2: return k9_kernel<kSel, 2, 4, 2, 2>;
    default: return nullptr;
  }
}

// The grid of two scales of B batch items, scale `first`'s tile rows
// first (PairTile's rules), into p; returns the launch's cluster size.
int pair_grid(PairArgs& p, int B, int first, dim3& grid) {
  const int cluster = p.s[0].split > p.s[1].split ? p.s[0].split : p.s[1].split;
  int cols = 0;
  for (int s = 0; s < 2; ++s) {
    const K1Args& a = p.s[s];
    p.rows[s] = (a.H + a.TH - 1) / a.TH;
    p.cols[s] = (a.W + a.TW - 1) / a.TW * a.split;
    cols = p.cols[s] > cols ? p.cols[s] : cols;
  }
  p.row0[first] = 0;
  p.row0[1 - first] = p.rows[first];
  grid = dim3((cols + cluster - 1) / cluster * cluster, p.rows[0] + p.rows[1], B);
  return cluster;
}

template <bool kSel>
int launch(PairArgs& p, int combo0, int combo1, int B, int first, const int* sel,
           int n_steps, void* stream) {
  const K9Kernel kern = combo0 == combo1 ? kernel_of<kSel>(combo0) : nullptr;
  if (!kern || B < 1 || (first != 0 && first != 1)) return (int)cudaErrorInvalidValue;
  dim3 grid;
  const int cluster = pair_grid(p, B, first, grid);
  size_t smem = 0;
  for (const K1Args& a : p.s) {
    const size_t s = k1_smem_bytes(a.TH, a.TW, a.C, a.split, a.ks, false);
    smem = s > smem ? s : smem;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch c(grid, smem, cluster, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&c.cfg, kern, p, sel, n_steps);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// K9 on `stream`: per scale i, h_i and out_i [B,H_i,W_i,C_i] contiguous,
// gx_i [H_i,W_i,3C_i] contiguous per batch item with items gx_i_bstride
// elements apart, w_ur_i [9,2C_i,C_i] and w_o_i [9,C_i,C_i] ([tap][out]
// [in]), and the scale's K1 plan (tile_h_i, tile_w_i, split_i, combo_i,
// ks_i; ramnet_gru_hside_forward's), combo_0 == combo_1.  All bf16,
// 16-byte aligned.  first: the scale (0 or 1) whose blocks come first.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for plans
// the kernel cannot run.
int ramnet_gru_pair_forward(const void* h0, const void* gx0, const void* w0_ur,
                            const void* w0_o, void* out0, int H0, int W0, int C0,
                            long long gx0_bstride, int tile_h0, int tile_w0, int split0,
                            int combo0, int ks0, const void* h1, const void* gx1,
                            const void* w1_ur, const void* w1_o, void* out1, int H1, int W1,
                            int C1, long long gx1_bstride, int tile_h1, int tile_w1,
                            int split1, int combo1, int ks1, int B, int first, void* stream) {
  PairArgs p = {};
  if (!make_k1_args(p.s[0], h0, gx0, w0_ur, w0_o, out0, nullptr, H0, W0, C0, gx0_bstride,
                    tile_h0, tile_w0, split0, ks0) ||
      !make_k1_args(p.s[1], h1, gx1, w1_ur, w1_o, out1, nullptr, H1, W1, C1, gx1_bstride,
                    tile_h1, tile_w1, split1, ks1))
    return (int)cudaErrorInvalidValue;
  return launch<false>(p, combo0, combo1, B, first, nullptr, 0, stream);
}

// K10b on `stream`: per scale i, h_i and out_i [1,H_i,W_i,C_i] contiguous,
// gx_i_seq [S,H_i,W_i,3C_i] contiguous, weights and plans as K9's; sel a
// device int32 (the step, clamped to [0, S)), one for both scales.
int ramnet_gru_stream_pair_forward(const void* h0, const void* gx0_seq, const void* w0_ur,
                                   const void* w0_o, void* out0, int H0, int W0, int C0,
                                   int tile_h0, int tile_w0, int split0, int combo0, int ks0,
                                   const void* h1, const void* gx1_seq, const void* w1_ur,
                                   const void* w1_o, void* out1, int H1, int W1, int C1,
                                   int tile_h1, int tile_w1, int split1, int combo1, int ks1,
                                   const void* sel, int S, int first, void* stream) {
  PairArgs p = {};
  if (S < 1 ||
      !make_k1_args(p.s[0], h0, gx0_seq, w0_ur, w0_o, out0, nullptr, H0, W0, C0,
                    (long long)H0 * W0 * 3 * C0, tile_h0, tile_w0, split0, ks0) ||
      !make_k1_args(p.s[1], h1, gx1_seq, w1_ur, w1_o, out1, nullptr, H1, W1, C1,
                    (long long)H1 * W1 * 3 * C1, tile_h1, tile_w1, split1, ks1))
    return (int)cudaErrorInvalidValue;
  return launch<true>(p, combo0, combo1, 1, first, static_cast<const int*>(sel), S, stream);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
