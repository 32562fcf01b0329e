// The event voxelizers (kernels K6 and K7) for NVIDIA Hopper, sm_90a.
//
// Both compute the bilinear-in-time voxel grid of the reference
// (RAM_Net/data_loader/dataset_asynchronous.py:253-298) from events [N,4]
// float32 rows (t, x, y, polarity), zero-padded past n_valid:
//
//     first = t[0], last = t[n_valid-1], dt = last - first (1 when 0)
//     ts = (num_bins - 1) * (t - first) / dt,  tis = trunc(ts),  dts = ts - tis
//     grid[tis,   y, x] += pol * (1 - dts)     (when tis < num_bins)
//     grid[tis+1, y, x] += pol * dts           (when tis + 1 < num_bins)
//
// with polarity 0 counted as -1, into a zeroed float32 grid [num_bins, H, W]
// (the wrapper zeroes it).  ts is computed with __fsub_rn/__fmul_rn/
// __fdiv_rn in the JAX package's order, so no contraction into an FMA can
// move an event across a bin boundary: that would be an error of a whole
// polarity unit, not an ulp.  A contribution outside the grid (x or y
// outside the image, tis < 0) is dropped.
//
// K6 replaces rpg_ramnet_tpu/ops/voxel.py::events_to_voxel_grid_sortseg
// (_make_sortseg_kernel, sortseg_prep): one thread per event, one
// atomicAdd per contribution.  There is no sort: the TPU kernel sorts the
// events and sweeps windows of the sorted cells only because the TPU lacks
// a fast scatter (voxel.py:287-300); Hopper's float atomics into a grid that
// sits in L2 (1.8 MB at 5x260x346, of 50 MB) are that scatter.  With stats,
// a second, block-reduced pass adds the nonzero cells' count, sum and sum
// of squares (the TPU kernel's with_stats epilogue).  What bounds it on this
// card: the bytes, 16 per event read and 4 per cell written (17.8 MB at 1M
// events and 5x260x346: 5.3 us at 3.35 TB/s); the atomics resolve in L2.
//
// K7 replaces events_to_voxel_grid_pallas (_make_voxel_kernel): the same
// grid as one-hot(rows)^T . (vals * one-hot(cols)) on the tensor cores,
// rows = bin*H + y and cols = x.  Each block owns one 128 x 128 tile of
// the [num_bins*H, W] grid and a share of the event chunks; for each chunk
// of 64 events (128 contributions, the contraction) it sets the two
// one-hot factors in shared memory and accumulates the tile with mma.sync
// m16n8k16.  With float32 factors each value is split into bf16 hi + lo
// (the technique of voxel.py:336-345), so the sum stays float32-accurate;
// bfloat16 factors take hi only.  Tiles of several shares add into the
// grid with atomics.  Its work grows with tiles x events (33 tiles at
// 5x260x346, each reading every event): right, and slow next to K6; it is
// bounded by the same bytes as K6.

#include <algorithm>

#include "mma_conv.cuh"

namespace {

// The two contributions of one event.  row: grid row (bin*H + y) of the
// left contribution, col: x; ok_l / ok_r: whether each lands in the grid.
__device__ __forceinline__ void contributions(float4 e, float first, float dt,
                                              int nb, int H, int W, int& row,
                                              int& col, float& v_l, float& v_r,
                                              bool& ok_l, bool& ok_r) {
  const float ts = __fdiv_rn(__fmul_rn((float)(nb - 1), __fsub_rn(e.x, first)), dt);
  const int tis = (int)ts;   // truncation toward zero, as astype(int32)
  const float dts = __fsub_rn(ts, (float)tis);
  const int x = (int)e.y, y = (int)e.z;
  const float pol = e.w == 0.0f ? -1.0f : e.w;
  const bool inside = tis >= 0 && x >= 0 && x < W && y >= 0 && y < H;
  ok_l = inside && tis < nb;
  ok_r = inside && tis < nb - 1;
  row = ok_l ? tis * H + y : 0;
  col = x;
  v_l = __fmul_rn(pol, __fsub_rn(1.0f, dts));
  v_r = __fmul_rn(pol, dts);
}

__device__ __forceinline__ float window_dt(const float4* ev, int n_valid, float& first) {
  first = ev[0].x;
  const float dt = __fsub_rn(ev[n_valid - 1].x, first);
  return dt == 0.0f ? 1.0f : dt;
}

// K6: one thread per event (grid-stride), atomicAdd into the grid.
__global__ void __launch_bounds__(256)
scatter_kernel(const float4* __restrict__ ev, int n_valid, int nb, int H, int W,
               float* __restrict__ grid) {
  float first;
  const float dt = window_dt(ev, n_valid, first);
  const size_t hw = (size_t)H * W;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_valid;
       i += gridDim.x * blockDim.x) {
    int row, col;
    float v_l, v_r;
    bool ok_l, ok_r;
    contributions(__ldg(ev + i), first, dt, nb, H, W, row, col, v_l, v_r, ok_l, ok_r);
    const size_t cell = (size_t)row * W + col;
    if (ok_l) atomicAdd(grid + cell, v_l);
    if (ok_r) atomicAdd(grid + cell + hw, v_r);
  }
}

// K6 with stats: count, sum and sum of squares of the nonzero cells, per
// thread, then per warp and block, then one atomicAdd per block and stat.
__global__ void __launch_bounds__(256)
stats_kernel(const float* __restrict__ grid, long long cells, float* __restrict__ stats) {
  float s[3] = {0.0f, 0.0f, 0.0f};
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = grid[i];
    if (v != 0.0f) {
      s[0] += 1.0f;
      s[1] += v;
      s[2] += v * v;
    }
  }
  __shared__ float red[3][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_down_sync(0xffffffffu, s[j], o);
    if (lane == 0) red[j][warp] = s[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float v = lane < (int)(blockDim.x >> 5) ? red[j][lane] : 0.0f;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) atomicAdd(stats + j, v);
    }
  }
}

constexpr int kTile = 128;          // K7 output tile: grid rows x grid columns
constexpr int kEv = 64;             // K7 events per chunk
constexpr int kK = 2 * kEv;         // contributions per chunk: the contraction
constexpr int kFPitch = kK + kPad;  // factor row pitch (bf16), 16-byte rows
constexpr int kOhSmem = 3 * kTile * kFPitch * (int)sizeof(bf16);

// K7: block (tile, share).  Shared memory holds the factors with the
// contraction contiguous: A[r][k] = 1 where contribution k lands in tile
// row r, B[c][k] = its value (hi, and lo) where it lands in tile column c.
// Warp w owns rows 32*(w/2) .. +32 and columns 64*(w%2) .. +64 of the tile.
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const float4* __restrict__ ev, int n_valid, int nb, int H, int W,
              int two_parts, int chunks_per_share, float* __restrict__ grid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bh = as + kTile * kFPitch;
  bf16* bl = bh + kTile * kFPitch;
  const uint32_t as_u = (uint32_t)__cvta_generic_to_shared(as);
  const int rows = nb * H;
  const int tiles_c = (W + kTile - 1) / kTile;
  const int r0 = (blockIdx.x / tiles_c) * kTile, c0 = (blockIdx.x % tiles_c) * kTile;
  const int n_chunks = (n_valid + kEv - 1) / kEv;
  const int ch0 = blockIdx.y * chunks_per_share;
  const int ch1 = min(n_chunks, ch0 + chunks_per_share);
  for (int i = threadIdx.x; i < kOhSmem / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  float first;
  const float dt = window_dt(ev, n_valid, first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  // the factor entries this thread set in the last chunk, to clear them
  int set_r[2] = {-1, -1}, set_c[2] = {0, 0};
  __syncthreads();

  for (int chunk = ch0; chunk < ch1; ++chunk) {
    if (threadIdx.x < kEv) {
      const int e = threadIdx.x;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (set_r[j] >= 0) {
          const int k = e + j * kEv;
          as[set_r[j] * kFPitch + k] = __float2bfloat16_rn(0.0f);
          bh[set_c[j] * kFPitch + k] = __float2bfloat16_rn(0.0f);
          bl[set_c[j] * kFPitch + k] = __float2bfloat16_rn(0.0f);
          set_r[j] = -1;
        }
      }
      const int i = chunk * kEv + e;
      if (i < n_valid) {
        int row, col;
        float v[2];
        bool ok[2];
        contributions(__ldg(ev + i), first, dt, nb, H, W, row, col, v[0], v[1], ok[0], ok[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int rl = row + j * H - r0, cl = col - c0;
          if (ok[j] && rl >= 0 && rl < kTile && cl >= 0 && cl < kTile) {
            const int k = e + j * kEv;
            const bf16 hi = __float2bfloat16_rn(v[j]);
            as[rl * kFPitch + k] = __float2bfloat16_rn(1.0f);
            bh[cl * kFPitch + k] = hi;
            if (two_parts) bl[cl * kFPitch + k] = __float2bfloat16_rn(v[j] - __bfloat162float(hi));
            set_r[j] = rl;
            set_c[j] = cl;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k0 = 0; k0 < kK; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(as_u + 2 * ((wm + mi * 16 + (lane & 15)) * kFPitch + k0 + (lane >> 4) * 8),
                    a[mi]);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int off = (wn + ni * 8 + g) * kFPitch + k0 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bh + off);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bh + off + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
        if (two_parts) {
          const uint32_t l0 = *reinterpret_cast<const uint32_t*>(bl + off);
          const uint32_t l1 = *reinterpret_cast<const uint32_t*>(bl + off + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], l0, l1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wm + mi * 16 + g + 8 * (e >> 1);
        const int col = c0 + wn + ni * 8 + 2 * t + (e & 1);
        const float v = acc[mi][ni][e];
        if (row < rows && col < W && v != 0.0f) atomicAdd(grid + (size_t)row * W + col, v);
      }
}

constexpr int kSMs = 132;

}  // namespace

extern "C" {

// K6 on `stream`: events [N,4] float32 (16-byte aligned), n_valid >= 1 of
// them valid; grid [nb,H,W] float32, zeroed; stats [3] float32, zeroed, or
// null for no stats.  Returns the cudaError_t of the launches.
int ramnet_voxel_scatter(const void* events, int n_valid, int nb, int H, int W,
                         void* grid, void* stats, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = std::min((n_valid + 255) / 256, kSMs * 8);
  scatter_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(events), n_valid,
                                        nb, H, W, static_cast<float*>(grid));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  const long long cells = (long long)nb * H * W;
  const int sblocks = (int)std::min((cells + 255) / 256, (long long)kSMs * 4);
  stats_kernel<<<sblocks, 256, 0, s>>>(static_cast<const float*>(grid), cells,
                                       static_cast<float*>(stats));
  return (int)cudaGetLastError();
}

// K7 on `stream`: events and grid as for K6; two_parts: 1 for float32
// factors (hi + lo), 0 for bfloat16 factors (hi only).
int ramnet_voxel_onehot(const void* events, int n_valid, int nb, int H, int W,
                        int two_parts, void* grid, void* stream) {
  const int tiles = ((nb * H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const int n_chunks = (n_valid + kEv - 1) / kEv;
  // about two blocks per SM: each tile's chunks in as many shares
  const int shares = std::max(1, std::min(n_chunks, (2 * kSMs + tiles - 1) / tiles));
  const int per_share = (n_chunks + shares - 1) / shares;
  const dim3 blocks(tiles, (n_chunks + per_share - 1) / per_share);
  cudaError_t err = cudaFuncSetAttribute(
      onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOhSmem);
  if (err != cudaSuccess) return (int)err;
  onehot_kernel<<<blocks, kThreads, kOhSmem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(events), n_valid, nb, H, W, two_parts, per_share,
      static_cast<float*>(grid));
  return (int)cudaGetLastError();
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
