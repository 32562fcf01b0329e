// The event voxelizers (kernels K6 and K7) for NVIDIA Hopper, sm_90a.
//
// Both compute the bilinear-in-time voxel grid of the reference
// (RAM_Net/data_loader/dataset_asynchronous.py:253-298) from events [N,4]
// float32 rows (t, x, y, polarity), zero-padded past n_valid, for each
// window of a batch [B, N, 4] with its own n_valid:
//
//     first = t[0], last = t[n_valid-1], dt = last - first (1 when 0)
//     ts = (num_bins - 1) * (t - first) / dt,  tis = trunc(ts),  dts = ts - tis
//     grid[tis,   y, x] += pol * (1 - dts)     (when tis < num_bins)
//     grid[tis+1, y, x] += pol * dts           (when tis + 1 < num_bins)
//
// with polarity 0 counted as -1, into a float32 grid [B, num_bins, H, W].
// ts is computed with __fsub_rn/__fmul_rn/__fdiv_rn in the JAX package's
// order, so no contraction into an FMA can move an event across a bin
// boundary: that would be an error of a whole polarity unit, not an ulp.
// A contribution outside the grid (x or y outside the image, tis < 0) is
// dropped.  Event order is free: nothing assumes time-sorted input.
//
// One kernel (bf16 and stats template flags) computes both.  K6 replaces rpg_ramnet_tpu/ops/voxel.py::
// events_to_voxel_grid_sortseg (with_stats adds the nonzero cells' count,
// sum and sum of squares); K7 replaces events_to_voxel_grid_pallas, whose
// contract is the same grid (float32 factors) or the grid of values
// rounded to bf16 first (bfloat16 factors: the one-hot factor is exact in
// bf16, so only the value rounds).  The TPU formulations, a sort with
// windowed segment sums (K6) and one-hot(rows)^T . (vals * one-hot(cols))
// on the MXU (K7), exist because the TPU has no fast scatter; the earlier
// port of K7's product did O(tiles x events) work, most of it multiplying
// zeros on the tensor cores.  A scatter computes the same grid at
// O(events), so tensor cores have no place here.
//
// Two paths compute the grid; the C entry picks one by the grids' bytes
// (pick_path, kOnePassGridBytes below), never on a failure.
//
// One-pass path (windows whose grids sit in L2): the grid zeroed with one
// memset, then scatter_kernel, one thread per event and one float
// atomicAdd per contribution; the atomics resolve in L2.  With stats, a
// block-reduced pass over the grid adds the nonzero cells' count, sum and
// sum of squares.
//
// Tiled path (a batch of windows whose grids exceed L2, where an atomic
// would be a DRAM read-modify-write): the grid of a window is cut into
// tiles that fit in shared memory: one bin plane x a band of `rows` rows
// (the last band may be shorter), tile id = bin * bands + y / rows, a
// contiguous range of the grid.  The plan (rows per band) comes from the
// wrapper (ops/voxel.py::tile_plan).
//
//   1. bucket_kernel, block (chunk of kChunk events, window): reads its
//      events as float4, computes each event's two contributions and takes
//      each one's rank in its tile with a shared-memory atomic on the
//      tile's histogram.  An exclusive scan of the histogram gives each
//      tile its start in the block's region; the block reads its events
//      again (from cache: only the ranks live across the scan, so a wave
//      holds more blocks), stages 8-byte records (cell offset in the tile,
//      float32 value) in shared memory, writes them out coalesced, and
//      writes the scan (tiles + 1 starts) for the accumulate.  The scan is
//      per block: no global scan.  Block 0 of each window zeroes its stats.
//   2. accumulate_kernel, block (tile, window): gathers its tile's segment
//      of every chunk's region (each thread takes a run of up to kMaxRun
//      consecutive records, one binary search per run), adds the records
//      into the tile in shared memory with float atomics (a compare-and-
//      swap loop each: sm_90 has no native shared float add), and writes
//      the tile once with 16-byte stores, zeros included: the grid needs
//      no zeroing.  With stats it reduces the tile's nonzero cells (warp
//      shuffle, one partial per block, an atomicAdd per stat).
//
// What bounds both on this card: the bytes, 16 per event read and 4 per
// cell written (17.8 MB at 1M events and 5x260x346: 5.3 us at 3.35 TB/s).
// The one-pass path adds the memset's 4 B per cell and two L2 atomics per
// event; the tiled path adds 8 B per contribution of records written and
// read (in L2 at 1M events; a window batch's records exceed it), and pays
// two launches.  Measured on the H100 (PERF.md): the one-pass path wins
// while the grids fit in L2, the tiled path beyond.  A tile whose bucket
// holds most events (every event in one band) is one block's work: right,
// and slower.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                     // events per thread in the bucket pass
constexpr int kChunk = kThreads * kPer;     // events per bucket block
constexpr int kRec = 2 * kChunk;            // record slots per chunk region
constexpr int kMaxRun = 4;                  // consecutive records per thread, at most
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int window_count(const int* counts, int n_all, int w, int N) {
  const int n = counts != nullptr ? counts[w] : n_all;
  return min(max(n, 0), N);
}

__device__ __forceinline__ float window_dt(const float4* ev, int n_valid, float& first) {
  first = ev[0].x;
  const float dt = __fsub_rn(ev[n_valid - 1].x, first);
  return dt == 0.0f ? 1.0f : dt;
}

// The two contributions of one event: left into bin tis, right into bin
// tis + 1, both at (y, x); ok_l / ok_r: whether each lands in the grid.
__device__ __forceinline__ void contributions(float4 e, float first, float dt, int nb,
                                              int H, int W, int& tis, int& x, int& y,
                                              float& v_l, float& v_r, bool& ok_l,
                                              bool& ok_r) {
  const float ts = __fdiv_rn(__fmul_rn((float)(nb - 1), __fsub_rn(e.x, first)), dt);
  tis = (int)ts;   // truncation toward zero, as astype(int32)
  const float dts = __fsub_rn(ts, (float)tis);
  x = (int)e.y;
  y = (int)e.z;
  const float pol = e.w == 0.0f ? -1.0f : e.w;
  const bool inside = tis >= 0 && x >= 0 && x < W && y >= 0 && y < H;
  ok_l = inside && tis < nb;
  ok_r = inside && tis < nb - 1;
  v_l = __fmul_rn(pol, __fsub_rn(1.0f, dts));
  v_r = __fmul_rn(pol, dts);
}

// In-place exclusive scan of a[0..n) in shared memory by the whole block;
// returns the total.  Each thread scans a run of consecutive entries.
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int per = (n + kThreads - 1) / kThreads;
  const int b = min(n, (int)threadIdx.x * per), e = min(n, b + per);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kWarps) warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = b; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = warp_sums[kWarps - 1];
  __syncthreads();
  return total;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 4)
bucket_kernel(const float4* __restrict__ ev, const int* __restrict__ counts, int n_all,
              int N, int chunks, int nb, int H, int W, int rows, int bands,
              uint2* __restrict__ records, int* __restrict__ prefix,
              float* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* stage = reinterpret_cast<uint2*>(smem);      // [kRec]
  int* hist = reinterpret_cast<int*>(stage + kRec);   // [tiles + 1]
  __shared__ int warp_sums[kWarps];
  const int w = blockIdx.y, c = blockIdx.x;
  const int n = window_count(counts, n_all, w, N);
  if (stats != nullptr && c == 0 && threadIdx.x < 3) stats[3 * w + threadIdx.x] = 0.0f;
  const int e0 = c * kChunk;
  if (e0 >= n) return;
  const int tiles = nb * bands;
  const float4* wev = ev + (size_t)w * N;
  float first;
  const float dt = window_dt(wev, n, first);
  for (int i = threadIdx.x; i <= tiles; i += kThreads) hist[i] = 0;
  __syncthreads();

  // each thread's events: i = e0 + j * kThreads + threadIdx.x.  Phase 1
  // ranks each contribution in its tile; phase 2 (after the scan) reads
  // the events again and stages the records, so only the ranks live
  // across the scan.  Each phase issues its kPer loads before using them.
  float4 e[kPer];
  int rank[kPer];   // left rank + 1 | (right rank + 1) << 16; 0: dropped
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = e0 + j * kThreads + threadIdx.x;
    e[j] = i < n ? __ldg(wev + i) : make_float4(0.0f, -1.0f, -1.0f, 0.0f);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int tis, x, y;
    float v_l, v_r;
    bool ok_l, ok_r;
    contributions(e[j], first, dt, nb, H, W, tis, x, y, v_l, v_r, ok_l, ok_r);
    const int tile = ok_l ? tis * bands + y / rows : 0;
    rank[j] = (ok_l ? atomicAdd(hist + tile, 1) + 1 : 0)
              | (ok_r ? atomicAdd(hist + tile + bands, 1) + 1 : 0) << 16;
  }
  __syncthreads();
  const int total = block_exclusive_scan(hist, tiles, warp_sums);
  if (threadIdx.x == 0) hist[tiles] = total;
  __syncthreads();
  int* pre = prefix + ((size_t)w * chunks + c) * (tiles + 1);
  for (int i = threadIdx.x; i <= tiles; i += kThreads) pre[i] = hist[i];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (rank[j] != 0) e[j] = __ldg(wev + e0 + j * kThreads + threadIdx.x);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (rank[j] == 0) continue;
    int tis, x, y;
    float v_l, v_r;
    bool ok_l, ok_r;
    contributions(e[j], first, dt, nb, H, W, tis, x, y, v_l, v_r, ok_l, ok_r);
    if (kBf16) {
      v_l = __bfloat162float(__float2bfloat16_rn(v_l));
      v_r = __bfloat162float(__float2bfloat16_rn(v_r));
    }
    const int band = y / rows, tile = tis * bands + band;
    const unsigned cell = (unsigned)((y - band * rows) * W + x);
    const int r_l = (rank[j] & 0xffff) - 1, r_r = (rank[j] >> 16) - 1;
    stage[hist[tile] + r_l] = make_uint2(cell, __float_as_uint(v_l));
    if (r_r >= 0) stage[hist[tile + bands] + r_r] = make_uint2(cell, __float_as_uint(v_r));
  }
  __syncthreads();
  uint2* out = records + ((size_t)w * chunks + c) * kRec;
  for (int i = threadIdx.x; i < total; i += kThreads) out[i] = stage[i];
}

// A cell's share of the stats: count, sum and sum of squares if nonzero.
__device__ __forceinline__ void nonzero_stats(float v, float s[3]) {
  if (v != 0.0f) {
    s[0] += 1.0f;
    s[1] += v;
    s[2] += v * v;
  }
}

// Adds the block's s (count, sum, sum of squares) into out[0..3): warp
// shuffles, one partial per warp, one atomicAdd per nonzero stat.
__device__ __forceinline__ void block_add_stats(float s[3], float* out) {
  __shared__ float red[3][kWarps];
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
      float v = lane < kWarps ? red[j][lane] : 0.0f;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0 && v != 0.0f) atomicAdd(out + j, v);
    }
  }
}

// The tile [cells] from shared memory to out: scalar stores up to out's
// first 16-byte boundary, float4 stores, then the scalar tail.
__device__ __forceinline__ void store_tile(const float* acc, float* out, int cells) {
  const int head = min(cells, (int)(((16 - ((uintptr_t)out & 15)) & 15) >> 2));
  if ((int)threadIdx.x < head) out[threadIdx.x] = acc[threadIdx.x];
  const int quads = (cells - head) >> 2;
  float4* out4 = reinterpret_cast<float4*>(out + head);
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const float* a = acc + head + 4 * q;
    out4[q] = make_float4(a[0], a[1], a[2], a[3]);
  }
  for (int i = head + 4 * quads + threadIdx.x; i < cells; i += kThreads) out[i] = acc[i];
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, 8)
accumulate_kernel(const uint2* __restrict__ records, const int* __restrict__ prefix,
                  const int* __restrict__ counts, int n_all, int N, int chunks, int nb,
                  int H, int W, int rows, int bands, float* __restrict__ grid,
                  float* __restrict__ stats) {
  // shared memory: the tile [rows * W], then per chunk c of the window the
  // start of its segment in the tile's flat record order (the scanned
  // lengths) and the segment's first record in the records
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int* seg = reinterpret_cast<int*>(acc + rows * W);                // [chunks + 1]
  unsigned* base = reinterpret_cast<unsigned*>(seg + chunks + 1);   // [chunks]
  __shared__ int warp_sums[kWarps];
  const int w = blockIdx.y, t = blockIdx.x, tiles = nb * bands;
  const int n = window_count(counts, n_all, w, N);
  const int cw = (n + kChunk - 1) / kChunk;
  const int bin = t / bands, r0 = (t - bin * bands) * rows;
  const int cells = min(rows, H - r0) * W;
  for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = 0.0f;
  for (int c = threadIdx.x; c < cw; c += kThreads) {
    const int* pre = prefix + ((size_t)w * chunks + c) * (tiles + 1) + t;
    const int s = pre[0];
    seg[c] = pre[1] - s;
    base[c] = (unsigned)c * kRec + (unsigned)s;
  }
  __syncthreads();
  const int total = block_exclusive_scan(seg, cw, warp_sums);
  if (threadIdx.x == 0) seg[cw] = total;
  __syncthreads();

  // each thread adds runs of `run` consecutive records of the tile's flat
  // order (the longest power of two up to kMaxRun that still gives every
  // thread a run): a binary search for the last segment starting at or
  // before a run's first record (the non-empty one among equal starts),
  // then steps past the segments that end inside the run
  int run = kMaxRun;
  while (run > 1 && run * kThreads / 2 >= total) run >>= 1;
  const uint2* wrec = records + (size_t)w * chunks * kRec;
  for (int i0 = threadIdx.x * run; i0 < total; i0 += kThreads * run) {
    int lo = 0, hi = cw;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (seg[mid] <= i0) lo = mid;
      else hi = mid;
    }
    int next = seg[lo + 1];
    unsigned off = base[lo] - (unsigned)seg[lo];
    uint2 r[kMaxRun];
#pragma unroll
    for (int u = 0; u < kMaxRun; ++u) {
      const int i = i0 + u;
      if (u < run && i < total) {
        if (i == next) {
          do next = seg[++lo + 1];
          while (next == i);
          off = base[lo] - (unsigned)i;
        }
        r[u] = __ldg(wrec + off + (unsigned)i);
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxRun; ++u)
      if (u < run && i0 + u < total) atomicAdd(acc + r[u].x, __uint_as_float(r[u].y));
  }
  __syncthreads();
  store_tile(acc, grid + (((size_t)w * nb + bin) * H + r0) * W, cells);

  if (kStats) {
    float s[3] = {0.0f, 0.0f, 0.0f};
    for (int i = threadIdx.x; i < cells; i += kThreads) nonzero_stats(acc[i], s);
    block_add_stats(s, stats + 3 * w);
  }
}

// One-pass path: one thread per event (grid-stride within its window,
// blockIdx.y), one atomicAdd per contribution into the zeroed grid.
// Block 0 of each window zeroes its stats.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float4* __restrict__ ev, const int* __restrict__ counts, int n_all,
               int N, int nb, int H, int W, float* __restrict__ grid,
               float* __restrict__ stats) {
  const int w = blockIdx.y;
  const int n = window_count(counts, n_all, w, N);
  if (stats != nullptr && blockIdx.x == 0 && threadIdx.x < 3) stats[3 * w + threadIdx.x] = 0.0f;
  if (n == 0) return;
  const float4* wev = ev + (size_t)w * N;
  float first;
  const float dt = window_dt(wev, n, first);
  const size_t hw = (size_t)H * W;
  float* g = grid + (size_t)w * nb * hw;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    int tis, x, y;
    float v_l, v_r;
    bool ok_l, ok_r;
    contributions(__ldg(wev + i), first, dt, nb, H, W, tis, x, y, v_l, v_r, ok_l, ok_r);
    if (!ok_l) continue;
    if (kBf16) {
      v_l = __bfloat162float(__float2bfloat16_rn(v_l));
      v_r = __bfloat162float(__float2bfloat16_rn(v_r));
    }
    float* cell = g + ((size_t)tis * H + y) * W + x;
    atomicAdd(cell, v_l);
    if (ok_r) atomicAdd(cell + hw, v_r);
  }
}

// One-pass path with stats: the nonzero cells of each window's grid
// (blockIdx.y), grid-stride with kStatsLoads loads in flight per thread,
// block-reduced into its stats.
constexpr int kStatsLoads = 4;

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ grid, long long cells, float* __restrict__ stats) {
  const float* g = grid + (size_t)blockIdx.y * cells;
  const long long stride = (long long)gridDim.x * kThreads;
  float s[3] = {0.0f, 0.0f, 0.0f};
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kStatsLoads - 1) * stride < cells; i += kStatsLoads * stride) {
    float v[kStatsLoads];
#pragma unroll
    for (int u = 0; u < kStatsLoads; ++u) v[u] = g[i + u * stride];
#pragma unroll
    for (int u = 0; u < kStatsLoads; ++u) nonzero_stats(v[u], s);
  }
  for (; i < cells; i += stride) nonzero_stats(g[i], s);
  block_add_stats(s, stats + 3 * blockIdx.y);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr int kSMs = 132;
constexpr size_t kMaxSmem = 232448;   // shared memory a block may opt in to
constexpr int kMaxWindows = 65535;    // the launch grid's y extent
enum Path { kBySize = 0, kOnePass = 1, kTiled = 2 };
// The one-pass path while a launch's grids take at most this many bytes,
// the tiled path beyond.  Measured on the H100 (voxel_timing.py --sweep,
// PERF.md; K6 device us, one-pass against tiled, windows of 32,768 events
// on 5x260x346): one window 3.25 / 10.6 (31,485 events) to 108.2 / 112.0
// (4M); 8 windows (13.7 MB of grids) 12.0 / 17.0; 16 (27.5 MB) 27.2 /
// 27.7, with stats 37.7 / 31.5; 32 (55 MB) 85.9 / 50.1: the atomics leave
// L2 (50 MB) for DRAM read-modify-writes.
constexpr long long kOnePassGridBytes = 24ll << 20;

// The tiled path's sizes: its scratch (per window and bucket block, the
// block's record region and its tiles' starts) and each launch's shared
// memory.
struct TiledPlan {
  int bands, tiles, chunks;
  size_t smem_bucket, smem_accumulate, records, scratch;
};

TiledPlan tiled_plan(int batch, int N, int nb, int H, int W, int rows) {
  TiledPlan p;
  p.bands = (H + rows - 1) / rows;
  p.tiles = nb * p.bands;
  p.chunks = (N + kChunk - 1) / kChunk;
  p.smem_bucket = kRec * sizeof(uint2) + (size_t)(p.tiles + 1) * sizeof(int);
  p.smem_accumulate = (size_t)rows * W * sizeof(float) + (size_t)(2 * p.chunks + 1) * sizeof(int);
  p.records = (size_t)batch * p.chunks * kRec * sizeof(uint2);
  p.scratch = p.records + (size_t)batch * p.chunks * (p.tiles + 1) * sizeof(int);
  return p;
}

int pick_path(int path, int batch, int nb, int H, int W) {
  if (path != kBySize) return path;
  return (long long)batch * nb * H * W * (long long)sizeof(float) <= kOnePassGridBytes
             ? kOnePass : kTiled;
}

cudaError_t one_pass(const float4* events, const int* counts, int n_all, int batch, int N,
                     int nb, int H, int W, bool bf16, float* grid, float* stats,
                     cudaStream_t s) {
  const long long cells = (long long)nb * H * W;
  cudaError_t err = cudaMemsetAsync(grid, 0, (size_t)batch * cells * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int blocks = std::max(1, std::min((N + kThreads - 1) / kThreads,
                                          (kSMs * 8 + batch - 1) / batch));
  auto scatter = bf16 ? scatter_kernel<true> : scatter_kernel<false>;
  scatter<<<dim3(blocks, batch), kThreads, 0, s>>>(events, counts, n_all, N, nb, H, W,
                                                   grid, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return err;
  // a block per SM for one window, 64 per window for a batch: each block's
  // three atomics go to its window's stats, and same-address atomics from
  // many blocks serialize in L2 (528 blocks on one window: 4.2 us, 132:
  // 3.0 us at 5x260x346; 16 blocks per window of 8 windows lost to 66)
  const int sblocks = (int)std::max(1ll, std::min((cells + kThreads - 1) / kThreads,
                                                  (long long)std::max(kSMs / batch, 64)));
  stats_kernel<<<dim3(sblocks, batch), kThreads, 0, s>>>(grid, cells, stats);
  return cudaGetLastError();
}

cudaError_t tiled(const float4* events, const int* counts, int n_all, int batch, int N,
                  int nb, int H, int W, int rows, bool bf16, float* grid, float* stats,
                  void* scratch, cudaStream_t s) {
  const TiledPlan p = tiled_plan(batch, N, nb, H, W, rows);
  uint2* records = static_cast<uint2*>(scratch);
  int* prefix = reinterpret_cast<int*>(static_cast<unsigned char*>(scratch) + p.records);
  auto bucket = bf16 ? bucket_kernel<true> : bucket_kernel<false>;
  auto accumulate = stats != nullptr ? accumulate_kernel<true> : accumulate_kernel<false>;
  cudaError_t err = allow_smem(bucket, p.smem_bucket);
  if (err == cudaSuccess) err = allow_smem(accumulate, p.smem_accumulate);
  if (err != cudaSuccess) return err;
  bucket<<<dim3(p.chunks, batch), kThreads, p.smem_bucket, s>>>(
      events, counts, n_all, N, p.chunks, nb, H, W, rows, p.bands, records, prefix, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  accumulate<<<dim3(p.tiles, batch), kThreads, p.smem_accumulate, s>>>(
      records, prefix, counts, n_all, N, p.chunks, nb, H, W, rows, p.bands, grid, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The path (1: one-pass, 2: tiled) of a launch over `batch` windows into
// [batch, nb, H, W] grids: `path` itself unless 0, then the one the
// launch's size picks.
int ramnet_voxel_path(int path, int batch, int nb, int H, int W) {
  return pick_path(path, batch, nb, H, W);
}

// The scratch bytes a launch on `path` (1 or 2) takes with `rows` rows per
// band (tiled path), 0 on the one-pass path; -1 where the kernels cannot
// take the launch (too many windows or events, a band or a bucket block's
// histogram beyond a block's shared memory).
long long ramnet_voxel_scratch_bytes(int path, int batch, int N, int nb, int H, int W,
                                     int rows) {
  if (batch < 1 || batch > kMaxWindows || N < 1 || N >= (1 << 29) || nb < 1 || H < 1
      || W < 1 || (path != kOnePass && path != kTiled))
    return -1;
  if (path == kOnePass) return 0;
  if (rows < 1 || rows > H) return -1;
  const TiledPlan p = tiled_plan(batch, N, nb, H, W, rows);
  if (std::max(p.smem_bucket, p.smem_accumulate) > kMaxSmem) return -1;
  return (long long)p.scratch;
}

// K6 / K7 on `stream` for `batch` windows: events [batch, N, 4] float32
// (16-byte aligned); counts: int32 [batch] on the device (clamped to
// [0, N]) or null, then n_all events in every window; grid [batch, nb, H,
// W] float32, written whole (no zeroing needed); stats [batch, 3] float32
// or null; path: 1 one-pass, 2 tiled (0: by size, ramnet_voxel_path);
// rows: rows per band of the tile plan (tiled path); bf16: round each
// value to bf16 first; scratch: ramnet_voxel_scratch_bytes of the path.
// Returns the cudaError_t of the launches.
int ramnet_voxel_grid(const void* events, const void* counts, int n_all, int batch, int N,
                      int nb, int H, int W, int path, int rows, int bf16, void* grid,
                      void* stats, void* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* ev = static_cast<const float4*>(events);
  const int* cnt = static_cast<const int*>(counts);
  float* g = static_cast<float*>(grid);
  float* st = static_cast<float*>(stats);
  path = pick_path(path, batch, nb, H, W);
  if (ramnet_voxel_scratch_bytes(path, batch, N, nb, H, W, rows) < 0)
    return (int)cudaErrorInvalidValue;
  return (int)(path == kOnePass
                   ? one_pass(ev, cnt, n_all, batch, N, nb, H, W, bf16 != 0, g, st, s)
                   : tiled(ev, cnt, n_all, batch, N, nb, H, W, rows, bf16 != 0, g, st,
                           scratch, s));
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
