// Fused decoder layer (kernel K8) for NVIDIA Hopper, sm_90a:
//
//     out = relu(conv5x5(upsample2x_bilinear(x + skip), W) + b)
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/upsample_conv.py::_run
// with _kernel.  The bilinear resize is half-pixel (align_corners=False)
// with its edge clamp; the conv pads the 2x image with zeros.  x, skip
// [B,H,W,C] and out [B,2H,2W,Cout] are NHWC bf16; x + skip is rounded to
// bf16 as the plain two-stage layer rounds it, the conv accumulates in
// f32, and the 2x image never exists (so it is never rounded).
//
// What bounds it on this card.  Composed with the resize, the conv is four
// 4x4 phase kernels over the low-res image: 16*C*Cout multiply-adds per 2x
// pixel, 64*C*Cout per low-res pixel (the 25-tap conv on the 2x image
// would take 100).  The layer moves x, skip and out once: at the flagship
// widths (C, Cout) = (256, 128), (128, 64), (64, 32) that is ~1,000 to
// 4,100 flop per byte, far above the H100's bf16 ridge (~295 flop/B).  So
// it is bound by operations, and by how well the tensor cores are fed.
//
// What the design does about it.  One block (8 warps) owns a 16 x 16
// low-res tile of one batch item (32 x 32 output pixels) and 32 output
// channels of every phase.  Per slab of 16 input channels (one k16 step)
// it stages in shared memory the low-res tile with a 2-pixel halo whose
// rows and columns are clamped to the image (the resize's replicate rule):
// x and skip by cp.async, one slab ahead, summed and rounded to bf16 in
// place at the slab's first stage.  That 20 x 20 tile covers the 5 x 5
// union of the four phases' supports.  The phase weights
// (ops/upsample_conv.py::kernel_weights: [p][a][q][b][Cout_pad][C],
// K-contiguous) go through shared memory in five stages per slab, one per
// row tap tr of the union: the 8 taps (q, b) x 32 outputs of each phase p
// with a = tr - p in 0..3, copied by cp.async into one of two buffers
// while the other buffer's products run.  A warp owns two low-res rows of
// the tile (two m16 tiles of 16 pixels) and 4 phases x 32 channels (128
// f32 accumulators a thread).  Per union tap (tr, tc) it loads one A
// fragment per m16 tile by ldmatrix straight from the tile (no im2col)
// and issues mma.sync m16n8k16 (bf16 in, f32 accumulate) for every phase
// (p, q) whose support holds the tap (b = tc - q in 0..3), and only for
// those: the 64*C*Cout MACs, each A fragment feeding 4 phases on the 9
// central taps, 2 on the 12 edge taps and 1 on the 4 corner taps.  B
// fragments come from the staged weights by ldmatrix.  The epilogue adds
// the bias and the border terms, applies ReLU and stores phase (p, q) of
// pixel (i, j) at (2i + p, 2j + q).  Slabs of 32 channels ran 8-10%
// slower (register spills); PERF.md has the measurements.
//
// The border.  Over the clamped tile the phase form reads, outside the 2x
// image, its clamped extension where the conv reads zeros: a 2x row above
// the image is the column-upsampled low-res row 0, one below row H - 1,
// columns alike, a 2x pixel beyond a corner the low-res corner pixel.  So
//
//     out = phase - top - bottom - left - right + the four corners
//
// where top is the out-of-range taps of image row 0: a 1-D phase conv over
// the low-res row 0 with w's out-of-range rows summed (JAX prep_weights'
// c_first), 4 taps (2, q + b) per phase on the 16 pixels of that tile row;
// bottom alike on row H - 1; left and right 4 taps (a + p, 2) on the 16
// pixels of column 0 and W - 1; the corners' taps, counted in both, come
// back at tap (2, 2) on the corner pixels.  Their weights follow the phase
// kernels in the same tensor (ops/upsample_conv.py::edge_weights; the
// edges negated).  Each edge the tile touches makes four border jobs, one
// per phase, of one m16 tile each; warp w runs jobs w and w + 8, one tap
// per stage (a row job's b = tr, a column job's a = tr - p), B from L2.  A
// tile touches at most two edges unless H or W is at most 16, so a warp
// has one job: its products stay in registers until the loop ends, then
// go to f32 rows in shared memory that the epilogue adds to the edge
// pixels.  (Adding them there every stage made the warp wait for its
// whole queue of products at each stage: 25% of the flagship's first
// layer.)  A second job adds its products at each stage.
//
// Next: wgmma with TMA-fed shared-memory operands, persistent blocks.

#include "mma_conv.cuh"

namespace {

constexpr int kCS = 16;              // input channels of one slab (one k16 step)
constexpr int kPS = kCS + kPad;      // pixel (row) pitch in shared memory, bf16
constexpr int kTile = 16;            // low-res tile: 16 x 16 pixels
constexpr int kLo = kTile + 4;       // with its 2-pixel halo
constexpr int kLoPix = kLo * kLo;
constexpr int kNC = 32;              // output channels of one block, per phase
constexpr int kNT = kNC / 8;         // n8 tiles
constexpr int kMainBlocks = 64;      // [p][a][q][b] weight blocks
constexpr int kEdgeBlocks = 64;      // [side][p][q][tap], then 16 corner blocks
constexpr int kStageBlocks = 16;     // of one stage: two phases p x 8 taps (q, b)
constexpr int kJobs = 16;            // border jobs: 4 edges x 4 phases
constexpr int kEP = kNC + 8;         // f32 row pitch of a job's rows

constexpr int kTileElems = kLoPix * kPS;
constexpr int kStageElems = kStageBlocks * kNC * kPS;
// Shared memory of one block in bytes (147,728): two tiles and the raw
// skip tile, two weight stages, bf16 at pitch kPS; the border jobs' f32
// rows; a 16-byte zero row.
constexpr size_t kSmem = (size_t)(3 * kTileElems + 2 * kStageElems) * sizeof(bf16) +
                         (size_t)kJobs * kTile * kEP * sizeof(float) + 16;

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// B fragments of the kNT n8 tiles of a weight block in device memory: wg
// points at row g (output co_base + g) and input column c0 + 2t of the
// block; ld is its row pitch (C).
__device__ __forceinline__ void load_b(uint32_t (&bf)[kNT][2], const bf16* __restrict__ wg,
                                       int ld) {
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) {
    const bf16* wp = wg + (size_t)ni * 8 * ld;
    bf[ni][0] = __ldg(reinterpret_cast<const unsigned int*>(wp));
    bf[ni][1] = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
  }
}

// One block per 16 x 16 low-res tile (blockIdx.x, blockIdx.y) of one batch
// item and one slice of 32 output channels of every phase (blockIdx.z =
// b * n_slices + slice).  Cp: Cout padded to whole slices (the weight
// blocks' rows).
__global__ void __launch_bounds__(kThreads, 1)
upsample_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ skip,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     bf16* __restrict__ out, int H, int W, int C, int Cout, int Cp,
                     int n_slices, int relu, int borders) {
  constexpr int ps = kPS, n_vec = kCS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);      // [2][kLoPix][ps]
  bf16* raw = tiles + 2 * kTileElems;                    // the skip's tile
  bf16* wbuf = raw + kTileElems;                         // [2][16][kNC][ps]
  float* eacc = reinterpret_cast<float*>(wbuf + 2 * kStageElems);
  bf16* zero = reinterpret_cast<bf16*>(eacc + kJobs * kTile * kEP);
  const uint32_t tiles_u = smem_u32(tiles), wbuf_u = smem_u32(wbuf), zero_u = smem_u32(zero);

  const int b = blockIdx.z / n_slices;
  const int co_base = (blockIdx.z - b * n_slices) * kNC;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const size_t plane = (size_t)H * W * C;
  const size_t blk_elems = (size_t)Cp * C;
  const bf16* xb = x + (size_t)b * plane;
  const bf16* sb = skip ? skip + (size_t)b * plane : nullptr;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kJobs * kTile * kEP; i += kThreads) eacc[i] = 0.0f;

  // this lane's ldmatrix rows: A at pixel (lane & 15) of an m16 tile, k
  // half (lane >> 4); B at output row (lane & 7) + 8 (lane >> 4) of an n8
  // pair, k half (lane >> 3) & 1
  const int pl15 = lane & 15;
  const uint32_t a_k = 2 * (lane >> 4) * 8;
  const uint32_t b_lane = 2 * (((lane & 7) + 8 * (lane >> 4)) * ps + 8 * ((lane >> 3) & 1));
  // the warp's two m16 tiles: tile rows 2 warp + mi, image rows i0 + that
  const int row0 = 2 * warp;

  // the image's edges in this tile: their tile row (top, bottom) or
  // column (left, right), -1 when not there
  const int e_top = borders && i0 == 0 ? 0 : -1;
  const int e_bot = borders && H - 1 - i0 < kTile ? H - 1 - i0 : -1;
  const int e_left = borders && j0 == 0 ? 0 : -1;
  const int e_right = borders && W - 1 - j0 < kTile ? W - 1 - j0 : -1;
  // the border jobs: four per edge in this tile (kinds 0 top, 1 bottom,
  // 2 left, 3 right, in that order), one per phase (p, q); warp w runs
  // jobs w and w + 8.  Job n's edge is the (n / 4 + 1)-th set bit of
  // emask, its rows in eacc are slot kind * 4 + p * 2 + q.
  const unsigned emask = (e_top >= 0) | (e_bot >= 0) << 1 | (e_left >= 0) << 2 |
                         (e_right >= 0) << 3;
  const int n_jobs = 4 * __popc(emask);
  auto job_kind = [&](int n) { return (int)__fns(emask, 0, (n >> 2) + 1); };
  auto edge_pos = [&](int kind) {
    return kind == 0 ? e_top : kind == 1 ? e_bot : kind == 2 ? e_left : e_right;
  };
  const int k_a = warp < n_jobs ? job_kind(warp) : 0, p_a = (warp >> 1) & 1;

  // job n's products jacc into its rows of eacc (row: the m16 tile's pixel
  // g + 8 half, column ni*8 + 2t + j)
  auto add_job = [&](const float (&jacc)[kNT][4], int n, int kind) {
    float* er = eacc + (kind * 4 + n % 4) * kTile * kEP + 2 * t;
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* d = reinterpret_cast<float2*>(er + (g + 8 * h) * kEP + ni * 8);
        const float2 v = *d;
        *d = make_float2(v.x + jacc[ni][2 * h], v.y + jacc[ni][2 * h + 1]);
      }
  };
  float jacc_a[kNT][4] = {};    // the first border job's products

  float acc[2][2][2][kNT][4];   // [p][q][mi][ni][e]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][q][mi][ni][e] = 0.0f;

  // slab s's tile: x (and skip, summed at the slab's first stage) at image
  // (i0-2+ly, j0-2+lx), clamped, to tile buffer s & 1
  auto issue_tile = [&](int s) {
    const int c0 = s * kCS;
    const uint32_t dst = tiles_u + 2 * (s & 1) * kTileElems, dst_raw = smem_u32(raw);
    for (int i = threadIdx.x; i < kLoPix * n_vec; i += kThreads) {
      const int pix = i / n_vec, v = i % n_vec;
      const int ly = pix / kLo, lx = pix - ly * kLo;
      const int gy = min(max(i0 - 2 + ly, 0), H - 1);
      const int gx = min(max(j0 - 2 + lx, 0), W - 1);
      const size_t off = ((size_t)gy * W + gx) * C + c0 + v * 8;
      const uint32_t o = 2 * (pix * ps + v * 8);
      cp_async16(dst + o, xb + off);
      if (sb) cp_async16(dst_raw + o, sb + off);
    }
  };
  // stage k: slab k / 5, union row tap tr = k % 5; its 16 blocks [p][q][b]
  // of the phases with a = tr - p in 0..3 go to buffer k & 1
  auto issue_weights = [&](int k) {
    const int c0 = (k / 5) * kCS, tr = k % 5;
    const uint32_t dst = wbuf_u + 2 * (k & 1) * kStageElems;
    constexpr int per_block = kNC * n_vec;
#pragma unroll
    for (int it = 0; it < kStageBlocks * per_block / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int blk = idx / per_block, n = (idx / n_vec) % kNC, v = idx % n_vec;
      const int pl = blk >> 3, a = tr - pl;
      if (a < 0 || a > 3) continue;
      cp_async16(dst + 2 * ((blk * kNC + n) * ps + v * 8),
                 w + ((pl * 4 + a) * 8 + (blk & 7)) * blk_elems + (size_t)(co_base + n) * C +
                     c0 + v * 8);
    }
  };

  const int n_slabs = C / kCS, n_stages = n_slabs * 5;
  issue_tile(0);
  issue_weights(0);
  cp_async_commit();
  for (int k = 0; k < n_stages; ++k) {
    const int s = k / 5, tr = k - 5 * s, c0 = s * kCS;
    const uint32_t tile_u = tiles_u + 2 * (s & 1) * kTileElems;
    cp_async_wait_all();
    __syncthreads();   // stage k landed; every warp is done with stage k - 1
    if (tr == 0 && sb) {
      // x + skip, rounded to bf16, over this slab's x tile
      bf16* tl = tiles + (s & 1) * kTileElems;
      for (int i = threadIdx.x; i < kLoPix * n_vec; i += kThreads) {
        const int o = (i / n_vec) * ps + (i % n_vec) * 8;
        uint4 u = *reinterpret_cast<const uint4*>(tl + o);
        const uint4 r = *reinterpret_cast<const uint4*>(raw + o);
        uint32_t* pu = reinterpret_cast<uint32_t*>(&u);
        const uint32_t* pr = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = unpack_bf2(pu[e]), fb = unpack_bf2(pr[e]);
          pu[e] = pack_bf2(fa.x + fb.x, fa.y + fb.y);
        }
        *reinterpret_cast<uint4*>(tl + o) = u;
      }
      __syncthreads();   // the sum is in; the raw tile is free
    }
    if (k + 1 < n_stages) issue_weights(k + 1);
    if (tr == 0 && s + 1 < n_slabs) issue_tile(s + 1);
    cp_async_commit();

    // this warp's first border job's tap at tr (a row job's b = tr, a
    // column job's a = tr - p): its weights from L2, ahead of the products
    const bf16* wrow = w + (size_t)(co_base + g) * C + c0 + 2 * t;
    const int tap_a = k_a < 2 ? tr : tr - p_a;
    const bool on_a = warp < n_jobs && tap_a >= 0 && tap_a < 4;
    uint32_t bf_a[kNT][2];
    if (on_a) load_b(bf_a, wrow + (kMainBlocks + (k_a * 4 + warp % 4) * 4 + tap_a) * blk_elems, C);

    // the phase kernels: union taps (tr, tc), tc = 0..4
    const uint32_t wst = wbuf_u + 2 * (k & 1) * kStageElems;
#pragma unroll
    for (int tc = 0; tc < 5; ++tc) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(tile_u + 2 * ((row0 + mi + tr) * kLo + tc + pl15) * ps + a_k, a[mi]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (tr - p < 0 || tr - p > 3) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int bt = tc - q;
          if (bt < 0 || bt > 3) continue;
          const uint32_t wb = wst + b_lane + 2 * (p * 8 + q * 4 + bt) * kNC * ps;
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(wb + 2 * np * 16 * ps, bf);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[p][q][mi][2 * np], a[mi], bf[0], bf[1]);
              mma_bf16(acc[p][q][mi][2 * np + 1], a[mi], bf[2], bf[3]);
            }
          }
        }
      }
    }

    // border job n's tap at tr into jacc.  A row job's pixels are its
    // edge's tile row at columns (lane & 15), tap (2, q + tr); a column
    // job's its edge's tile column at rows (lane & 15), tap (tr, 2), and at
    // tr == 2 the corners' tap (2, 2) on the corner pixels (the other lanes
    // read the zero row).  bf: the tap's weights when on.
    auto run_job = [&](float (&jacc)[kNT][4], int n, int kind, bool on,
                       const uint32_t (&bf)[kNT][2]) {
      const int pos = edge_pos(kind);
      if (on) {
        const int pix =
            kind >= 2 ? (pl15 + tr) * kLo + pos + 2 : (pos + 2) * kLo + (n & 1) + tr + pl15;
        uint32_t a[4];
        ldmatrix_x4(tile_u + 2 * pix * ps + a_k, a);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_bf16(jacc[ni], a, bf[ni][0], bf[ni][1]);
      }
      if (kind >= 2 && tr == 2) {
#pragma unroll
        for (int vs = 0; vs < 2; ++vs) {
          const int rv = vs ? e_bot : e_top;
          if (rv < 0) continue;
          uint32_t a[4], cb[kNT][2];
          ldmatrix_x4(pl15 == rv ? tile_u + 2 * ((pl15 + 2) * kLo + pos + 2) * ps + a_k : zero_u,
                      a);
          load_b(cb,
                 wrow + (kMainBlocks + kEdgeBlocks + (vs * 2 + kind - 2) * 4 + n % 4) * blk_elems,
                 C);
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) mma_bf16(jacc[ni], a, cb[ni][0], cb[ni][1]);
        }
      }
    };
    // the first job's products stay in registers until the end: reading
    // them here would wait for this warp's whole queue of products
    if (warp < n_jobs) run_job(jacc_a, warp, k_a, on_a, bf_a);
    if (warp + kWarps < n_jobs) {
      // a second job (H or W at most 16): its weights read and its
      // products added into eacc here
      const int n = warp + kWarps, kind = job_kind(n), p = (n >> 1) & 1;
      const int tap = kind < 2 ? tr : tr - p;
      const bool on = tap >= 0 && tap < 4;
      uint32_t bf[kNT][2];
      if (on) load_b(bf, wrow + (kMainBlocks + (kind * 4 + n % 4) * 4 + tap) * blk_elems, C);
      float jacc[kNT][4] = {};
      run_job(jacc, n, kind, on, bf);
      add_job(jacc, n, kind);
    }
  }
  if (warp < n_jobs) add_job(jacc_a, warp, k_a);
  __syncthreads();   // the border jobs' rows are complete

  // epilogue: acc[p][q][mi][ni][2*half + j] is phase (p, q) of low-res pixel
  // (i0 + row0 + mi, j0 + g + 8*half), channel co_base + ni*8 + 2*t + j;
  // plus the border jobs of its edges (their weights are negated)
  const int W2 = 2 * W;
  bf16* ob = out + (size_t)b * 4 * H * W * Cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = row0 + mi, i = i0 + r;
    if (i >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = g + 8 * half, j = j0 + c;
      if (j >= W) continue;
      // eacc rows of this pixel's edge jobs, -1 where it is on no edge
      const int rows[4] = {r == e_top ? c : -1, r == e_bot ? c : -1, c == e_left ? r : -1,
                           c == e_right ? r : -1};
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bf16* op = ob + ((size_t)(2 * i + p) * W2 + 2 * j + q) * Cout;
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni) {
            const int ch = co_base + ni * 8 + 2 * t;
            if (ch >= Cout) continue;
            float v0 = acc[p][q][mi][ni][2 * half] + bias[ch];
            float v1 = acc[p][q][mi][ni][2 * half + 1] + bias[ch + 1];
#pragma unroll
            for (int kind = 0; kind < 4; ++kind) {
              if (rows[kind] < 0) continue;
              const float2 e = *reinterpret_cast<const float2*>(
                  eacc + ((kind * 4 + p * 2 + q) * kTile + rows[kind]) * kEP + ni * 8 + 2 * t);
              v0 += e.x;
              v1 += e.y;
            }
            if (relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            st_bf2(op + ch, v0, v1);
          }
        }
    }
  }
}

}  // namespace

extern "C" {

// Launches one layer on `stream`.  x, skip (or null): [B,H,W,C]
// contiguous; w: [144,Cp,C] (ops/upsample_conv.py::kernel_weights: the
// phase kernels, the negated edge terms, the corner terms; rows past Cout
// zero) contiguous; all bf16 and 16-byte aligned; bias: [Cout] f32; out:
// [B,2H,2W,Cout] bf16 contiguous.  C % 16 == 0, Cout % 8 == 0, Cp a
// multiple of nc >= Cout, nc == 32 (the wrapper checks).  relu: apply
// ReLU after the bias.  borders: 0 skips the border terms (wrong on the
// outer two 2x rows and columns; for timing their share).  Returns the
// cudaError_t of the launch.
int ramnet_upsample_conv_forward(const void* x, const void* skip, const void* w,
                                 const void* bias, void* out, int B, int H, int W,
                                 int C, int Cout, int Cp, int nc, int relu, int borders,
                                 void* stream) {
  if (nc != kNC || Cp % kNC || C % kCS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = Cp / kNC;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B * n_slices);
  upsample_conv_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, C, Cout, Cp, n_slices, relu, borders);
  return (int)cudaGetLastError();
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
