// The implicit-GEMM 3x3 convolution on the tensor cores of the first
// kernel design that K9 and K10b still run (gru_cell.cuh), and the
// mma.sync and ldmatrix primitives every ConvGRU and ConvLSTM tile shares
// (gru_hside_tile.cuh and the tiles that include it).
//
// A block stages its source pixels in shared memory at a pixel pitch of
// K + kPad bf16 elements; a warp owns one item of 32 pixels x 16 output
// channels and accumulates the 3x3 conv as 9 taps x K/16 mma.sync m16n8k16
// steps (bf16 in, f32 accumulate).  A fragments come from the staged tile
// by ldmatrix, one row address per pixel and tap, so the 2-D window needs
// no im2col copy; B fragments come straight from the folded weights
// [9][w_rows][K] (tap, output channel, input channel: K-contiguous), which
// stay resident in L1/L2.  A pitch of K + 8 elements keeps the ldmatrix
// rows 16-byte aligned and the 8 rows of one phase in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;   // pixel pitch K + kPad elements
constexpr int kMI = 2;    // m16 tiles per warp item: 32 pixels
constexpr int kNI = 2;    // n8 tiles per warp item: 16 channels

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

typedef float Acc[kMI][kNI][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
}

// acc += the 3x3 conv of a 32-pixel x 16-channel warp item.  a_addr[mi]:
// this lane's ldmatrix row address (shared-space bytes) for m16 tile mi:
// pixel (lane & 15) of the tile at its top-left tap, plus (lane >> 4) * 8
// elements.  row_b, pix_b: row and pixel pitch of the source tile in bytes.
// w: [9][w_rows][w_ld] bf16, of which the item contracts the first K
// columns; K: the contraction length (input channels, a multiple of 16);
// co0: first output row of the item.  Accumulator layout (mma.sync):
// acc[mi][ni][2*half + j] is pixel mi*16 + lane/4 + 8*half, channel
// co0 + ni*8 + 2*(lane%4) + j.
__device__ __forceinline__ void conv3x3_mma_ld(Acc& acc, const uint32_t (&a_addr)[kMI],
                                               int row_b, int pix_b,
                                               const bf16* __restrict__ w, int w_rows,
                                               int w_ld, int K, int co0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const uint32_t off = (uint32_t)(ky * row_b + kx * pix_b);
      const bf16* wt = w + ((size_t)(ky * 3 + kx) * w_rows + co0 + g) * w_ld + 2 * t;
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) ldmatrix_x4(a_addr[mi] + off + 2 * k0, a[mi]);
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const bf16* wp = wt + (size_t)ni * 8 * w_ld + k0;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
        }
      }
    }
  }
}

// conv3x3_mma_ld over weights whose rows are exactly K long.
__device__ __forceinline__ void conv3x3_mma(Acc& acc, const uint32_t (&a_addr)[kMI],
                                            int row_b, int pix_b,
                                            const bf16* __restrict__ w, int w_rows,
                                            int K, int co0, int lane) {
  conv3x3_mma_ld(acc, a_addr, row_b, pix_b, w, w_rows, K, K, co0, lane);
}

}  // namespace
