// The mma.sync and ldmatrix primitives and the block shape that every
// ConvGRU and ConvLSTM tile (gru_hside_tile.cuh and the tiles that include
// it) and the decoder kernel (upsample_conv.cu) share.
//
// A block stages its source pixels in shared memory at a pixel pitch of
// K + kPad bf16 elements, so each 3x3 conv is an implicit GEMM: A
// fragments come from the staged tile by ldmatrix, one row address per
// pixel and tap, with no im2col copy, and each m16n8k16 mma.sync adds a
// 16-pixel x 8-channel x 16-input product (bf16 in, f32 accumulate).  A
// pitch of K + 8 elements keeps the ldmatrix rows 16-byte aligned and the
// 8 rows of one phase in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;   // pixel pitch K + kPad elements

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

}  // namespace
