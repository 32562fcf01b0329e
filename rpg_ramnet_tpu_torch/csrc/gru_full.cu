// The whole ConvGRU cell (kernel K5) for NVIDIA Hopper, sm_90a: the
// per-package streaming path, where no precomputed x-side gates exist.
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_hside.py::_run_full
// with _full_kernel (entry point conv_gru_full_fused).  From the encoder
// output x [B,H,W,C] and the state h [B,H,W,C] (the encoder width equals
// the hidden width on every RAM-Net scale), with the gate weights on
// cat(x, h) and float32 biases:
//
//     z = sigmoid(conv3x3([x|h], Wz) + bz)    r = sigmoid(conv3x3([x|h], Wr) + br)
//     a = bf16(r * h)                          o = tanh(conv3x3([x|a], Wo) + bo)
//     h' = h * (1 - z) + o * z
//
// with zero padding at the image border, f32 accumulation and gates, bf16
// I/O.  The x half of the out gate's operand is x itself, not r * x.
//
// What bounds it on this card.  Per pixel the cell must move x, h and h'
// (6*C bytes) and do 54*C^2 multiply-adds (36*C^2 for [z|r] with a
// contraction of 2C, 18*C^2 for o): 18*C flop per byte, 1152 to 4608 at the
// flagship widths C = 64, 128, 256, far above the H100's bf16 tensor-core
// ridge (~295 flop/B).  At 1x128x256x64, 1x64x128x128 and 1x32x64x256 the
// cell is 14.5 GFLOP, about 15 us at the 989 TFLOP/s bf16 peak.  So the
// convs belong on the tensor cores, fed from shared memory.
//
// What the design does about it.  It is K1's design (gru_hside.cu,
// mma_conv.cuh) with a contraction of 2C: one launch per cell, one block
// per TH x TW output tile, nothing but x, h and h' in device memory.  The
// block stages [x | h] with a 2-pixel halo at a pixel pitch of 2C + 8
// (zero outside the image).  The ring pass computes r on the tile plus a
// 1-pixel ring (the conv over [x|h], K = 2C) and writes a = bf16(r*h) to
// shared memory at pitch C + 8, zero outside the image, which is exactly
// the zero padding of the out gate's conv.  The tile pass computes z (the
// same conv) and o as two implicit GEMMs into one accumulator: over the x
// half of the staged tile and over a, each with K = C against its half of
// Wo's columns.  The TPU kernel recomputes its row halo the same way
// (gru_hside.py:751-773); blocks here exchange nothing.  The wrapper picks
// the tile per C from this kernel's own shared-memory footprint
// (ops/gru_hside.py::smem_bytes_full).

#include "mma_conv.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
gru_full_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                const bf16* __restrict__ w_ur, const bf16* __restrict__ w_o,
                const float* __restrict__ b_ur, const float* __restrict__ b_o,
                bf16* __restrict__ out, int H, int W, int C, int TH, int TW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C2 = 2 * C;
  const int ps = C2 + kPad;             // [x | h] pixel pitch
  const int pa = C + kPad;              // a pixel pitch
  const int hw = TW + 4, hh = TH + 4;   // [x | h] tile with a 2-pixel halo
  const int aw = TW + 2, ah = TH + 2;   // a tile with a 1-pixel ring
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = xs + hh * hw * ps;
  const uint32_t xs_u = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t as_u = (uint32_t)__cvta_generic_to_shared(as);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W * C;
  const bf16* xb = x + (size_t)b * plane;
  const bf16* hb = h + (size_t)b * plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = C / (8 * kNI);

  // 1. [x | h] tile: image rows y0-2 .. y0+TH+1 (and columns alike), 0
  //    outside; 16-byte vectors, the first C/8 of a pixel from x.
  const int n_vec = C / 8;
  for (int i = threadIdx.x; i < hh * hw * 2 * n_vec; i += kThreads) {
    const int pix = i / (2 * n_vec), v = i - pix * 2 * n_vec;
    const int py = pix / hw, px = pix - py * hw;
    const int gy = y0 - 2 + py, gx_ = x0 - 2 + px;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx_ >= 0 && gx_ < W) {
      const bool is_x = v < n_vec;
      const bf16* src = (is_x ? xb : hb) + ((size_t)gy * W + gx_) * C;
      val = __ldg(reinterpret_cast<const uint4*>(src + (is_x ? v : v - n_vec) * 8));
    }
    *reinterpret_cast<uint4*>(xs + pix * ps + v * 8) = val;
  }
  __syncthreads();

  // 2. Reset gate and a = bf16(r * h) on the tile plus its 1-pixel ring:
  //    a-tile pixel (ry, rx) is image (y0-1+ry, x0-1+rx); its conv taps
  //    start at [x|h]-tile pixel (ry, rx).
  const int n_a = ah * aw;
  const int items_a = ((n_a + 16 * kMI - 1) / (16 * kMI)) * n_groups;
  for (int item = warp; item < items_a; item += kWarps) {
    const int m0 = (item / n_groups) * 16 * kMI;
    const int co0 = (item % n_groups) * 8 * kNI;
    uint32_t a_addr[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int q = min(m0 + mi * 16 + (lane & 15), n_a - 1);
      const int ry = q / aw, rx = q - ry * aw;
      a_addr[mi] = xs_u + 2 * ((ry * hw + rx) * ps + (lane >> 4) * 8);
    }
    Acc acc;
    zero(acc);
    conv3x3_mma(acc, a_addr, 2 * hw * ps, 2 * ps, w_ur, C2, C2, C + co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + g + 8 * half;
        if (q >= n_a) continue;
        const int ry = q / aw, rx = q - ry * aw;
        const int gy = y0 - 1 + ry, gx_ = x0 - 1 + rx;
        const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          float a0 = 0.0f, a1 = 0.0f;
          if (inside) {
            const float2 br = __ldg(reinterpret_cast<const float2*>(b_ur + C + ch));
            const float2 hv = ld_bf2(xs + ((ry + 1) * hw + rx + 1) * ps + C + ch);
            a0 = sigmoid_f(acc[mi][ni][2 * half] + br.x) * hv.x;
            a1 = sigmoid_f(acc[mi][ni][2 * half + 1] + br.y) * hv.y;
          }
          st_bf2(as + q * pa + ch, a0, a1);
        }
      }
    }
  }
  __syncthreads();

  // 3. Update gate, out gate on [x | a], and h' for the TH x TW tile:
  //    output pixel (cy, cx) is image (y0+cy, x0+cx); its taps start at
  //    [x|h]-tile pixel (cy+1, cx+1) and a-tile pixel (cy, cx).
  const int n_c = TH * TW;
  const int items_c = ((n_c + 16 * kMI - 1) / (16 * kMI)) * n_groups;
  for (int item = warp; item < items_c; item += kWarps) {
    const int m0 = (item / n_groups) * 16 * kMI;
    const int co0 = (item % n_groups) * 8 * kNI;
    uint32_t x_addr[kMI], a_addr[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
      const int cy = q / TW, cx = q - cy * TW;
      x_addr[mi] = xs_u + 2 * (((cy + 1) * hw + cx + 1) * ps + (lane >> 4) * 8);
      a_addr[mi] = as_u + 2 * ((cy * aw + cx) * pa + (lane >> 4) * 8);
    }
    Acc accz, acco;
    zero(accz);
    zero(acco);
    conv3x3_mma(accz, x_addr, 2 * hw * ps, 2 * ps, w_ur, C2, C2, co0, lane);
    conv3x3_mma_ld(acco, x_addr, 2 * hw * ps, 2 * ps, w_o, C, C2, C, co0, lane);
    conv3x3_mma_ld(acco, a_addr, 2 * aw * pa, 2 * pa, w_o + C, C, C2, C, co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + g + 8 * half;
        if (q >= n_c) continue;
        const int cy = q / TW, cx = q - cy * TW;
        const int gy = y0 + cy, gx_ = x0 + cx;
        if (gy >= H || gx_ >= W) continue;
        bf16* op = out + (((size_t)b * H + gy) * W + gx_) * C;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          const float2 bz = __ldg(reinterpret_cast<const float2*>(b_ur + ch));
          const float2 bo = __ldg(reinterpret_cast<const float2*>(b_o + ch));
          const float2 hv = ld_bf2(xs + ((cy + 2) * hw + cx + 2) * ps + C + ch);
          const float z0 = sigmoid_f(accz[mi][ni][2 * half] + bz.x);
          const float z1 = sigmoid_f(accz[mi][ni][2 * half + 1] + bz.y);
          const float o0 = tanhf(acco[mi][ni][2 * half] + bo.x);
          const float o1 = tanhf(acco[mi][ni][2 * half + 1] + bo.y);
          st_bf2(op + ch, hv.x * (1.0f - z0) + o0 * z0, hv.y * (1.0f - z1) + o1 * z1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches one cell on `stream`.  x, h, out: [B,H,W,C] contiguous bf16;
// w_ur [9,2C,2C] (update rows, then reset rows; x columns, then h
// columns), w_o [9,C,2C], each [tap][out][in] bf16; b_ur [2C], b_o [C]
// float32.  All 16-byte aligned, C % 16 == 0 (the wrapper checks).
// Returns the cudaError_t of the launch.
int ramnet_gru_full_forward(const void* x, const void* h, const void* w_ur,
                            const void* w_o, const void* b_ur, const void* b_o,
                            void* out, int B, int H, int W, int C, int tile_h,
                            int tile_w, void* stream) {
  // the [x|h] tile with its 2-pixel halo and the a tile with its 1-pixel
  // ring (ops/gru_hside.py::smem_bytes_full computes the same)
  const size_t smem =
      ((size_t)(tile_h + 4) * (tile_w + 4) * (size_t)(2 * C + kPad) +
       (size_t)(tile_h + 2) * (tile_w + 2) * (size_t)(C + kPad)) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      gru_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  gru_full_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(h),
      static_cast<const bf16*>(w_ur), static_cast<const bf16*>(w_o),
      static_cast<const float*>(b_ur), static_cast<const float*>(b_o),
      static_cast<bf16*>(out), H, W, C, tile_h, tile_w);
  return (int)cudaGetLastError();
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
