// Backward of the fused ConvGRU h-side cell (kernel K2) for NVIDIA Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/gru_hside.py::_run_bwd
// with _bwd_kernel.  From the cotangent g of h' [B,H,W,C], the state h
// [B,H,W,C] and the forward's gate activations acts = (z, r, o) [B,H,W,3C]
// (K1-res, gru_hside.cu), it computes the state and x-gate cotangents:
//
//     dpre_o = g * z * (1 - o^2)
//     da     = convT3x3(bf16(dpre_o), Wo)            (the cotangent of a = r*h)
//     dpre_r = da * h * r * (1 - r)
//     dpre_z = g * (o - h) * z * (1 - z)
//     dh     = g * (1 - z) + da * r + convT3x3(bf16([dpre_z | dpre_r]), Wur)
//     dgx    = bf16([dpre_z | dpre_r | dpre_o])
//
// convT is the cotangent of a 3x3 'same' conv: a correlation with the
// spatially flipped, in/out-swapped weights, which the wrapper folds as
// wb_o [9][C][C] and wb_ur [9][C][2C] ([tap][out][in], the layout K1 reads).
// Rows and columns outside the image are zero in g and h, which reproduces
// the conv's zero padding.  The weight gradients are library convolutions
// in the wrapper (as the JAX package leaves _dconv_w to XLA).
//
// What bounds it on this card.  Per pixel it reads g, h, acts and writes dh,
// dgx (18*C bytes) and does 27*C^2 multiply-adds in its two transposed
// convs (9*C^2 for da, 18*C^2 for dh): 3*C flop per byte, 192 to 768 at
// C = 64..256, at or above the bf16 tensor-core ridge (~295 flop/B) for the
// wider scales.  So, as in K1, the convs run on the tensor cores and the
// rest stays out of device memory.
//
// What the design does about it.  One launch per cell, one block per
// TH x TW output tile, three phases with only shared memory between them:
//   1. dpre_o on the tile plus a 2-pixel ring, from g, z, o read once from
//      device memory, staged as bf16 (da's conv reads one pixel beyond the
//      ring that dpre_ur's conv reads);
//   2. da on the tile plus a 1-pixel ring (implicit GEMM over dpre_o, K=C);
//      its epilogue forms dpre_r and dpre_z there and stages [dpre_z |
//      dpre_r] as bf16, and keeps da*r at the tile in f32;
//   3. dh on the tile (implicit GEMM over [dpre_z | dpre_r], K=2C) plus the
//      elementwise terms.
// dgx is written where each part is formed.  The gates are read gate by
// gate where they are used rather than staged whole, which keeps the
// shared memory to the two bf16 operand tiles and one f32 tile; the
// wrapper picks the tile per C (ops/gru_hside.py::pick_tile).

#include "mma_conv.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
gru_hside_bwd_kernel(const bf16* __restrict__ g_in, const bf16* __restrict__ h,
                     const bf16* __restrict__ acts, const bf16* __restrict__ wb_ur,
                     const bf16* __restrict__ wb_o, bf16* __restrict__ dh,
                     bf16* __restrict__ dgx, int H, int W, int C, int TH, int TW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ps_o = C + kPad, ps_u = 2 * C + kPad;   // pixel pitches
  const int ow = TW + 4, oh = TH + 4;   // dpre_o: the tile plus a 2-pixel ring
  const int uw = TW + 2, uh = TH + 2;   // [dpre_z | dpre_r]: plus a 1-pixel ring
  bf16* os = reinterpret_cast<bf16*>(smem_raw);
  bf16* us = os + oh * ow * ps_o;
  float* dar = reinterpret_cast<float*>(us + uh * uw * ps_u);   // da*r, [TH*TW][C]
  const uint32_t os_u = (uint32_t)__cvta_generic_to_shared(os);
  const uint32_t us_u = (uint32_t)__cvta_generic_to_shared(us);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t img = (size_t)b * H * W;
  const int C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane >> 2, t = lane & 3;
  const int n_groups = C / (8 * kNI);

  // 1. dpre_o on the 2-pixel ring: ring pixel (py, px) is image
  //    (y0-2+py, x0-2+px); 0 outside the image.  dgx_o at the tile.
  const int n_pair = C / 2;
  for (int i = threadIdx.x; i < oh * ow * n_pair; i += kThreads) {
    const int pix = i / n_pair, c2 = 2 * (i - pix * n_pair);
    const int py = pix / ow, px = pix - py * ow;
    const int gy = y0 - 2 + py, gx_ = x0 - 2 + px;
    float d0 = 0.0f, d1 = 0.0f;
    if (gy >= 0 && gy < H && gx_ >= 0 && gx_ < W) {
      const size_t p = img + (size_t)gy * W + gx_;
      const float2 gv = ld_bf2(g_in + p * C + c2);
      const float2 zv = ld_bf2(acts + p * C3 + c2);
      const float2 ov = ld_bf2(acts + p * C3 + 2 * C + c2);
      d0 = gv.x * zv.x * (1.0f - ov.x * ov.x);
      d1 = gv.y * zv.y * (1.0f - ov.y * ov.y);
      if (py >= 2 && py < TH + 2 && px >= 2 && px < TW + 2)
        st_bf2(dgx + p * C3 + 2 * C + c2, d0, d1);
    }
    st_bf2(os + pix * ps_o + c2, d0, d1);
  }
  __syncthreads();

  // 2. da = convT(dpre_o, Wo) on the 1-pixel ring: ring pixel (ry, rx) is
  //    image (y0-1+ry, x0-1+rx); its taps start at dpre_o pixel (ry, rx).
  const int n_u = uh * uw;
  const int items_u = ((n_u + 16 * kMI - 1) / (16 * kMI)) * n_groups;
  for (int item = warp; item < items_u; item += kWarps) {
    const int m0 = (item / n_groups) * 16 * kMI;
    const int co0 = (item % n_groups) * 8 * kNI;
    uint32_t a_addr[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int q = min(m0 + mi * 16 + (lane & 15), n_u - 1);
      const int ry = q / uw, rx = q - ry * uw;
      a_addr[mi] = os_u + 2 * ((ry * ow + rx) * ps_o + (lane >> 4) * 8);
    }
    Acc acc;
    zero(acc);
    conv3x3_mma(acc, a_addr, 2 * ow * ps_o, 2 * ps_o, wb_o, C, C, co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + gl + 8 * half;
        if (q >= n_u) continue;
        const int ry = q / uw, rx = q - ry * uw;
        const int gy = y0 - 1 + ry, gx_ = x0 - 1 + rx;
        const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
        const bool center = ry >= 1 && ry <= TH && rx >= 1 && rx <= TW;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          float z0 = 0.0f, z1 = 0.0f, r0 = 0.0f, r1 = 0.0f;   // dpre_z, dpre_r
          if (inside) {
            const size_t p = img + (size_t)gy * W + gx_;
            const float2 gv = ld_bf2(g_in + p * C + ch);
            const float2 hv = ld_bf2(h + p * C + ch);
            const float2 zv = ld_bf2(acts + p * C3 + ch);
            const float2 rv = ld_bf2(acts + p * C3 + C + ch);
            const float2 ov = ld_bf2(acts + p * C3 + 2 * C + ch);
            const float da0 = acc[mi][ni][2 * half], da1 = acc[mi][ni][2 * half + 1];
            r0 = da0 * hv.x * rv.x * (1.0f - rv.x);
            r1 = da1 * hv.y * rv.y * (1.0f - rv.y);
            z0 = gv.x * (ov.x - hv.x) * zv.x * (1.0f - zv.x);
            z1 = gv.y * (ov.y - hv.y) * zv.y * (1.0f - zv.y);
            if (center) {
              float* dp = dar + ((ry - 1) * TW + rx - 1) * C + ch;
              dp[0] = da0 * rv.x;
              dp[1] = da1 * rv.y;
              st_bf2(dgx + p * C3 + ch, z0, z1);
              st_bf2(dgx + p * C3 + C + ch, r0, r1);
            }
          }
          st_bf2(us + q * ps_u + ch, z0, z1);
          st_bf2(us + q * ps_u + C + ch, r0, r1);
        }
      }
    }
  }
  __syncthreads();

  // 3. dh on the tile: output pixel (cy, cx) is image (y0+cy, x0+cx); its
  //    taps start at ring pixel (cy, cx) of [dpre_z | dpre_r].
  const int n_c = TH * TW;
  const int items_c = ((n_c + 16 * kMI - 1) / (16 * kMI)) * n_groups;
  for (int item = warp; item < items_c; item += kWarps) {
    const int m0 = (item / n_groups) * 16 * kMI;
    const int co0 = (item % n_groups) * 8 * kNI;
    uint32_t a_addr[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
      const int cy = q / TW, cx = q - cy * TW;
      a_addr[mi] = us_u + 2 * ((cy * uw + cx) * ps_u + (lane >> 4) * 8);
    }
    Acc acc;
    zero(acc);
    conv3x3_mma(acc, a_addr, 2 * uw * ps_u, 2 * ps_u, wb_ur, C, 2 * C, co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + gl + 8 * half;
        if (q >= n_c) continue;
        const int cy = q / TW, cx = q - cy * TW;
        const int gy = y0 + cy, gx_ = x0 + cx;
        if (gy >= H || gx_ >= W) continue;
        const size_t p = img + (size_t)gy * W + gx_;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          const float2 gv = ld_bf2(g_in + p * C + ch);
          const float2 zv = ld_bf2(acts + p * C3 + ch);
          const float* dp = dar + q * C + ch;
          st_bf2(dh + p * C + ch,
                 gv.x * (1.0f - zv.x) + dp[0] + acc[mi][ni][2 * half],
                 gv.y * (1.0f - zv.y) + dp[1] + acc[mi][ni][2 * half + 1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches one cell's backward on `stream`.  g, h, dh: [B,H,W,C]; acts,
// dgx: [B,H,W,3C]; wb_ur [9,C,2C], wb_o [9,C,C] ([tap][out][in], flipped and
// in/out-swapped forward weights).  All bf16, contiguous, 16-byte aligned,
// C % 16 == 0 (the wrapper checks).  Returns the cudaError_t of the launch.
int ramnet_gru_hside_backward(const void* g, const void* h, const void* acts,
                              const void* wb_ur, const void* wb_o, void* dh,
                              void* dgx, int B, int H, int W, int C, int tile_h,
                              int tile_w, void* stream) {
  // ops/gru_hside.py::smem_bytes_bwd computes the same
  const size_t smem =
      (size_t)(tile_h + 4) * (tile_w + 4) * (C + kPad) * sizeof(bf16) +
      (size_t)(tile_h + 2) * (tile_w + 2) * (2 * C + kPad) * sizeof(bf16) +
      (size_t)tile_h * tile_w * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_hside_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  gru_hside_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(h),
      static_cast<const bf16*>(acts), static_cast<const bf16*>(wb_ur),
      static_cast<const bf16*>(wb_o), static_cast<bf16*>(dh),
      static_cast<bf16*>(dgx), H, W, C, tile_h, tile_w);
  return (int)cudaGetLastError();
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
