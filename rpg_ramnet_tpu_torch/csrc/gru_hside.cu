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
// byte, 346 to 1382 at the flagship widths C = 64, 128, 256, above the
// H100's bf16 tensor-core ridge (~295 flop/B).  So the convs belong on the
// tensor cores, and the cell is bound by how well they are fed: the
// operand loads from shared memory (h, a) and from L1/L2 (the weights).
//
// What the design does about it.  As on the TPU, nothing but h, gx, h' (and
// acts) touches device memory: one launch per cell, one block per TH x TW
// output tile.  The block stages h with a 2-pixel halo in shared memory,
// computes r and a = bf16(r*h) on the tile plus a 1-pixel ring (a is 0
// outside the image, which is exactly the zero padding of conv(r*h)), keeps
// a in shared memory, then computes z, o and h' for the tile.  Each 3x3
// conv is an implicit GEMM on the tensor cores (mma_conv.cuh).  wgmma and
// TMA are the next steps.  The wrapper picks the tile per C
// (ops/gru_hside.py).

#include "mma_conv.cuh"

namespace {

template <bool kRes>
__global__ void __launch_bounds__(kThreads)
gru_hside_kernel(const bf16* __restrict__ h, const bf16* __restrict__ gx,
                 const bf16* __restrict__ w_ur, const bf16* __restrict__ w_o,
                 bf16* __restrict__ out, bf16* __restrict__ acts, int H, int W,
                 int C, long long gx_bstride, int TH, int TW) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ps = C + kPad;              // pixel pitch in shared memory
  const int hw = TW + 4, hh = TH + 4;   // h tile with a 2-pixel halo
  const int aw = TW + 2, ah = TH + 2;   // a tile with a 1-pixel ring
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = hs + hh * hw * ps;
  const uint32_t hs_u = (uint32_t)__cvta_generic_to_shared(hs);
  const uint32_t as_u = (uint32_t)__cvta_generic_to_shared(as);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const bf16* hb = h + (size_t)b * H * W * C;
  const bf16* gb = gx + (size_t)b * gx_bstride;
  const int C3 = 3 * C;
  bf16* actb = kRes ? acts + (size_t)b * H * W * C3 : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_groups = C / (8 * kNI);

  // 1. h tile: image rows y0-2 .. y0+TH+1 (and columns alike), 0 outside.
  const int n_vec = C / 8;
  for (int i = threadIdx.x; i < hh * hw * n_vec; i += kThreads) {
    const int pix = i / n_vec, v = i - pix * n_vec;
    const int py = pix / hw, px = pix - py * hw;
    const int gy = y0 - 2 + py, gx_ = x0 - 2 + px;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx_ >= 0 && gx_ < W) {
      val = __ldg(reinterpret_cast<const uint4*>(hb + ((size_t)gy * W + gx_) * C + v * 8));
    }
    *reinterpret_cast<uint4*>(hs + pix * ps + v * 8) = val;
  }
  __syncthreads();

  // 2. Reset gate and a = bf16(r * h) on the tile plus its 1-pixel ring:
  //    a-tile pixel (ry, rx) is image (y0-1+ry, x0-1+rx); its conv taps
  //    start at h-tile pixel (ry, rx).  K1-res stores r at the tile.
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
      a_addr[mi] = hs_u + 2 * ((ry * hw + rx) * ps + (lane >> 4) * 8);
    }
    Acc acc;
    zero(acc);
    conv3x3_mma(acc, a_addr, 2 * hw * ps, 2 * ps, w_ur, 2 * C, C, C + co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + g + 8 * half;
        if (q >= n_a) continue;
        const int ry = q / aw, rx = q - ry * aw;
        const int gy = y0 - 1 + ry, gx_ = x0 - 1 + rx;
        const bool inside = gy >= 0 && gy < H && gx_ >= 0 && gx_ < W;
        const bool center = ry >= 1 && ry <= TH && rx >= 1 && rx <= TW;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          float a0 = 0.0f, a1 = 0.0f;
          if (inside) {
            const float2 gr = ld_bf2(gb + ((size_t)gy * W + gx_) * C3 + C + ch);
            const float2 hv = ld_bf2(hs + ((ry + 1) * hw + rx + 1) * ps + ch);
            const float r0 = sigmoid_f(acc[mi][ni][2 * half] + gr.x);
            const float r1 = sigmoid_f(acc[mi][ni][2 * half + 1] + gr.y);
            a0 = r0 * hv.x;
            a1 = r1 * hv.y;
            if (kRes && center) st_bf2(actb + ((size_t)gy * W + gx_) * C3 + C + ch, r0, r1);
          }
          st_bf2(as + q * ps + ch, a0, a1);
        }
      }
    }
  }
  __syncthreads();

  // 3. Update gate, out gate on a, and h' for the TH x TW tile: output
  //    pixel (cy, cx) is image (y0+cy, x0+cx); its taps start at h-tile
  //    pixel (cy+1, cx+1) and a-tile pixel (cy, cx).  K1-res stores z, o.
  const int n_c = TH * TW;
  const int items_c = ((n_c + 16 * kMI - 1) / (16 * kMI)) * n_groups;
  for (int item = warp; item < items_c; item += kWarps) {
    const int m0 = (item / n_groups) * 16 * kMI;
    const int co0 = (item % n_groups) * 8 * kNI;
    uint32_t h_addr[kMI], a_addr[kMI];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int q = min(m0 + mi * 16 + (lane & 15), n_c - 1);
      const int cy = q / TW, cx = q - cy * TW;
      h_addr[mi] = hs_u + 2 * (((cy + 1) * hw + cx + 1) * ps + (lane >> 4) * 8);
      a_addr[mi] = as_u + 2 * ((cy * aw + cx) * ps + (lane >> 4) * 8);
    }
    Acc accz, acco;
    zero(accz);
    zero(acco);
    conv3x3_mma(accz, h_addr, 2 * hw * ps, 2 * ps, w_ur, 2 * C, C, co0, lane);
    conv3x3_mma(acco, a_addr, 2 * aw * ps, 2 * ps, w_o, C, C, co0, lane);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + mi * 16 + g + 8 * half;
        if (q >= n_c) continue;
        const int cy = q / TW, cx = q - cy * TW;
        const int gy = y0 + cy, gx_ = x0 + cx;
        if (gy >= H || gx_ >= W) continue;
        const bf16* gp = gb + ((size_t)gy * W + gx_) * C3;
        bf16* op = out + (((size_t)b * H + gy) * W + gx_) * C;
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int ch = co0 + ni * 8 + 2 * t;
          const float2 gz = ld_bf2(gp + ch);
          const float2 go = ld_bf2(gp + 2 * C + ch);
          const float2 hv = ld_bf2(hs + ((cy + 2) * hw + cx + 2) * ps + ch);
          const float z0 = sigmoid_f(accz[mi][ni][2 * half] + gz.x);
          const float z1 = sigmoid_f(accz[mi][ni][2 * half + 1] + gz.y);
          const float o0 = tanhf(acco[mi][ni][2 * half] + go.x);
          const float o1 = tanhf(acco[mi][ni][2 * half + 1] + go.y);
          st_bf2(op + ch, hv.x * (1.0f - z0) + o0 * z0, hv.y * (1.0f - z1) + o1 * z1);
          if (kRes) {
            bf16* ap = actb + ((size_t)gy * W + gx_) * C3;
            st_bf2(ap + ch, z0, z1);
            st_bf2(ap + 2 * C + ch, o0, o1);
          }
        }
      }
    }
  }
}

template <bool kRes>
int launch(const void* h, const void* gx, const void* w_ur, const void* w_o,
           void* out, void* acts, int B, int H, int W, int C,
           long long gx_bstride, int tile_h, int tile_w, void* stream) {
  // the h tile with its 2-pixel halo and the a tile with its 1-pixel ring
  // (ops/gru_hside.py::smem_bytes computes the same)
  const size_t smem =
      ((size_t)(tile_h + 4) * (tile_w + 4) + (size_t)(tile_h + 2) * (tile_w + 2)) *
      (size_t)(C + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      gru_hside_kernel<kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  gru_hside_kernel<kRes><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(gx),
      static_cast<const bf16*>(w_ur), static_cast<const bf16*>(w_o),
      static_cast<bf16*>(out), static_cast<bf16*>(acts), H, W, C, gx_bstride,
      tile_h, tile_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one cell on `stream`.  h, out: [B,H,W,C] contiguous; gx: [H,W,3C]
// contiguous per batch item, batch items gx_bstride elements apart;
// w_ur [9,2C,C] (update rows, then reset rows), w_o [9,C,C], each
// [tap][out][in].  All bf16, all 16-byte aligned, C % 16 == 0 (the
// wrapper checks).  Returns the cudaError_t of the launch.
int ramnet_gru_hside_forward(const void* h, const void* gx, const void* w_ur,
                             const void* w_o, void* out, int B, int H, int W,
                             int C, long long gx_bstride, int tile_h,
                             int tile_w, void* stream) {
  return launch<false>(h, gx, w_ur, w_o, out, nullptr, B, H, W, C, gx_bstride,
                       tile_h, tile_w, stream);
}

// The same cell, also writing acts [B,H,W,3C] = bf16(concat(z, r, o)),
// contiguous.
int ramnet_gru_hside_forward_res(const void* h, const void* gx, const void* w_ur,
                                 const void* w_o, void* out, void* acts, int B,
                                 int H, int W, int C, long long gx_bstride,
                                 int tile_h, int tile_w, void* stream) {
  return launch<true>(h, gx, w_ur, w_o, out, acts, B, H, W, C, gx_bstride,
                      tile_h, tile_w, stream);
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
