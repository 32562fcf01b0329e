// Fused decoder layer (kernel K8) for NVIDIA Hopper, sm_90a:
//
//     out = relu(conv5x5(upsample2x_bilinear(x + skip), W) + b)
//
// Replaces the Pallas TPU kernel rpg_ramnet_tpu/ops/upsample_conv.py::_run
// with _kernel.  The bilinear resize is half-pixel (align_corners=False)
// with its edge clamp; the conv pads the 2x image with zeros.  x, skip
// [B,H,W,C] and out [B,2H,2W,Cout] are NHWC bf16; the sum, the upsampled
// values and out are rounded to bf16 as the plain two-stage layer rounds
// them; the conv accumulates in f32.
//
// What bounds it on this card.  Per output pixel the layer does 25*C*Cout
// multiply-adds on the 2x image (16*C*Cout if the upsample were composed
// into four phase kernels) and moves x, skip and out once: at the flagship
// widths (C, Cout) = (256, 128), (128, 64), (64, 32) that is 1,600 to
// 6,400 flop per byte, far above the H100's bf16 ridge (~295 flop/B).  So
// the conv belongs on the tensor cores, and the layer is bound by how well
// they are fed.
//
// What the design does about it.  The 2x image never touches device
// memory.  One block owns a 16 x 16 tile of output pixels and up to 64
// output channels.  Per slab of CS input channels it stages the low-res
// x + skip tile with a 2-pixel halo, clamped to the image (the resize's
// replicate rule), in shared memory; builds from it the 2x tile with a
// 2-pixel halo, zero wherever the 2x pixel lies outside the image (exactly
// the conv's zero padding, so no border corrections are needed); and runs
// the 5x5 conv as an implicit GEMM on mma.sync m16n8k16 (bf16 in, f32
// accumulate), A fragments by ldmatrix straight from the 2x tile, B from
// the folded weights [25][Cout][C] through L1/L2 (mma_conv.cuh's scheme
// for 3x3).  Each warp owns two output rows of the tile (32 pixels) and
// all of the block's channels.  Bias and ReLU run in the epilogue.  The
// TPU kernel's split (row upsample composed into the weights, column
// upsample as a separate pass) was an artefact of Mosaic and is not
// carried over; the phase-composed 16-tap form, weights staged by TMA and
// wgmma are the next steps.

#include "mma_conv.cuh"

namespace {

constexpr int kTile = 16;              // output tile: 16 x 16 2x pixels
constexpr int kHi = kTile + 4;         // the 2x tile with a 2-pixel halo
constexpr int kLo = kTile / 2 + 4;     // the low-res tile it is built from
constexpr int kChunkN = 64;            // output channels per block
constexpr int kMaxNT = kChunkN / 8;    // n8 tiles per warp

// Shared memory of one block in bytes: the low-res and the 2x tile, bf16,
// at pixel pitch CS + kPad (ops/upsample_conv.py::smem_bytes computes the
// same).
inline size_t upsample_conv_smem(int cs) {
  return (size_t)(kLo * kLo + kHi * kHi) * (size_t)(cs + kPad) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// One block per 16 x 16 output tile (blockIdx.x, blockIdx.y) of one batch
// item and one slice of up to 64 output channels (blockIdx.z = b *
// n_slices + slice).  CS: input channels per slab (a multiple of 16 that
// divides C).
__global__ void __launch_bounds__(kThreads)
upsample_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ skip,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     bf16* __restrict__ out, int H, int W, int C, int Cout, int CS,
                     int n_slices, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ps = CS + kPad;
  bf16* lo = reinterpret_cast<bf16*>(smem_raw);
  bf16* hi = lo + kLo * kLo * ps;
  const uint32_t hi_u = (uint32_t)__cvta_generic_to_shared(hi);

  const int b = blockIdx.z / n_slices;
  const int co_base = (blockIdx.z - b * n_slices) * kChunkN;
  const int nt = min(kChunkN, Cout - co_base) / 8;
  const int H2 = 2 * H, W2 = 2 * W;
  const int Y0 = blockIdx.y * kTile, X0 = blockIdx.x * kTile;
  // low-res origin of the lo tile: 2x rows Y0-2 .. Y0+17 read low-res rows
  // Y0/2-2 .. Y0/2+9
  const int i0 = Y0 / 2 - 2, j0 = X0 / 2 - 2;
  const size_t plane = (size_t)H * W * C;
  const bf16* xb = x + (size_t)b * plane;
  const bf16* sb = skip ? skip + (size_t)b * plane : nullptr;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_vec = CS / 8;

  float acc[2][kMaxNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kMaxNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CS) {
    if (c0) __syncthreads();   // the previous slab's conv has read hi

    // 1. lo tile: bf16(x + skip) at low-res (i0+ly, j0+lx), the row and
    //    column clamped to the image.
    for (int i = threadIdx.x; i < kLo * kLo * n_vec; i += kThreads) {
      const int pix = i / n_vec, v = i - pix * n_vec;
      const int ly = pix / kLo, lx = pix - ly * kLo;
      const int gy = min(max(i0 + ly, 0), H - 1), gx = min(max(j0 + lx, 0), W - 1);
      const size_t off = ((size_t)gy * W + gx) * C + c0 + v * 8;
      uint4 val = __ldg(reinterpret_cast<const uint4*>(xb + off));
      if (sb) {
        const uint4 s = __ldg(reinterpret_cast<const uint4*>(sb + off));
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&val);
        const uint32_t* c = reinterpret_cast<const uint32_t*>(&s);
        uint4 sum;
        uint32_t* d = reinterpret_cast<uint32_t*>(&sum);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p = unpack_bf2(a[e]), q = unpack_bf2(c[e]);
          d[e] = pack_bf2(p.x + q.x, p.y + q.y);
        }
        val = sum;
      }
      *reinterpret_cast<uint4*>(lo + pix * ps + v * 8) = val;
    }
    __syncthreads();

    // 2. hi tile: the 2x image at (Y0-2+hy, X0-2+hx), 0 outside
    //    [0, 2H) x [0, 2W).  2x row 2i reads low-res rows i-1, i with
    //    weights 1/4, 3/4; row 2i+1 rows i, i+1 with 3/4, 1/4 (the clamp
    //    is in the lo tile); columns alike; combined as the library's
    //    resize combines them: rows of column blends.
    for (int i = threadIdx.x; i < kHi * kHi * n_vec; i += kThreads) {
      const int pix = i / n_vec, v = i - pix * n_vec;
      const int hy = pix / kHi, hx = pix - hy * kHi;
      const int Y = Y0 - 2 + hy, X = X0 - 2 + hx;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (Y >= 0 && Y < H2 && X >= 0 && X < W2) {
        const int iy = (Y >> 1) - i0, ix = (X >> 1) - j0;
        const int ra = (Y & 1) ? iy : iy - 1, ca = (X & 1) ? ix : ix - 1;
        const float wa = (Y & 1) ? 0.75f : 0.25f, wb = 1.0f - wa;
        const float va = (X & 1) ? 0.75f : 0.25f, vb = 1.0f - va;
        const uint32_t* p00 =
            reinterpret_cast<const uint32_t*>(lo + (ra * kLo + ca) * ps + v * 8);
        const uint32_t* p01 = p00 + ps / 2;
        const uint32_t* p10 = p00 + kLo * ps / 2;
        const uint32_t* p11 = p10 + ps / 2;
        uint32_t* d = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a00 = unpack_bf2(p00[e]), a01 = unpack_bf2(p01[e]);
          const float2 a10 = unpack_bf2(p10[e]), a11 = unpack_bf2(p11[e]);
          d[e] = pack_bf2(wa * (va * a00.x + vb * a01.x) + wb * (va * a10.x + vb * a11.x),
                          wa * (va * a00.y + vb * a01.y) + wb * (va * a10.y + vb * a11.y));
        }
      }
      *reinterpret_cast<uint4*>(hi + pix * ps + v * 8) = val;
    }
    __syncthreads();

    // 3. the 5x5 conv over this slab: m16 tile mi is output row
    //    2*warp + mi of the tile, its pixel (lane & 15); its tap (ky, kx)
    //    starts at hi-tile pixel (2*warp + mi + ky, (lane & 15) + kx).
    for (int ky = 0; ky < 5; ++ky) {
      for (int kx = 0; kx < 5; ++kx) {
        uint32_t a_addr[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          a_addr[mi] = hi_u + 2 * (((2 * warp + mi + ky) * kHi + (lane & 15) + kx) * ps +
                                   (lane >> 4) * 8);
        const bf16* wt = w + ((size_t)(ky * 5 + kx) * Cout + co_base + g) * C + c0 + 2 * t;
        for (int k0 = 0; k0 < CS; k0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(a_addr[mi] + 2 * k0, a[mi]);
#pragma unroll
          for (int ni = 0; ni < kMaxNT; ++ni) {
            if (ni < nt) {
              const bf16* wp = wt + (size_t)ni * 8 * C + k0;
              const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
              const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
            }
          }
        }
      }
    }
  }

  // 4. epilogue: acc[mi][ni][2*half + j] is output pixel (Y0 + 2*warp + mi,
  //    X0 + g + 8*half), channel co_base + ni*8 + 2*t + j.
  bf16* ob = out + (size_t)b * H2 * W2 * Cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int Y = Y0 + 2 * warp + mi;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int X = X0 + g + 8 * half;
      if (Y >= H2 || X >= W2) continue;
      bf16* op = ob + ((size_t)Y * W2 + X) * Cout;
#pragma unroll
      for (int ni = 0; ni < kMaxNT; ++ni) {
        if (ni < nt) {
          const int ch = co_base + ni * 8 + 2 * t;
          float v0 = acc[mi][ni][2 * half] + bias[ch];
          float v1 = acc[mi][ni][2 * half + 1] + bias[ch + 1];
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
// contiguous; w: [25,Cout,C] (tap ky*5+kx, output, input) contiguous; all
// bf16 and 16-byte aligned; bias: [Cout] f32; out: [B,2H,2W,Cout] bf16
// contiguous.  C % 16 == 0, CS a multiple of 16 dividing C, Cout % 8 == 0
// (the wrapper checks).  relu: apply ReLU after the bias.  Returns the
// cudaError_t of the launch.
int ramnet_upsample_conv_forward(const void* x, const void* skip, const void* w,
                                 const void* bias, void* out, int B, int H, int W,
                                 int C, int Cout, int cs, int relu, void* stream) {
  const size_t smem = upsample_conv_smem(cs);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_slices = (Cout + kChunkN - 1) / kChunkN;
  const dim3 grid((2 * W + kTile - 1) / kTile, (2 * H + kTile - 1) / kTile, B * n_slices);
  upsample_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, C, Cout, cs, n_slices, relu);
  return (int)cudaGetLastError();
}

const char* ramnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
