// Shared pieces of the direct 3x3 convolution kernels (conv3x3.cu,
// lateral.cu): bf16 rounding, scalar-alpha PReLU, the weight-row loader and
// the register-tiled inner product over a shared-memory input tile.
//
// Layouts: activations NHWC bf16; weights HWIO (3, 3, Ci, Co) bf16, i.e. the
// flax kernel layout unchanged, read as (9 * Ci) rows of Co; bias f32 (Co);
// PReLU alpha one f32 value in device memory (read by the kernel, so the
// host never synchronises to fetch it).
//
// Work split: a block owns an output tile of TILE_H x TILE_W pixels. One
// work item is PX pixels x COT output channels, accumulated in f32
// registers; the block's threads loop over the tile's items. The PX pixels
// of an item are strided by the number of pixel groups, so neighbouring
// items read neighbouring pixels of the shared tile and write neighbouring
// output addresses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vlg {

constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int PX = 4;        // pixels per work item
constexpr int COT = 8;       // output channels per work item (one 16-byte row)
constexpr int NTHREADS = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// PReLU with the slope rounded to bf16 and the product rounded to bf16, as
// the JAX executor computes it on bf16 activations.
__device__ __forceinline__ float prelu_bf16(float v, float a) {
  return v >= 0.f ? v : bf16_round(a * v);
}

// Pixel stride of a shared-memory tile: even (bf16 pairs stay aligned) and
// odd in 4-byte words for the GridNet widths, which spreads neighbouring
// pixels over distinct banks.
__host__ __device__ __forceinline__ int smem_pixel_stride(int c) {
  return (c | 1) + 1;
}

// Weights of output channels [co0, co0 + COT) at row `row` = tap * Ci + ci.
template <bool VEC>
__device__ __forceinline__ void load_w(const __nv_bfloat16* __restrict__ w,
                                       int row, int co, int co0,
                                       float (&wv)[COT]) {
  const __nv_bfloat16* p = w + (size_t)row * co + co0;
  if (VEC) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < COT / 2; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      wv[2 * k] = f.x;
      wv[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < COT; ++k)
      wv[k] = (co0 + k < co) ? __bfloat162float(p[k]) : 0.f;
  }
}

// acc[j][k] += sum over taps and input channels of
//   src[off[j] + (ky * src_cols + kx) * cs + ci] * w[ky][kx][ci][co0 + k]
template <bool VEC>
__device__ __forceinline__ void conv_item(const __nv_bfloat16* __restrict__ src,
                                          int src_cols, int cs, int ci_n,
                                          const __nv_bfloat16* __restrict__ w,
                                          int co, int co0, const int (&off)[PX],
                                          float (&acc)[PX][COT]) {
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < COT; ++k) acc[j][k] = 0.f;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const int toff = (ky * src_cols + kx) * cs;
      const int row0 = (ky * 3 + kx) * ci_n;
      for (int ci = 0; ci < ci_n; ++ci) {
        float wv[COT];
        load_w<VEC>(w, row0 + ci, co, co0, wv);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float v = __bfloat162float(src[off[j] + toff + ci]);
#pragma unroll
          for (int k = 0; k < COT; ++k) acc[j][k] = fmaf(v, wv[k], acc[j][k]);
        }
      }
    }
  }
}

// out[o + k] = bf16(acc[k] + bias[co0 + k] (+ res[o + k])) for k < COT,
// co0 + k < co; with `relu` the sum is clamped at zero before the bf16 store.
template <bool VEC>
__device__ __forceinline__ void store_item(const float (&acc)[COT],
                                           const float* __restrict__ bias,
                                           const __nv_bfloat16* __restrict__ res,
                                           __nv_bfloat16* __restrict__ out,
                                           size_t o, int co, int co0,
                                           bool relu = false) {
  if (VEC) {
    float v[COT];
#pragma unroll
    for (int k = 0; k < COT; ++k) v[k] = acc[k] + __ldg(bias + co0 + k);
    if (res != nullptr) {
      uint4 u = __ldg(reinterpret_cast<const uint4*>(res + o));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < COT / 2; ++k) {
        float2 f = __bfloat1622float2(h[k]);
        v[2 * k] += f.x;
        v[2 * k + 1] += f.y;
      }
    }
    if (relu) {
#pragma unroll
      for (int k = 0; k < COT; ++k) v[k] = fmaxf(v[k], 0.f);
    }
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < COT / 2; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(out + o) = u;
  } else {
#pragma unroll
    for (int k = 0; k < COT; ++k) {
      if (co0 + k < co) {
        float v = acc[k] + __ldg(bias + co0 + k);
        if (res != nullptr) v += __bfloat162float(res[o + k]);
        if (relu) v = fmaxf(v, 0.f);
        out[o + k] = __float2bfloat16(v);
      }
    }
  }
}

// Stage a (rows x cols x c) window of one NHWC image, whose top-left input
// pixel is (y0, x0), into shared memory with pixel stride cs. Pixels outside
// the image are the convolution's zero padding. With `act` the scalar-alpha
// PReLU is applied (and rounded to bf16) on the way in.
__device__ __forceinline__ void stage_input(const __nv_bfloat16* __restrict__ img,
                                            int h, int w, int c, int y0, int x0,
                                            int rows, int cols, int cs,
                                            bool act, float a,
                                            __nv_bfloat16* __restrict__ dst) {
  const int total = rows * cols * c;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int ci = i % c;
    const int pix = i / c;
    const int gy = y0 + pix / cols;
    const int gx = x0 + pix % cols;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = __bfloat162float(img[((size_t)gy * w + gx) * c + ci]);
      if (act) v = prelu_bf16(v, a);
    }
    dst[pix * cs + ci] = __float2bfloat16(v);
  }
}

}  // namespace vlg
