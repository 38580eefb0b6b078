// Kernel B: one channel-preserving GridNet LateralBlock in one launch,
//   out = conv1(prelu1(conv0(prelu0(x)) + b0)) + b1 [+ residual],
// 3x3 convs with zero padding 1, NHWC bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernel
//   video_layout_generation_tpu/ops/pallas/conv_packed.py:_fused_lateral_impl
//     (fused_lateral_packed3x3)
// which computes the same block in 2x2 space-to-depth form. As there, the
// intermediate never touches device memory: each block computes conv0 over
// its output tile plus a one-pixel halo into shared memory, rounds it to
// bf16 before PReLU1 (the JAX executor's conv -> prelu dtype chain), and
// zeroes the halo pixels that lie outside the image (conv1's padding is
// zero, not conv0(0) + b0). The grid's additive fusion (a Down/Up block's
// output) is added in the f32 epilogue.
//
// What bounds it on an H100: the ideal fused block reads x once and writes
// the output once (plus the residual), so at row 0 (C=32, 256x256) it does
// twice kernel A's operations over the same bytes and sits near the card's
// bf16 balance point; rows 1-2 are bound by the tensor cores. This first
// version runs its inner products on the CUDA cores in f32 (about 67
// TFLOP/s peak), so it is bound by operations at every width, and it
// recomputes conv0 on the halo ((TILE_H+2)(TILE_W+2)/(TILE_H*TILE_W) =
// 1.41x of conv0's work). Against that it saves the intermediate's write
// and read and one launch per block. Tensor-core inner products are the
// next step.
#include "conv_common.cuh"

namespace {

using vlg::COT;
using vlg::NTHREADS;
using vlg::PX;
using vlg::TILE_H;
using vlg::TILE_W;

constexpr int IN_ROWS = TILE_H + 4;   // input tile: output tile + 2-pixel halo
constexpr int IN_COLS = TILE_W + 4;
constexpr int MID_ROWS = TILE_H + 2;  // intermediate: output tile + 1-pixel halo
constexpr int MID_COLS = TILE_W + 2;

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
fused_lateral_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w0,
                     const float* __restrict__ b0,
                     const float* __restrict__ a0,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ a1,
                     const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ out, int h, int wd, int c,
                     int tiles_w, int tiles_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = vlg::smem_pixel_stride(c);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ms = xs + IN_ROWS * IN_COLS * cs;

  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  const int n = t / tiles_h;
  const int oy0 = ty * TILE_H;
  const int ox0 = tx * TILE_W;
  const int n_cg = (c + COT - 1) / COT;

  vlg::stage_input(x + (size_t)n * h * wd * c, h, wd, c, oy0 - 2, ox0 - 2,
                   IN_ROWS, IN_COLS, cs, true, vlg::bf16_round(*a0), xs);
  __syncthreads();

  // conv0 over the tile and its one-pixel halo -> PReLU1 -> shared memory
  const float alpha1 = vlg::bf16_round(*a1);
  constexpr int kMidPix = MID_ROWS * MID_COLS;
  constexpr int kMidGroups = (kMidPix + PX - 1) / PX;
  for (int item = threadIdx.x; item < kMidGroups * n_cg;
       item += blockDim.x) {
    const int cg = item % n_cg;
    const int pg = item / n_cg;
    const int co0 = cg * COT;
    int off[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = min(pg + j * kMidGroups, kMidPix - 1);
      off[j] = ((p / MID_COLS) * IN_COLS + p % MID_COLS) * cs;
    }
    float acc[PX][COT];
    vlg::conv_item<VEC>(xs, IN_COLS, cs, c, w0, c, co0, off, acc);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = pg + j * kMidGroups;
      if (p >= kMidPix) continue;
      const int gy = oy0 - 1 + p / MID_COLS;
      const int gx = ox0 - 1 + p % MID_COLS;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
#pragma unroll
      for (int k = 0; k < COT; ++k) {
        if (co0 + k < c) {
          float v = 0.f;
          if (inside)
            v = vlg::prelu_bf16(vlg::bf16_round(acc[j][k] + __ldg(b0 + co0 + k)),
                                alpha1);
          ms[p * cs + co0 + k] = __float2bfloat16(v);
        }
      }
    }
  }
  __syncthreads();

  // conv1 over the tile + bias (+ residual) -> device memory
  constexpr int kGroups = TILE_H * TILE_W / PX;
  for (int item = threadIdx.x; item < kGroups * n_cg; item += blockDim.x) {
    const int cg = item % n_cg;
    const int pg = item / n_cg;
    const int co0 = cg * COT;
    int off[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = pg + j * kGroups;
      off[j] = ((p / TILE_W) * MID_COLS + p % TILE_W) * cs;
    }
    float acc[PX][COT];
    vlg::conv_item<VEC>(ms, MID_COLS, cs, c, w1, c, co0, off, acc);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = pg + j * kGroups;
      const int oy = oy0 + p / TILE_W;
      const int ox = ox0 + p % TILE_W;
      if (oy < h && ox < wd) {
        const size_t o = (((size_t)n * h + oy) * wd + ox) * c + co0;
        vlg::store_item<VEC>(acc[j], b1, res, out, o, c, co0);
      }
    }
  }
}

size_t smem_bytes(int c) {
  return (size_t)(IN_ROWS * IN_COLS + MID_ROWS * MID_COLS) *
         vlg::smem_pixel_stride(c) * sizeof(__nv_bfloat16);
}

template <bool VEC>
cudaError_t launch(const void* x, const void* w0, const void* b0,
                   const void* a0, const void* w1, const void* b1,
                   const void* a1, const void* res, void* out, int n, int h,
                   int wd, int c, cudaStream_t stream) {
  const int tiles_h = (h + TILE_H - 1) / TILE_H;
  const int tiles_w = (wd + TILE_W - 1) / TILE_W;
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      fused_lateral_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)n * tiles_h * tiles_w;
  fused_lateral_kernel<VEC><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(a0), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(a1),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), h, wd, c, tiles_w, tiles_h);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vlg_fused_lateral(const void* x, const void* w0,
                                 const void* b0, const void* a0,
                                 const void* w1, const void* b1,
                                 const void* a1, const void* res, void* out,
                                 int n, int h, int wd, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % COT == 0)
    return (int)launch<true>(x, w0, b0, a0, w1, b1, a1, res, out, n, h, wd, c,
                             s);
  return (int)launch<false>(x, w0, b0, a0, w1, b1, a1, res, out, n, h, wd, c,
                            s);
}

// Shared-memory bytes one block needs; the wrapper refuses shapes above the
// card's per-block limit before launching.
extern "C" long long vlg_fused_lateral_smem(int c) {
  return (long long)smem_bytes(c);
}
