// Kernel A: y = conv3x3(prelu(x, alpha)) + bias [+ residual], zero padding 1,
// stride 1 or 2, NHWC bf16 in and out, f32 accumulation; with `relu` the
// result is clamped at zero in the epilogue (the conv -> ReLU layers of VGG19
// and HNED).
//
// Replaces the TPU kernels
//   video_layout_generation_tpu/ops/pallas/conv_packed.py:_fused_impl
//     (conv_packed3x3_sparse, prelu_conv_packed3x3, prelu_conv_packed3x3_res)
//   video_layout_generation_tpu/ops/pallas/conv1x2.py:_fwd_impl (conv3x3_w1x2)
//   video_layout_generation_tpu/ops/pallas/conv3x3.py:_conv3x3_fwd_impl
//     (conv3x3_pallas)
// and takes the stride-2 DownSamplingBlock conv that the JAX package leaves
// to XLA. Those kernels compute the same function in 2x2 or 1x2
// space-to-depth form, which exists only to fill the TPU's 128-lane matrix
// unit; here the function runs on the logical NHWC tensor.
//
// What bounds it on an H100: at GridNet's row-0 shape (C=32 at 256x256) a
// conv does 9*32 = 288 MACs per output value, about 144 FLOP per byte moved,
// below the card's ~295 FLOP/byte bf16 balance point: the ideal kernel is
// bound by device memory there, balanced at row 1 (C=64) and bound by the
// tensor cores at row 2 (C=96). This first version is neither: it runs on
// the CUDA cores (f32 FMAs, about 67 TFLOP/s peak), so it is bound by
// operations at every width. Its design keeps the memory side at the ideal:
// each block stages its input tile with a one-pixel halo in shared memory
// once (the PReLU is applied while staging, so it costs no pass of its own),
// weights stay in L1/L2, and bias, residual and the bf16 store happen in the
// epilogue, so each activation crosses device memory once. Moving the inner
// product onto the tensor cores (mma/wgmma) is the next step.
#include "conv_common.cuh"

namespace {

using vlg::COT;
using vlg::NTHREADS;
using vlg::PX;
using vlg::TILE_H;
using vlg::TILE_W;

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
prelu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha,
                     const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ out, int h, int wd, int ci,
                     int co, int stride, int ho, int wo, int tiles_w,
                     int tiles_h, bool relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int cs = vlg::smem_pixel_stride(ci);
  const int in_rows = (TILE_H - 1) * stride + 3;
  const int in_cols = (TILE_W - 1) * stride + 3;

  int t = blockIdx.x;
  const int tx = t % tiles_w;
  t /= tiles_w;
  const int ty = t % tiles_h;
  const int n = t / tiles_h;
  const int oy0 = ty * TILE_H;
  const int ox0 = tx * TILE_W;

  const bool act = alpha != nullptr;
  const float a = act ? vlg::bf16_round(*alpha) : 0.f;
  vlg::stage_input(x + (size_t)n * h * wd * ci, h, wd, ci, oy0 * stride - 1,
                   ox0 * stride - 1, in_rows, in_cols, cs, act, a, xs);
  __syncthreads();

  constexpr int kGroups = TILE_H * TILE_W / PX;
  const int n_cg = (co + COT - 1) / COT;
  for (int item = threadIdx.x; item < kGroups * n_cg; item += blockDim.x) {
    const int cg = item % n_cg;
    const int pg = item / n_cg;
    const int co0 = cg * COT;
    int off[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = pg + j * kGroups;
      off[j] = ((p / TILE_W) * stride * in_cols + (p % TILE_W) * stride) * cs;
    }
    float acc[PX][COT];
    vlg::conv_item<VEC>(xs, in_cols, cs, ci, w, co, co0, off, acc);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = pg + j * kGroups;
      const int oy = oy0 + p / TILE_W;
      const int ox = ox0 + p % TILE_W;
      if (oy < ho && ox < wo) {
        const size_t o = (((size_t)n * ho + oy) * wo + ox) * co + co0;
        vlg::store_item<VEC>(acc[j], bias, res, out, o, co, co0, relu);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* alpha, const void* res, void* out, int n, int h,
                   int wd, int ci, int co, int stride, bool relu,
                   cudaStream_t stream) {
  const int ho = (h - 1) / stride + 1;
  const int wo = (wd - 1) / stride + 1;
  const int tiles_h = (ho + TILE_H - 1) / TILE_H;
  const int tiles_w = (wo + TILE_W - 1) / TILE_W;
  const size_t smem = (size_t)((TILE_H - 1) * stride + 3) *
                      ((TILE_W - 1) * stride + 3) *
                      vlg::smem_pixel_stride(ci) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      prelu_conv3x3_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)n * tiles_h * tiles_w;
  prelu_conv3x3_kernel<VEC><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(alpha),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), h, wd, ci, co, stride, ho, wo, tiles_w,
      tiles_h, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vlg_prelu_conv3x3(const void* x, const void* w,
                                 const void* bias, const void* alpha,
                                 const void* res, void* out, int n, int h,
                                 int wd, int ci, int co, int stride,
                                 int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co % COT == 0)
    return (int)launch<true>(x, w, bias, alpha, res, out, n, h, wd, ci, co,
                             stride, relu != 0, s);
  return (int)launch<false>(x, w, bias, alpha, res, out, n, h, wd, ci, co,
                            stride, relu != 0, s);
}

// Shared-memory bytes one block needs; the wrapper refuses shapes above the
// card's per-block limit before launching.
extern "C" long long vlg_prelu_conv3x3_smem(int ci, int stride) {
  return (long long)((TILE_H - 1) * stride + 3) *
         ((TILE_W - 1) * stride + 3) * vlg::smem_pixel_stride(ci) *
         (long long)sizeof(__nv_bfloat16);
}
