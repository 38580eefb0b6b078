// Non-affine InstanceNorm over H, W of an NHWC tensor, forward and backward:
//   forward   y[n,h,w,c] = (x - mean[n,c]) * rstd[n,c],
//             mean and the biased variance per (n, c) plane over H, W,
//             rstd = 1 / sqrt(var + eps); optionally rstd (N, C) f32 is kept
//   backward  dx = rstd * (dy - mean(dy) - y * mean(dy * y)), means per plane
// x, y, dy, dx f32 or bf16; every statistic and every sum in f32.
//
// Replaces the TPU kernels of
//   video_layout_generation_tpu/ops/pallas/instance_norm.py:
//     _pallas_fwd (kernel body _fwd_kernel), _pallas_fwd_only
//     (_fwd_only_kernel) and _pallas_bwd (_bwd_kernel).
// Those hold one whole (H, W, 128-channel) plane in the TPU's on-chip memory
// and therefore take only C % 128 == 0 and small planes, leaving the rest to
// XLA. Here a plane is cut into chunks of rows that many blocks reduce in
// parallel, so any N, H, W and C work and no shape goes elsewhere. For
// non-affine InstanceNorm y equals xhat, so the forward writes one tensor
// where the TPU kernel writes two.
//
// What bounds it on an H100: bytes. Per value the forward does about 6 f32
// operations and moves one value in and one out. The design: an (H*W, C)
// image is H*W contiguous rows of C values; a block of 256 threads covers
// up to 32 vectors of channels (16 bytes a thread: 8 bf16 or 4 f32) by 8 or
// more rows at a time, so a warp reads whole contiguous rows. Three launches
// per call:
//   1. partial statistics: each block takes one chunk of rows, sums it, forms
//      the chunk mean, reads the chunk again (it was just read: L1/L2) and
//      sums the squared differences from the chunk mean;
//   2. finalize: one thread per (n, c) adds the chunk sums in ascending
//      order, mean = sum / HW, and the centered sum of squares
//      sum_k (m2_k + n_k * (mean_k - mean)^2), which is exactly
//      sum (x - mean)^2 with no subtraction of large numbers, so a bf16 plane
//      with a large mean keeps its variance;
//   3. normalize: reads x a second time (from L2 where the tensor fits its
//      50 MB) and writes y.
// So x is read twice from device memory at most, plus once more from cache.
// The backward has the same shape with plain sums of dy and dy * y.
//
// Deterministic: no atomics. A thread sums its rows in ascending order, a
// block its threads in ascending order through shared memory, the finalize
// kernel the chunks in ascending order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LANES = 32;      // channel vectors per block
constexpr int MIN_ROWS_PER_THREAD = 4;
constexpr int TARGET_BLOCKS = 1056;  // 8 per SM
constexpr int MAX_CHUNKS = 256;

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16(v[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// How a call is cut: `lanes` threads of a block lie along the channel
// vectors and NTHREADS / lanes along the rows; a plane's hw rows are cut
// into `chunks` chunks of `rows` rows.
struct Plan {
  int vec, cvecs, lanes, ty_n, ctiles, rows, chunks;
};

Plan make_plan(int n, int hw, int c, int vec) {
  Plan p;
  p.vec = vec;
  p.cvecs = (c + vec - 1) / vec;
  p.lanes = 1;
  while (p.lanes < p.cvecs && p.lanes < MAX_LANES) p.lanes *= 2;
  p.ty_n = NTHREADS / p.lanes;
  p.ctiles = (p.cvecs + p.lanes - 1) / p.lanes;
  const long long planes = (long long)n * p.ctiles;
  long long want = (TARGET_BLOCKS + planes - 1) / planes;
  const int most = (hw + p.ty_n * MIN_ROWS_PER_THREAD - 1) /
                   (p.ty_n * MIN_ROWS_PER_THREAD);
  if (want > most) want = most;
  if (want > MAX_CHUNKS) want = MAX_CHUNKS;
  if (want < 1) want = 1;
  int rows = (hw + (int)want - 1) / (int)want;
  rows = (rows + p.ty_n - 1) / p.ty_n * p.ty_n;
  p.rows = rows;
  p.chunks = (hw + rows - 1) / rows;
  return p;
}

int vec_of(int c, bool bf16) {
  if (bf16) return c % 8 == 0 ? 8 : 1;
  return c % 4 == 0 ? 4 : 1;
}

// Sum `acc` over the block's threads that share a lane (same channels),
// ascending in ty; the result is valid in every thread of the lane.
template <int VEC>
__device__ __forceinline__ void sum_over_rows(float (&acc)[VEC], float* sh,
                                              int lane, int ty, int lanes,
                                              int ty_n) {
  __syncthreads();
#pragma unroll
  for (int v = 0; v < VEC; ++v) sh[(ty * lanes + lane) * VEC + v] = acc[v];
  __syncthreads();
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float s = 0.f;
    for (int k = 0; k < ty_n; ++k) s += sh[(k * lanes + lane) * VEC + v];
    acc[v] = s;
  }
}

// grid (chunks, ctiles, n). part holds two planes of (n, chunks, c) floats:
// the chunk sums, then the chunk sums of squared differences from the chunk
// mean.
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
stats_kernel(const T* __restrict__ x, float* __restrict__ part, int hw, int c,
             int lanes, int rows, int chunks) {
  extern __shared__ float sh[];
  const int ty_n = NTHREADS / lanes;
  const int lane = threadIdx.x % lanes;
  const int ty = threadIdx.x / lanes;
  const int c0 = (blockIdx.y * lanes + lane) * VEC;
  const bool on = c0 < c;
  const int n = blockIdx.z;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(hw, r0 + rows);
  const T* xi = x + (size_t)n * hw * c + c0;

  float s[VEC], val[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = 0.f;
  if (on)
    for (int r = r0 + ty; r < r1; r += ty_n) {
      Vec<T, VEC>::load(xi + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] += val[v];
    }
  sum_over_rows<VEC>(s, sh, lane, ty, lanes, ty_n);

  // a true division: the mean of a constant chunk is that constant exactly
  const float cnt = (float)(r1 - r0);
  float q[VEC], mu[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    q[v] = 0.f;
    mu[v] = s[v] / cnt;
  }
  if (on)
    for (int r = r0 + ty; r < r1; r += ty_n) {
      Vec<T, VEC>::load(xi + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = val[v] - mu[v];
        q[v] += d * d;
      }
    }
  sum_over_rows<VEC>(q, sh, lane, ty, lanes, ty_n);

  if (on && ty == 0) {
    const size_t o = ((size_t)n * chunks + blockIdx.x) * c + c0;
    const size_t plane = (size_t)gridDim.z * chunks * c;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      part[o + v] = s[v];
      part[plane + o + v] = q[v];
    }
  }
}

// One thread per (n, c): mean and rstd from the chunk statistics.
__global__ void __launch_bounds__(NTHREADS)
stats_finalize_kernel(const float* __restrict__ part, float* __restrict__ mean,
                      float* __restrict__ rstd, int n_all, int hw, int c,
                      int rows, int chunks, float eps) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n_all * c) return;
  const int n = i / c;
  const int ch = i - n * c;
  const float* ps = part + (size_t)n * chunks * c + ch;
  const float* pq = ps + (size_t)n_all * chunks * c;
  float total = 0.f;
  for (int k = 0; k < chunks; ++k) total += ps[(size_t)k * c];
  const float m = total / (float)hw;
  float m2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float cnt = (float)(min(hw, (k + 1) * rows) - k * rows);
    const float d = ps[(size_t)k * c] / cnt - m;
    m2 += pq[(size_t)k * c] + cnt * d * d;
  }
  mean[i] = m;
  rstd[i] = 1.0f / sqrtf(m2 / (float)hw + eps);
}

// grid (chunks, ctiles, n): y = (x - mean) * rstd.
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ y, int hw,
                 int c, int lanes, int rows) {
  const int ty_n = NTHREADS / lanes;
  const int lane = threadIdx.x % lanes;
  const int ty = threadIdx.x / lanes;
  const int c0 = (blockIdx.y * lanes + lane) * VEC;
  if (c0 >= c) return;
  const int n = blockIdx.z;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(hw, r0 + rows);
  float m[VEC], rs[VEC], val[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    m[v] = mean[(size_t)n * c + c0 + v];
    rs[v] = rstd[(size_t)n * c + c0 + v];
  }
  const size_t base = (size_t)n * hw * c + c0;
  for (int r = r0 + ty; r < r1; r += ty_n) {
    const size_t o = base + (size_t)r * c;
    Vec<T, VEC>::load(x + o, val);
#pragma unroll
    for (int v = 0; v < VEC; ++v) val[v] = (val[v] - m[v]) * rs[v];
    Vec<T, VEC>::store(y + o, val);
  }
}

// grid (chunks, ctiles, n). part holds two planes of (n, chunks, c) floats:
// the chunk sums of dy and of dy * y.
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
bwd_sums_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                float* __restrict__ part, int hw, int c, int lanes, int rows,
                int chunks) {
  extern __shared__ float sh[];
  const int ty_n = NTHREADS / lanes;
  const int lane = threadIdx.x % lanes;
  const int ty = threadIdx.x / lanes;
  const int c0 = (blockIdx.y * lanes + lane) * VEC;
  const bool on = c0 < c;
  const int n = blockIdx.z;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(hw, r0 + rows);
  const size_t base = (size_t)n * hw * c + c0;

  float s[VEC], q[VEC], g[VEC], val[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = q[v] = 0.f;
  if (on)
    for (int r = r0 + ty; r < r1; r += ty_n) {
      const size_t o = base + (size_t)r * c;
      Vec<T, VEC>::load(dy + o, g);
      Vec<T, VEC>::load(y + o, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s[v] += g[v];
        q[v] += g[v] * val[v];
      }
    }
  sum_over_rows<VEC>(s, sh, lane, ty, lanes, ty_n);
  sum_over_rows<VEC>(q, sh, lane, ty, lanes, ty_n);
  if (on && ty == 0) {
    const size_t o = ((size_t)n * chunks + blockIdx.x) * c + c0;
    const size_t plane = (size_t)gridDim.z * chunks * c;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      part[o + v] = s[v];
      part[plane + o + v] = q[v];
    }
  }
}

// One thread per (n, c): the plane means of dy and dy * y.
__global__ void __launch_bounds__(NTHREADS)
bwd_finalize_kernel(const float* __restrict__ part, float* __restrict__ m_dy,
                    float* __restrict__ m_dyy, int n_all, int hw, int c,
                    int chunks) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n_all * c) return;
  const int n = i / c;
  const int ch = i - n * c;
  const float* ps = part + (size_t)n * chunks * c + ch;
  const float* pq = ps + (size_t)n_all * chunks * c;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    a += ps[(size_t)k * c];
    b += pq[(size_t)k * c];
  }
  m_dy[i] = a / (float)hw;
  m_dyy[i] = b / (float)hw;
}

// grid (chunks, ctiles, n): dx = rstd * (dy - m_dy - y * m_dyy).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                 const float* __restrict__ rstd,
                 const float* __restrict__ m_dy,
                 const float* __restrict__ m_dyy, T* __restrict__ dx, int hw,
                 int c, int lanes, int rows) {
  const int ty_n = NTHREADS / lanes;
  const int lane = threadIdx.x % lanes;
  const int ty = threadIdx.x / lanes;
  const int c0 = (blockIdx.y * lanes + lane) * VEC;
  if (c0 >= c) return;
  const int n = blockIdx.z;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(hw, r0 + rows);
  float rs[VEC], a[VEC], b[VEC], g[VEC], val[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const size_t s = (size_t)n * c + c0 + v;
    rs[v] = rstd[s];
    a[v] = m_dy[s];
    b[v] = m_dyy[s];
  }
  const size_t base = (size_t)n * hw * c + c0;
  for (int r = r0 + ty; r < r1; r += ty_n) {
    const size_t o = base + (size_t)r * c;
    Vec<T, VEC>::load(dy + o, g);
    Vec<T, VEC>::load(y + o, val);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      g[v] = rs[v] * (g[v] - a[v] - val[v] * b[v]);
    Vec<T, VEC>::store(dx + o, g);
  }
}

template <typename T, int VEC>
cudaError_t forward(const void* x, void* y, float* rstd, float* scratch, int n,
                    int hw, int c, float eps, cudaStream_t stream) {
  const Plan p = make_plan(n, hw, c, VEC);
  const dim3 grid(p.chunks, p.ctiles, n);
  const size_t smem = (size_t)NTHREADS * VEC * sizeof(float);
  float* part = scratch;
  float* mean = scratch + (size_t)2 * n * p.chunks * c;
  stats_kernel<T, VEC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), part, hw, c, p.lanes, p.rows, p.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int planes = n * c;
  stats_finalize_kernel<<<(planes + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                          stream>>>(part, mean, rstd, n, hw, c, p.rows,
                                    p.chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  normalize_kernel<T, VEC><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, static_cast<T*>(y), hw, c, p.lanes,
      p.rows);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t backward(const void* dy, const void* y, const float* rstd,
                     void* dx, float* scratch, int n, int hw, int c,
                     cudaStream_t stream) {
  const Plan p = make_plan(n, hw, c, VEC);
  const dim3 grid(p.chunks, p.ctiles, n);
  const size_t smem = (size_t)NTHREADS * VEC * sizeof(float);
  float* part = scratch;
  float* m_dy = scratch + (size_t)2 * n * p.chunks * c;
  float* m_dyy = m_dy + (size_t)n * c;
  bwd_sums_kernel<T, VEC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), part, hw, c,
      p.lanes, p.rows, p.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int planes = n * c;
  bwd_finalize_kernel<<<(planes + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                        stream>>>(part, m_dy, m_dyy, n, hw, c, p.chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_apply_kernel<T, VEC><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), rstd, m_dy, m_dyy,
      static_cast<T*>(dx), hw, c, p.lanes, p.rows);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch one call needs (forward or backward): two planes of
// chunk statistics and two of per-(n, c) values.
extern "C" long long vlg_instance_norm_scratch(int n, int hw, int c,
                                               int is_bf16) {
  const Plan p = make_plan(n, hw, c, vec_of(c, is_bf16 != 0));
  return (long long)2 * n * p.chunks * c + (long long)2 * n * c;
}

// x, y (n, hw, c) contiguous, f32 or bf16 (`is_bf16`); rstd (n, c) f32, or
// null for the forward that keeps nothing (it then lives in the scratch);
// scratch of vlg_instance_norm_scratch floats.
extern "C" int vlg_instance_norm_fwd(const void* x, void* y, void* rstd,
                                     void* scratch, int n, int hw, int c,
                                     float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const Plan p = make_plan(n, hw, c, vec_of(c, is_bf16 != 0));
  float* rs = rstd != nullptr
                  ? static_cast<float*>(rstd)
                  : sc + (size_t)2 * n * p.chunks * c + (size_t)n * c;
  if (is_bf16) {
    if (c % 8 == 0)
      return (int)forward<__nv_bfloat16, 8>(x, y, rs, sc, n, hw, c, eps, s);
    return (int)forward<__nv_bfloat16, 1>(x, y, rs, sc, n, hw, c, eps, s);
  }
  if (c % 4 == 0) return (int)forward<float, 4>(x, y, rs, sc, n, hw, c, eps, s);
  return (int)forward<float, 1>(x, y, rs, sc, n, hw, c, eps, s);
}

// dy, y, dx (n, hw, c) contiguous of one type; rstd (n, c) f32.
extern "C" int vlg_instance_norm_bwd(const void* dy, const void* y,
                                     const void* rstd, void* dx,
                                     void* scratch, int n, int hw, int c,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const float* rs = static_cast<const float*>(rstd);
  if (is_bf16) {
    if (c % 8 == 0)
      return (int)backward<__nv_bfloat16, 8>(dy, y, rs, dx, sc, n, hw, c, s);
    return (int)backward<__nv_bfloat16, 1>(dy, y, rs, dx, sc, n, hw, c, s);
  }
  if (c % 4 == 0) return (int)backward<float, 4>(dy, y, rs, dx, sc, n, hw, c, s);
  return (int)backward<float, 1>(dy, y, rs, dx, sc, n, hw, c, s);
}
