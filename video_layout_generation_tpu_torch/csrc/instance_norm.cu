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
// Those hold one whole (H, W, 128-channel) plane in the TPU's on-chip memory,
// read x once and write y once, and take only C % 128 == 0 and small planes.
// For non-affine InstanceNorm y equals xhat, so the forward writes one tensor
// where the TPU kernel writes two.
//
// What bounds it on an H100: bytes. Per value the forward does about 8 f32
// operations for 4 or 8 bytes moved, far below the card's 20 operations a
// byte. So the only gain is to move each value once: read x once, write y
// once (the backward: dy and y once, dx once), one launch per call.
//
// The design: one SM's 227 KB cannot hold a 64 x 64 x 256 bf16 image (2 MB),
// but a thread-block cluster (up to 16 CTAs on one GPC, each able to read
// the others' shared memory) holds a slice of it. The host's launch plan
// (ops/kernels/instance_norm.py:instance_norm_plan) cuts an image into
// channel tiles of `ct` channels and gives each (n, tile) slice to one
// cluster of `k` CTAs; CTA `rank` owns `rows` consecutive pixels of the slice
// (the last one fewer), and holds the first `held` of them in shared memory:
//   1. each thread copies the 16-byte vectors of the rows it reads into
//      shared memory with cp.async (x read from device memory once);
//   2. per CTA: the chunk sum, the chunk mean by a true division (a constant
//      plane gives exactly its value), the centered sum of squares from
//      shared memory (a bf16 plane of mean 100 keeps its variance);
//   3. a cluster barrier, then every CTA reads the k chunk statistics through
//      distributed shared memory in rank order and merges them with the
//      centered (Chan) formula  m2 = sum_k (q_k + n_k * (mean_k - mean)^2),
//      so every CTA holds bit-identical mean and rstd, with no atomics and no
//      scratch tensor; rank 0 writes rstd;
//   4. each CTA normalizes its rows from shared memory and writes y with
//      16-byte stores; a closing cluster barrier keeps each CTA's statistics
//      alive until every peer has read them.
// The backward holds dy and y and merges plain sums of dy and dy * y.
//
// Two regimes, decided by the plan from the shape alone: "resident" (held ==
// rows: every row on chip; every InstanceNorm of the pix2pix generator and
// discriminator at batch 1-16 in f32 and bf16 but the 256 x 256 backward)
// and "streaming" (held < rows). A tile's rows must be 32 bytes or wider:
// 16-byte rows leave half of every 32-byte sector a warp reads unused and
// took twice as long on the H100. So a slice that no cluster of 16 CTAs of
// 128 KB holds at 32-byte rows (the 256 x 256 backward: dy and y of 16
// channels are 4 MB) streams whole rows instead: each CTA holds a few rows
// and the passes that need the rest read them again from device memory or
// L2 (the forward's three passes, the backward's two). Both regimes are this
// one kernel and one launch.
//
// Deterministic: a thread sums its rows in ascending order, a warp its rows
// by an xor butterfly, a CTA its warps in ascending order, the merge the
// CTAs in rank order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_LANES = 32;     // channel vectors per tile
constexpr int MAX_CLUSTER = 16;   // non-portable above 8
constexpr int SMEM_MAX = 232448;  // a block's shared memory on an H100

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

// Copy one vector of VEC values from device to shared memory: a 16-byte
// cp.async, or a plain copy for the one-value vectors of a ragged C.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* s, const T* g) {
  if constexpr (VEC * sizeof(T) == 16) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(g));
  } else {
    *s = *g;
  }
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// How the threads of a CTA lie on its rows: `lanes` threads along the ct / VEC
// channel vectors of a row, ty_n = NTHREADS / lanes rows at a time; thread
// (ty, lane) takes rows ty, ty + ty_n, ... of the CTA's chunk.
struct Geo {
  int lanes, ty_n, lane, ty;
};

template <int VEC>
__device__ __forceinline__ Geo geo(int ct) {
  Geo g;
  g.lanes = ct / VEC;
  g.ty_n = NTHREADS / g.lanes;
  g.lane = threadIdx.x % g.lanes;
  g.ty = threadIdx.x / g.lanes;
  return g;
}

// The CTA's sum of `acc` for each of its ct channels into out[0, ct): over
// the rows of a warp by an xor butterfly (ty ^ 1, ty ^ 2, ...), then the
// warps' sums in ascending order. `red` holds NWARPS * ct floats. Ends in a
// barrier, so `out` is then readable and `red` free.
template <int VEC>
__device__ __forceinline__ void block_sum(float (&acc)[VEC], float* red,
                                          float* out, int lanes, int ct) {
#pragma unroll
  for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], off);
  const int warp = threadIdx.x / 32;
  const int li = threadIdx.x % 32;
  if (li < lanes)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp * ct + li * VEC + v] = acc[v];
  __syncthreads();
  if (threadIdx.x < ct) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * ct + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Pixels of rank j's chunk.
__device__ __forceinline__ int chunk_rows(int j, int rows, int hw) {
  return min(hw, (j + 1) * rows) - j * rows;
}

// Channel ch's two chunk statistics of every CTA of the cluster, read
// through distributed shared memory: all loads are issued before the first
// is used, then the caller sums them in rank order.
__device__ __forceinline__ void peer_stats(float* st, int ch, int ct,
                                           float (&a)[MAX_CLUSTER],
                                           float (&b)[MAX_CLUSTER]) {
  cg::cluster_group cl = cg::this_cluster();
  const int k = (int)gridDim.x;   // the cluster is the grid's x extent
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER; ++j)
    if (j < k) {
      const float* p = cl.map_shared_rank(st, j);
      a[j] = p[ch];
      b[j] = p[ct + ch];
    }
}

// Shared memory: NWARPS * ct floats for block_sum, 2 * ct of this CTA's
// chunk statistics (read by the peers), 2 * ct of the merged statistics,
// then `bufs` tensors of held * ct values. 48 * ct bytes keep the tensors on
// 16 bytes.
long long smem_bytes(int ct, int held, int esize, int bufs) {
  return 4LL * (NWARPS + 4) * ct + (long long)held * ct * esize * bufs;
}

// grid (k, ctiles, n), cluster (k, 1, 1): blockIdx.x is the CTA's rank.
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
instance_norm_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                         float* __restrict__ rstd_out, int hw, int c, int ct,
                         int rows, int held, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* st = red + NWARPS * ct;   // chunk sum, centered sum of squares
  float* bc = st + 2 * ct;         // chunk mean, then mean; rstd
  T* xs = reinterpret_cast<T*>(bc + 2 * ct);

  const Geo g = geo<VEC>(ct);
  const int rank = blockIdx.x;
  const int c0 = blockIdx.y * ct + g.lane * VEC;
  const bool on = c0 < c;
  const int r0 = rank * rows;
  const int cnt = chunk_rows(rank, rows, hw);
  const int nheld = min(held, cnt);
  const size_t base = ((size_t)blockIdx.z * hw + r0) * c + c0;
  const T* xg = x + base;
  T* xl = xs + g.lane * VEC;

  if (on)
    for (int r = g.ty; r < nheld; r += g.ty_n)
      stage<T, VEC>(xl + r * ct, xg + (size_t)r * c);
  staged();   // a thread reads back only the rows it copied

  float s[VEC], val[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = 0.f;
  if (on) {
    int r = g.ty;
    for (; r < nheld; r += g.ty_n) {
      Vec<T, VEC>::load(xl + r * ct, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] += val[v];
    }
#pragma unroll 4
    for (; r < cnt; r += g.ty_n) {
      Vec<T, VEC>::load(xg + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] += val[v];
    }
  }
  block_sum<VEC>(s, red, st, g.lanes, ct);

  // a true division: the mean of a constant chunk is that constant exactly
  float q[VEC], mu[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    q[v] = 0.f;
    mu[v] = st[g.lane * VEC + v] / (float)cnt;
  }
  if (on) {
    int r = g.ty;
    for (; r < nheld; r += g.ty_n) {
      Vec<T, VEC>::load(xl + r * ct, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = val[v] - mu[v];
        q[v] += d * d;
      }
    }
#pragma unroll 4
    for (; r < cnt; r += g.ty_n) {
      Vec<T, VEC>::load(xg + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = val[v] - mu[v];
        q[v] += d * d;
      }
    }
  }
  block_sum<VEC>(q, red, st + ct, g.lanes, ct);

  cluster_arrive();
  cluster_wait();   // every peer's chunk statistics are written
  if (threadIdx.x < ct) {
    const int ch = threadIdx.x;
    float ps[MAX_CLUSTER], pq[MAX_CLUSTER];
    peer_stats(st, ch, ct, ps, pq);
    const int k = (int)gridDim.x;
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      if (j < k) total += ps[j];
    const float m = total / (float)hw;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      if (j < k) {
        const float nj = (float)chunk_rows(j, rows, hw);
        const float d = ps[j] / nj - m;
        m2 += pq[j] + nj * d * d;
      }
    const float rs = 1.0f / sqrtf(m2 / (float)hw + eps);
    bc[ch] = m;
    bc[ct + ch] = rs;
    const int cg_ch = blockIdx.y * ct + ch;
    if (rank == 0 && rstd_out != nullptr && cg_ch < c)
      rstd_out[(size_t)blockIdx.z * c + cg_ch] = rs;
  }
  cluster_arrive();   // done reading the peers' statistics
  __syncthreads();

  float m[VEC], rs[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    m[v] = bc[g.lane * VEC + v];
    rs[v] = bc[ct + g.lane * VEC + v];
  }
  if (on) {
    T* yg = y + base;
    int r = g.ty;
    for (; r < nheld; r += g.ty_n) {
      Vec<T, VEC>::load(xl + r * ct, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) val[v] = (val[v] - m[v]) * rs[v];
      Vec<T, VEC>::store(yg + (size_t)r * c, val);
    }
#pragma unroll 4
    for (; r < cnt; r += g.ty_n) {
      Vec<T, VEC>::load(xg + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) val[v] = (val[v] - m[v]) * rs[v];
      Vec<T, VEC>::store(yg + (size_t)r * c, val);
    }
  }
  cluster_wait();   // no peer reads this CTA's statistics any more
}

// grid (k, ctiles, n), cluster (k, 1, 1): dx = rstd * (dy - m_dy - y * m_dyy).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
instance_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                         const float* __restrict__ rstd, T* __restrict__ dx,
                         int hw, int c, int ct, int rows, int held) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* st = red + NWARPS * ct;   // chunk sums of dy and of dy * y
  float* bc = st + 2 * ct;         // mean(dy), mean(dy * y)
  T* gs = reinterpret_cast<T*>(bc + 2 * ct);
  T* ys = gs + (size_t)held * ct;

  const Geo g = geo<VEC>(ct);
  const int rank = blockIdx.x;
  const int c0 = blockIdx.y * ct + g.lane * VEC;
  const bool on = c0 < c;
  const int cnt = chunk_rows(rank, rows, hw);
  const int nheld = min(held, cnt);
  const size_t base = ((size_t)blockIdx.z * hw + rank * rows) * c + c0;
  const T* gg = dy + base;
  const T* yg = y + base;
  T* gl = gs + g.lane * VEC;
  T* yl = ys + g.lane * VEC;

  if (on)
    for (int r = g.ty; r < nheld; r += g.ty_n) {
      stage<T, VEC>(gl + r * ct, gg + (size_t)r * c);
      stage<T, VEC>(yl + r * ct, yg + (size_t)r * c);
    }
  staged();

  float a[VEC], b[VEC], gv[VEC], val[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) a[v] = b[v] = 0.f;
  if (on) {
    int r = g.ty;
    for (; r < nheld; r += g.ty_n) {
      Vec<T, VEC>::load(gl + r * ct, gv);
      Vec<T, VEC>::load(yl + r * ct, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        a[v] += gv[v];
        b[v] += gv[v] * val[v];
      }
    }
#pragma unroll 4
    for (; r < cnt; r += g.ty_n) {
      Vec<T, VEC>::load(gg + (size_t)r * c, gv);
      Vec<T, VEC>::load(yg + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        a[v] += gv[v];
        b[v] += gv[v] * val[v];
      }
    }
  }
  block_sum<VEC>(a, red, st, g.lanes, ct);
  block_sum<VEC>(b, red, st + ct, g.lanes, ct);

  cluster_arrive();
  cluster_wait();
  if (threadIdx.x < ct) {
    const int ch = threadIdx.x;
    float pa[MAX_CLUSTER], pb[MAX_CLUSTER];
    peer_stats(st, ch, ct, pa, pb);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      if (j < (int)gridDim.x) {
        sa += pa[j];
        sb += pb[j];
      }
    bc[ch] = sa / (float)hw;
    bc[ct + ch] = sb / (float)hw;
  }
  cluster_arrive();
  __syncthreads();

  if (on) {
    float ma[VEC], mb[VEC], rs[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      ma[v] = bc[g.lane * VEC + v];
      mb[v] = bc[ct + g.lane * VEC + v];
      rs[v] = rstd[(size_t)blockIdx.z * c + c0 + v];
    }
    T* dg = dx + base;
    int r = g.ty;
    for (; r < nheld; r += g.ty_n) {
      Vec<T, VEC>::load(gl + r * ct, gv);
      Vec<T, VEC>::load(yl + r * ct, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        gv[v] = rs[v] * (gv[v] - ma[v] - val[v] * mb[v]);
      Vec<T, VEC>::store(dg + (size_t)r * c, gv);
    }
#pragma unroll 4
    for (; r < cnt; r += g.ty_n) {
      Vec<T, VEC>::load(gg + (size_t)r * c, gv);
      Vec<T, VEC>::load(yg + (size_t)r * c, val);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        gv[v] = rs[v] * (gv[v] - ma[v] - val[v] * mb[v]);
      Vec<T, VEC>::store(dg + (size_t)r * c, gv);
    }
  }
  cluster_wait();
}

// The host's plan, checked against what the kernels can run.
struct Plan {
  int ct, k, rows, held, smem;
};

int vec_of(int c, bool bf16) {
  if (bf16) return c % 8 == 0 ? 8 : 1;
  return c % 4 == 0 ? 4 : 1;
}

bool plan_ok(const Plan& p, int n, int hw, int c, bool bf16, int bufs) {
  const int vec = vec_of(c, bf16);
  if (n < 1 || hw < 1 || c < 1 || p.ct < vec || p.ct % vec != 0) return false;
  const int lanes = p.ct / vec;
  if (lanes > MAX_LANES || (lanes & (lanes - 1)) != 0) return false;
  const int ctiles = (c + p.ct - 1) / p.ct;
  if (n > 65535 || ctiles > 65535) return false;
  if (p.k < 1 || p.k > MAX_CLUSTER || p.rows < 1) return false;
  if ((long long)p.k * p.rows < hw || (long long)(p.k - 1) * p.rows >= hw)
    return false;   // every rank holds one row or more, and all rows are held
  if (p.held < 0 || p.held > p.rows) return false;
  const long long want = smem_bytes(p.ct, p.held, bf16 ? 2 : 4, bufs);
  return want == p.smem && want <= SMEM_MAX;
}

// Allow up to SMEM_MAX of dynamic shared memory and clusters of 16, once
// for each kernel.
template <auto Kernel>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done = true;
  return err;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(const Plan& p, int n, int c, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(p.k, (c + p.ct - 1) / p.ct, n);
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, int VEC>
cudaError_t forward(const void* x, void* y, float* rstd, int n, int hw, int c,
                    float eps, const Plan& p, cudaStream_t stream) {
  constexpr auto kernel = instance_norm_fwd_kernel<T, VEC>;
  cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  Launch l(p, n, c, stream);
  return cudaLaunchKernelEx(&l.cfg, kernel, static_cast<const T*>(x),
                            static_cast<T*>(y), rstd, hw, c, p.ct, p.rows,
                            p.held, eps);
}

template <typename T, int VEC>
cudaError_t backward(const void* dy, const void* y, const float* rstd,
                     void* dx, int n, int hw, int c, const Plan& p,
                     cudaStream_t stream) {
  constexpr auto kernel = instance_norm_bwd_kernel<T, VEC>;
  cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  Launch l(p, n, c, stream);
  return cudaLaunchKernelEx(&l.cfg, kernel, static_cast<const T*>(dy),
                            static_cast<const T*>(y), rstd, static_cast<T*>(dx),
                            hw, c, p.ct, p.rows, p.held);
}

template <auto Kernel>
int active_clusters(const Plan& p, int n, int c) {
  cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return -(int)err;
  Launch l(p, n, c, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, Kernel, &l.cfg);
  return err == cudaSuccess ? count : -(int)err;
}

template <typename T, int VEC>
int active_clusters(const Plan& p, int n, int c, bool backward) {
  return backward ? active_clusters<instance_norm_bwd_kernel<T, VEC>>(p, n, c)
                  : active_clusters<instance_norm_fwd_kernel<T, VEC>>(p, n, c);
}

}  // namespace

// x, y (n, hw, c) contiguous, f32 or bf16 (`is_bf16`); rstd (n, c) f32, or
// null for the forward that keeps nothing. (ct, k, rows, held, smem) is the
// host's launch plan: channels a tile, CTAs a cluster, pixels a CTA, pixels a
// CTA holds in shared memory, and its shared-memory bytes. A plan the
// kernel cannot run returns cudaErrorInvalidValue and launches nothing.
extern "C" int vlg_instance_norm_fwd(const void* x, void* y, void* rstd, int n,
                                     int hw, int c, float eps, int is_bf16,
                                     int ct, int k, int rows, int held,
                                     int smem, void* stream) {
  const Plan p{ct, k, rows, held, smem};
  if (!plan_ok(p, n, hw, c, is_bf16 != 0, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(rstd);
  if (is_bf16) {
    if (c % 8 == 0)
      return (int)forward<__nv_bfloat16, 8>(x, y, rs, n, hw, c, eps, p, s);
    return (int)forward<__nv_bfloat16, 1>(x, y, rs, n, hw, c, eps, p, s);
  }
  if (c % 4 == 0) return (int)forward<float, 4>(x, y, rs, n, hw, c, eps, p, s);
  return (int)forward<float, 1>(x, y, rs, n, hw, c, eps, p, s);
}

// dy, y, dx (n, hw, c) contiguous of one type; rstd (n, c) f32; the plan as
// for the forward, with dy and y both held.
extern "C" int vlg_instance_norm_bwd(const void* dy, const void* y,
                                     const void* rstd, void* dx, int n, int hw,
                                     int c, int is_bf16, int ct, int k,
                                     int rows, int held, int smem,
                                     void* stream) {
  const Plan p{ct, k, rows, held, smem};
  if (!plan_ok(p, n, hw, c, is_bf16 != 0, 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rs = static_cast<const float*>(rstd);
  if (is_bf16) {
    if (c % 8 == 0)
      return (int)backward<__nv_bfloat16, 8>(dy, y, rs, dx, n, hw, c, p, s);
    return (int)backward<__nv_bfloat16, 1>(dy, y, rs, dx, n, hw, c, p, s);
  }
  if (c % 4 == 0)
    return (int)backward<float, 4>(dy, y, rs, dx, n, hw, c, p, s);
  return (int)backward<float, 1>(dy, y, rs, dx, n, hw, c, p, s);
}

// How many clusters of a plan the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 means it cannot run the plan, a
// negative value is a CUDA error or, for a plan the kernel refuses,
// -cudaErrorInvalidValue.
extern "C" int vlg_instance_norm_active_clusters(int n, int hw, int c,
                                                 int is_bf16, int backward,
                                                 int ct, int k, int rows,
                                                 int held, int smem) {
  const Plan p{ct, k, rows, held, smem};
  const bool bf16 = is_bf16 != 0;
  if (!plan_ok(p, n, hw, c, bf16, backward ? 2 : 1))
    return -(int)cudaErrorInvalidValue;
  const bool bwd = backward != 0;
  if (bf16)
    return c % 8 == 0 ? active_clusters<__nv_bfloat16, 8>(p, n, c, bwd)
                      : active_clusters<__nv_bfloat16, 1>(p, n, c, bwd);
  return c % 4 == 0 ? active_clusters<float, 4>(p, n, c, bwd)
                    : active_clusters<float, 1>(p, n, c, bwd);
}
