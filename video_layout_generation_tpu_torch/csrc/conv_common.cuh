// Shared pieces of the implicit-GEMM 3x3 convolution kernels (conv3x3.cu,
// lateral.cu): the tensor-core inner product, the asynchronous staging of
// input and weight chunks into shared memory, the ring that overlaps the
// two, and the store of finished accumulator tiles.
//
// Together the two kernels replace the TPU kernels of
//   video_layout_generation_tpu/ops/pallas/conv_packed.py (_fused_impl,
//     _fused_lateral_impl),
//   video_layout_generation_tpu/ops/pallas/conv1x2.py (_fwd_impl) and
//   video_layout_generation_tpu/ops/pallas/conv3x3.py (_conv3x3_fwd_impl).
//
// Layouts: activations NHWC bf16; weights HWIO (3, 3, Ci, Co) bf16, the flax
// kernel layout, read as (9 * Ci) rows of Co_pad values (Co_pad = Co rounded
// up to 8 so that every row starts on 16 bytes; the wrapper repacks a kernel
// whose Co is not a multiple of 8); bias f32 (Co); PReLU alpha one f32 value
// in device memory (read by the kernel, so the host never synchronises).
//
// The convolution as a matrix product: M = output pixels of a block's tile,
// N = a block of output channels, K = 9 taps x Ci. K is walked in chunks of
// KC = 16 input channels; within a chunk each tap is one k16 step of
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (bf16 operands, f32 accumulators in registers). One m16 tile is 16
// neighbouring pixels of one tile row, so the A operand of tap (ky, kx) is
// the same shared-memory tile read through `ldmatrix` at row addresses
// shifted by (ky, kx): the nine windows, stride 2 and kernel B's second
// stage differ only in those addresses. A goes through registers, where the
// PReLU is applied to the bf16x2 fragments; B (weights, N contiguous) comes
// through `ldmatrix.trans`.
//
// What bounds these convolutions on an H100: at 32 channels and 256x256 a
// conv does 288 MACs per output value, about 144 FLOP per byte moved, below
// the card's ~295 FLOP/byte bf16 balance: bound by device memory; from 64
// channels up they are bound by the tensor cores (989 TFLOP/s dense bf16).
// What the design does about it: the inner product runs on the tensor
// cores; shared memory holds KC channels of the input tile and of the
// weights per stage, not the whole depth, so its size does not grow with Ci
// and several blocks share an SM; a ring of stages is filled by 16-byte
// `cp.async` copies (zero-fill form for the padding and for channels past
// Ci) while the previous chunk is multiplied; pixel and weight rows are
// padded by 16 bytes, which makes their stride an odd number of 16-byte
// units and every `ldmatrix` phase conflict-free; the blocks are persistent
// and the ring runs on from one tile to the next, so a shallow conv (two
// chunks at Ci = 32) keeps loads in flight across tiles; bias, residual,
// ReLU and the single rounding to bf16 happen on the f32 accumulators, which
// pass through a warp-private scratch so that device memory sees 16-byte
// rows: each activation crosses device memory once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vlg {

constexpr int KC = 16;          // input channels per chunk: one k16 step a tap
constexpr int NTHREADS = 128;   // four warps a block
constexpr int NWARPS = NTHREADS / 32;
constexpr int PIX_BYTES = (KC + 8) * 2;   // one staged pixel: 32 B + 16 B pad
constexpr int W_ROWS = 9 * KC;            // weight rows of a chunk

__host__ __device__ constexpr int w_row_bytes(int bn) { return (bn + 8) * 2; }

// PReLU on a register of two bf16 values, with the slope rounded to bf16 and
// the product rounded to bf16, as the JAX executor computes it on bf16
// activations: a * min(x, 0) + max(x, 0), one addend of which is always zero,
// so the fused multiply-add rounds the exact product once (x < 0) or returns
// x.
__device__ __forceinline__ uint32_t prelu_bf16x2(uint32_t x,
                                                 __nv_bfloat162 a2) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 z = __float2bfloat162_rn(0.f);
  const __nv_bfloat162 r = __hfma2(a2, __hmin2(v, z), __hmax2(v, z));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The `ldmatrix` row of lane `lane` in a 16 x 16 operand tile: lanes 0-15
// address rows 0-15 of the first eight k (or n), lanes 16-31 the same rows of
// the second eight.
__device__ __forceinline__ int frag_row(int lane) { return lane & 15; }
__device__ __forceinline__ int frag_half_bytes(int lane) {
  return (lane >> 4) * 16;
}

// One chunk of KC input channels: for the nine taps,
//   acc[m][j] += A_m(tap) (16 pixels x KC) * W(tap) (KC x 8 channels, j-th)
// a_addr[m]: this lane's shared-memory row address of m-tile m at tap (0, 0)
// (its pixel's first channel of the chunk, plus the lane's k half);
// tap (ky, kx) lies ky * a_row_bytes + kx * a_px_bytes further.
// w_addr: this lane's row address in the staged weights at tap 0 (row
// frag_row, plus the lane's n half); tap t lies t * KC rows further and the
// pair of n-tiles p 32 bytes further.
template <int MT, int NT, bool ACT>   // NT even
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4],
                                          const uint32_t (&a_addr)[MT],
                                          int a_row_bytes, int a_px_bytes,
                                          uint32_t w_addr, int w_row_b,
                                          __nv_bfloat162 alpha2) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int a_off = ky * a_row_bytes + kx * a_px_bytes;
      const uint32_t w_tap = w_addr + (ky * 3 + kx) * KC * w_row_b;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldmatrix_x4(a[m], a_addr[m] + a_off);
        if (ACT) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[m][r] = prelu_bf16x2(a[m][r], alpha2);
        }
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, w_tap + p * 32);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * p], a[m], b[0], b[1]);
          mma_bf16(acc[m][2 * p + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][j][r] = 0.f;
}

// The (row << 8 | column) in a (rows x cols) window of the k-th 16-byte
// granule that this thread stages (granule threadIdx.x + k * NTHREADS; two a
// pixel), or 0xffff past the window's end; two granules a register.
// MAXS * NTHREADS must cover the window, whose sides are below 256.
constexpr int NO_SLOT = 0xffff;

template <int MAXS>
__device__ __forceinline__ void input_slots(int rows, int cols,
                                            uint32_t (&slot)[(MAXS + 1) / 2]) {
#pragma unroll
  for (int k = 0; k < (MAXS + 1) / 2; ++k) slot[k] = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < MAXS; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    const int pix = i >> 1;
    const uint32_t v =
        i < rows * cols * 2 ? ((pix / cols) << 8 | (pix % cols)) : NO_SLOT;
    slot[k / 2] = (k & 1) ? ((slot[k / 2] & 0xffffu) | (v << 16))
                          : ((slot[k / 2] & 0xffff0000u) | v);
  }
}

// Stage channels [c0, c0 + KC) of a (rows x cols) window of one NHWC image,
// whose top-left input pixel is (y0, x0), at `dst` with PIX_BYTES a pixel.
// Pixels outside the image (the convolution's zero padding) and channels
// past ci are zero. With ci a multiple of 8 every 16-byte granule is one
// asynchronous copy; otherwise (the 3-channel image, the 10- and 12-channel
// stems) the global rows are not 16-byte aligned and the values are moved
// one by one through registers: for staging only, the inner product is the
// same.
// `slot` (input_slots) holds the window coordinates of the granules this
// thread copies, which are the same for every chunk and tile: no division
// is left in the loop.
template <int MAXS>
__device__ __forceinline__ void stage_input(const __nv_bfloat16* __restrict__ img,
                                            int h, int w, int ci, int c0,
                                            int y0, int x0, int rows, int cols,
                                            unsigned char* dst,
                                            const uint32_t (&slot)[(MAXS + 1) / 2]) {
  if ((ci & 7) == 0) {
    const uint32_t d0 = smem_addr(dst);
#pragma unroll
    for (int k = 0; k < MAXS; ++k) {
      const int sk = (slot[k / 2] >> ((k & 1) * 16)) & 0xffff;
      if (sk == NO_SLOT) continue;
      const int i = threadIdx.x + k * NTHREADS;
      const int g = i & 1;
      const int pix = i >> 1;
      const int gy = y0 + (sk >> 8);
      const int gx = x0 + (sk & 0xff);
      const int c = c0 + g * 8;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w && c < ci;
      // one image is below 2^31 elements (the wrapper checks)
      const __nv_bfloat16* src = img + (ok ? (gy * w + gx) * ci + c : 0);
      cp_async16(d0 + pix * PIX_BYTES + g * 16, src, ok);
    }
  } else {
    const int total = rows * cols * KC;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < total; i += NTHREADS) {
      const int k = i & (KC - 1);
      const int pix = i / KC;
      const int gy = y0 + pix / cols;
      const int gx = x0 + pix % cols;
      const int c = c0 + k;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w && c < ci;
      reinterpret_cast<__nv_bfloat16*>(dst + pix * PIX_BYTES)[k] =
          ok ? img[((size_t)gy * w + gx) * ci + c] : zero;
    }
  }
}

// Stage the weights of input channels [c0, c0 + KC) and output channels
// [n0, n0 + BN) for the nine taps: rows t * KC + k of w_row_bytes(BN) bytes.
// Rows past ci and granules past co_pad are zero.
template <int BN>
__device__ __forceinline__ void stage_weights(const __nv_bfloat16* __restrict__ wt,
                                              int ci, int co_pad, int c0,
                                              int n0, unsigned char* dst) {
  constexpr int G = BN / 8;               // 16-byte granules a row
  constexpr int STEP = NTHREADS / G;      // rows between a thread's granules
  static_assert(STEP % KC == 0, "a thread must stay on one input channel");
  // a thread copies granule g of rows row0, row0 + STEP, ...: always input
  // channel k, STEP / KC taps further each time
  const int g = threadIdx.x % G;
  const int row0 = threadIdx.x / G;
  const int k = row0 & (KC - 1);
  const int n = n0 + g * 8;
  const bool ok = c0 + k < ci && n < co_pad;
  const __nv_bfloat16* src =
      wt + (ok ? ((row0 / KC) * ci + c0 + k) * co_pad + n : 0);
  const int src_step = ok ? (STEP / KC) * ci * co_pad : 0;
  uint32_t d = smem_addr(dst) + row0 * w_row_bytes(BN) + g * 16;
  for (int row = row0; row < W_ROWS; row += STEP) {
    cp_async16(d, src, ok);
    src += src_step;
    d += STEP * w_row_bytes(BN);
  }
}

// One finished m-tile (16 pixels x NT * 8 channels) from the accumulator
// fragments to device memory: + bias (+ residual) (-> ReLU) -> bf16, rounded
// once. The fragments hold two channels a lane, which would make 4-byte
// accesses; they pass through a warp-private f32 scratch in shared memory
// (16 rows of NT * 8 + 8 floats) so that a lane owns 8 neighbouring channels
// of a pixel: 16-byte residual loads and stores, a pixel's channels on
// neighbouring lanes. `pixel(r)` gives the flat output pixel of row r of
// the m-tile, or -1 where the row lies outside the image or the tile. With
// co no multiple of 8 the rows are not 16-byte aligned and the same lanes
// move their channels four at a time (co a multiple of 4) or one by one.
template <int NT, typename PixelFn>
__device__ __forceinline__ void store_mtile(const float (&acc)[NT][4],
                                            float* scratch,
                                            const float (&bv)[8],
                                            const __nv_bfloat16* __restrict__ res,
                                            __nv_bfloat16* __restrict__ out,
                                            int co, int n0, bool relu,
                                            PixelFn pixel) {
  constexpr int RS = NT * 8 + 8;
  constexpr int ITERS = NT / 2;        // 16 * NT granules over 32 lanes
  constexpr int ROWS = 32 / NT;        // pixel rows a pass
  const int lane = threadIdx.x & 31;
  const int row = lane >> 2;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(scratch + row * RS + j * 8 + cq) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(scratch + (row + 8) * RS + j * 8 + cq) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  // this lane's granule: the same 8 channels in every pass
  const int c = n0 + (lane % NT) * 8;
  const float* src0 = scratch + (lane / NT) * RS + (lane % NT) * 8;
  if (c < co && (co & 7) == 0) {
    // all residual loads first, so that their latencies overlap
    long long p[ITERS];
    uint4 rr[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      p[it] = pixel(lane / NT + it * ROWS);
      if (res != nullptr && p[it] >= 0)
        rr[it] = __ldg(reinterpret_cast<const uint4*>(res + p[it] * co + c));
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      if (p[it] < 0) continue;
      const float* src = src0 + it * ROWS * RS;
      float v[8];
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float4*>(v + 4) =
          *reinterpret_cast<const float4*>(src + 4);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += bv[k];
      if (res != nullptr) {
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&rr[it]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h2[k]);
          v[2 * k] += f.x;
          v[2 * k + 1] += f.y;
        }
      }
      uint4 u;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float lo = v[2 * k], hi = v[2 * k + 1];
        if (relu) {
          lo = fmaxf(lo, 0.f);
          hi = fmaxf(hi, 0.f);
        }
        h2[k] = __floats2bfloat162_rn(lo, hi);
      }
      *reinterpret_cast<uint4*>(out + p[it] * co + c) = u;
    }
  } else if (c < co) {
    const bool quads = (co & 3) == 0;   // rows start on 8 bytes
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const long long p = pixel(lane / NT + it * ROWS);
      if (p < 0) continue;
      const float* src = src0 + it * ROWS * RS;
      const size_t o = (size_t)p * co + c;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (c + 4 * q >= co) break;
        float v[4];
        *reinterpret_cast<float4*>(v) =
            *reinterpret_cast<const float4*>(src + 4 * q);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] += bv[4 * q + k];
        if (quads) {
          // the 20-channel head: four channels at a time
          if (res != nullptr) {
            const uint2 u =
                __ldg(reinterpret_cast<const uint2*>(res + o + 4 * q));
            const __nv_bfloat162* h2 =
                reinterpret_cast<const __nv_bfloat162*>(&u);
            const float2 f0 = __bfloat1622float2(h2[0]);
            const float2 f1 = __bfloat1622float2(h2[1]);
            v[0] += f0.x; v[1] += f0.y; v[2] += f1.x; v[3] += f1.y;
          }
          if (relu) {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = fmaxf(v[k], 0.f);
          }
          uint2 u;
          __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
          h2[0] = __floats2bfloat162_rn(v[0], v[1]);
          h2[1] = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(out + o + 4 * q) = u;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (c + 4 * q + k < co) {
              float x = v[k];
              if (res != nullptr) x += __bfloat162float(res[o + 4 * q + k]);
              if (relu) x = fmaxf(x, 0.f);
              out[o + 4 * q + k] = __float2bfloat16(x);
            }
          }
        }
      }
    }
  }
  __syncwarp();
}

// The 8 bias values of this lane's granule in store_mtile (channels
// n0 + (lane % NT) * 8 ...), zero past co. They change only with the block of
// output channels, so a persistent block loads them once for many items.
template <int NT>
__device__ __forceinline__ void load_bias(const float* __restrict__ bias,
                                          int co, int n0, float (&bv)[8]) {
  const int c = n0 + ((threadIdx.x & 31) % NT) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) bv[k] = c + k < co ? __ldg(bias + c + k) : 0.f;
}

__host__ __device__ constexpr int scratch_bytes(int nt) {
  return NWARPS * 16 * (nt * 8 + 8) * 4;
}

// The ring: `load(step, stage)` issues the copies of one step into one stage,
// `compute(step, stage)` consumes it. Up to stages - 1 steps are in flight
// while one is computed. One barrier a step: it makes the step's copies
// (and any plain stores of the scalar staging path) visible to all warps,
// and it orders the previous step's reads before the stage is refilled.
template <typename Load, typename Compute>
__device__ __forceinline__ void run_ring(int n_steps, int stages, Load load,
                                         Compute compute) {
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait(stages - 2);
    __syncthreads();
    const int next = s + stages - 1;
    if (next < n_steps) load(next, next % stages);
    cp_async_commit();
    compute(s, s % stages);
  }
  cp_async_wait(0);
}

// Host side: let `kernel` use `smem` bytes of dynamic shared memory with the
// SM's carveout at its largest, and return how many persistent blocks of
// NTHREADS the card holds at once (0 and `*err` set on failure). A
// persistent grid larger than that would run its last blocks alone, after
// the others have finished. The answer is kept for the last `smem` asked.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int smem, int* cache_smem,
                           int* cache_blocks, cudaError_t* err) {
  *err = cudaSuccess;
  if (*cache_smem == smem) return *cache_blocks;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
      (*err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) ||
      (*err = cudaGetDevice(&dev)) ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, smem)))
    return 0;
  if (per_sm < 1) {
    *err = cudaErrorLaunchOutOfResources;
    return 0;
  }
  *cache_smem = smem;
  *cache_blocks = per_sm * sms;
  return *cache_blocks;
}

}  // namespace vlg
