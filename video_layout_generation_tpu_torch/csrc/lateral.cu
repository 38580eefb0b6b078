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
// What bounds it on an H100: the fused block reads x once and writes the
// output once (plus the residual), so at row 0 (C = 32, 256x256) it does
// twice kernel A's operations over the same bytes and sits near the card's
// bf16 balance point (~295 FLOP/byte); rows 1-2 (C = 64, 96) are bound by
// the tensor cores. The design: both convs run kernel A's inner product
// (conv_common.cuh: `mma.sync` m16n8k16, A through `ldmatrix` and registers,
// 16-channel chunks through a `cp.async` ring). A block owns 14 x 14 output
// pixels; conv0 runs over the 16 x 16 halo'd intermediate, which is a whole
// number of m16 tiles (one per row, four per warp), so it recomputes
// 256 / 196 = 1.31x of conv0's work; its epilogue writes bf16 pairs from the
// accumulator fragments into shared memory (pixel stride an odd number of
// 16-byte units: conflict-free for these stores and for conv1's `ldmatrix`),
// and conv1 reads that tile through the same row addressing, with only its
// weights streamed. Output channels go in blocks of 32; the weights of both
// convs stream per (block, chunk) through one ring that runs across the two
// convs and on across the tiles of a persistent block, so conv1's first
// weights arrive while conv0 finishes and the next tile's input while this
// one is stored. conv1's accumulators reach device memory as 16-byte rows
// through store_mtile, whose scratch is the input half of the current ring
// stage (conv1 stages weights only). Shared memory is the intermediate (256
// pixels x C) plus the ring: 75-105 KB for C = 32 to 96, two or three blocks
// an SM.
#include "conv_common.cuh"

namespace {

using vlg::KC;
using vlg::NTHREADS;
using vlg::PIX_BYTES;
using vlg::W_ROWS;

constexpr int TILE = 14;         // output tile, square
constexpr int MID = TILE + 2;    // intermediate: tile + 1-pixel halo = 16
constexpr int IN = TILE + 4;     // input: tile + 2-pixel halo
constexpr int MT = 4;            // m16 tiles (rows) a warp
constexpr int NT = 4;            // n8 tiles a pass
constexpr int BN = NT * 8;
constexpr int IN_BYTES = IN * IN * PIX_BYTES;
constexpr int STAGE_BYTES = IN_BYTES + W_ROWS * vlg::w_row_bytes(BN);
static_assert(vlg::scratch_bytes(NT) <= IN_BYTES,
              "the store scratch must fit the input half of a ring stage");

__host__ __device__ inline int mid_pix_bytes(int c) {
  return (((c + KC - 1) / KC) * KC + 8) * 2;
}

__global__ void __launch_bounds__(NTHREADS, 2)
fused_lateral_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w0,
                         const float* __restrict__ b0,
                         const float* __restrict__ a0,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ a1,
                         const __nv_bfloat16* __restrict__ res,
                         __nv_bfloat16* __restrict__ out, int h, int wd,
                         int c, int c_pad, int tiles_w, int tiles_h,
                         int n_tiles, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int mid_px = mid_pix_bytes(c);
  unsigned char* ring = smem + MID * MID * mid_px;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const __nv_bfloat162 alpha0 = __float2bfloat162_rn(*a0);
  const __nv_bfloat162 alpha1 = __float2bfloat162_rn(*a1);

  const int n_chunks = (c + KC - 1) / KC;
  const int n_blocks = (c + BN - 1) / BN;
  const int per_conv = n_blocks * n_chunks;

  // this lane's ldmatrix rows: conv0 reads the staged input (relative to a
  // stage), conv1 the intermediate. conv1's m-tiles are output rows; rows
  // and columns past the 14 x 14 tile are clamped onto it and masked at the
  // store.
  uint32_t a0_rel[MT], a1_abs[MT];
  const int col1 = min(vlg::frag_row(lane), TILE - 1);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    a0_rel[m] = ((warp * MT + m) * IN + vlg::frag_row(lane)) * PIX_BYTES +
                vlg::frag_half_bytes(lane);
    const int row1 = min(warp * MT + m, TILE - 1);
    a1_abs[m] = vlg::smem_addr(smem) + (row1 * MID + col1) * mid_px +
                vlg::frag_half_bytes(lane);
  }
  const uint32_t w_rel = IN_BYTES + vlg::frag_row(lane) * vlg::w_row_bytes(BN) +
                         vlg::frag_half_bytes(lane);
  const uint32_t ring0 = vlg::smem_addr(ring);
  const int cq = (lane & 3) * 2;

  constexpr int MAXS = (IN * IN * 2 + NTHREADS - 1) / NTHREADS;
  uint32_t slot[(MAXS + 1) / 2];
  vlg::input_slots<MAXS>(IN, IN, slot);

  float acc[MT][NT][4];
  vlg::zero_acc<MT, NT>(acc);

  // A persistent block takes a contiguous run of tiles (row by row within
  // an image), so that a cursor steps to the next one without a division;
  // a tile is 2 * per_conv ring steps. The loads run ahead of the
  // arithmetic, so each keeps a cursor of its own.
  const int first_tile = (int)((long long)n_tiles * blockIdx.x / gridDim.x);
  const int end_tile =
      (int)((long long)n_tiles * (blockIdx.x + 1) / gridDim.x);
  float bv[8];
  int bias_n0 = -1;
  struct Cursor {
    int step, tx, ty, n;
  } ld, cp;
  ld.step = 0;
  ld.tx = first_tile % tiles_w;
  ld.ty = (first_tile / tiles_w) % tiles_h;
  ld.n = first_tile / (tiles_w * tiles_h);
  cp = ld;
  auto advance = [&](Cursor& k) {
    if (++k.step < 2 * per_conv) return;
    k.step = 0;
    if (++k.tx < tiles_w) return;
    k.tx = 0;
    if (++k.ty < tiles_h) return;
    k.ty = 0;
    ++k.n;
  };

  vlg::run_ring(
      (end_tile - first_tile) * 2 * per_conv, stages,
      [&](int, int stage) {
        unsigned char* base = ring + stage * STAGE_BYTES;
        const bool first = ld.step < per_conv;
        const int r = first ? ld.step : ld.step - per_conv;
        const int c0 = (r % n_chunks) * KC;
        const int n0 = (r / n_chunks) * BN;
        if (first)
          vlg::stage_input<MAXS>(x + (size_t)ld.n * h * wd * c, h, wd, c, c0,
                                 ld.ty * TILE - 2, ld.tx * TILE - 2, IN, IN,
                                 base, slot);
        vlg::stage_weights<BN>(first ? w0 : w1, c, c_pad, c0, n0,
                               base + IN_BYTES);
        advance(ld);
      },
      [&](int, int stage) {
        const uint32_t base = ring0 + stage * STAGE_BYTES;
        const bool first = cp.step < per_conv;
        const int r = first ? cp.step : cp.step - per_conv;
        const int chunk = r % n_chunks;
        const int n0 = (r / n_chunks) * BN;
        const int n = cp.n, oy0 = cp.ty * TILE, ox0 = cp.tx * TILE;
        advance(cp);
        uint32_t a_addr[MT];
        if (first) {
#pragma unroll
          for (int m = 0; m < MT; ++m) a_addr[m] = base + a0_rel[m];
          vlg::mma_chunk<MT, NT, true>(acc, a_addr, IN * PIX_BYTES, PIX_BYTES,
                                       base + w_rel, vlg::w_row_bytes(BN),
                                       alpha0);
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m)
            a_addr[m] = a1_abs[m] + chunk * KC * 2;
          vlg::mma_chunk<MT, NT, false>(acc, a_addr, MID * mid_px, mid_px,
                                        base + w_rel, vlg::w_row_bytes(BN),
                                        alpha0);
        }
        if (chunk != n_chunks - 1) return;
        // a block of output channels is complete
        if (first) {
          // conv0 -> + b0 -> bf16 -> PReLU1 -> shared memory; zero outside
          // the image and in the channels that pad C to a multiple of KC
          float2 bias[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int ch = n0 + j * 8 + cq;
            bias[j].x = ch < c ? __ldg(b0 + ch) : 0.f;
            bias[j].y = ch + 1 < c ? __ldg(b0 + ch + 1) : 0.f;
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int my = warp * MT + m;
            const int gy = oy0 - 1 + my;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int mx = (lane >> 2) + half * 8;
              const int gx = ox0 - 1 + mx;
              const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
              unsigned char* px = smem + (my * MID + mx) * mid_px;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const int ch = n0 + j * 8 + cq;
                if (ch >= n_chunks * KC) continue;
                // one rounding to bf16, then PReLU1 on the pair as conv1
                // would apply it to its A fragments
                __nv_bfloat162 v = __floats2bfloat162_rn(
                    acc[m][j][2 * half] + bias[j].x,
                    acc[m][j][2 * half + 1] + bias[j].y);
                uint32_t u = vlg::prelu_bf16x2(
                    *reinterpret_cast<uint32_t*>(&v), alpha1);
                if (!inside || ch >= c) u = 0u;
                else if (ch + 1 >= c) u &= 0xffffu;
                *reinterpret_cast<uint32_t*>(px + ch * 2) = u;
              }
            }
          }
        } else {
          // conv1 -> + b1 (+ residual) -> bf16 -> device memory, through
          // this stage's input half, which conv1 leaves unused
          float* scratch = reinterpret_cast<float*>(ring + stage * STAGE_BYTES)
                           + warp * 16 * (BN + 8);
          if (n0 != bias_n0) {
            vlg::load_bias<NT>(b1, c, n0, bv);
            bias_n0 = n0;
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int ry = warp * MT + m;
            const int oy = oy0 + ry;
            const long long row = (ry < TILE && oy < h)
                                      ? ((long long)n * h + oy) * wd : -1;
            vlg::store_mtile<NT>(acc[m], scratch, bv, res, out, c, n0, false,
                                 [&](int rx) {
                                   return (row >= 0 && rx < TILE &&
                                           ox0 + rx < wd)
                                              ? row + ox0 + rx
                                              : -1LL;
                                 });
          }
        }
        vlg::zero_acc<MT, NT>(acc);
      });
}

}  // namespace

// w0, w1 hold (9 * c) rows of c_pad values (c_pad a multiple of 8, >= c).
// stages (2 to 4), smem_bytes and blocks (the persistent grid, cut here to
// what the card holds at once) are the wrapper's plan.
extern "C" int vlg_fused_lateral(const void* x, const void* w0,
                                 const void* b0, const void* a0,
                                 const void* w1, const void* b1,
                                 const void* a1, const void* res, void* out,
                                 int n, int h, int wd, int c, int c_pad,
                                 int stages, int smem_bytes, int blocks,
                                 void* stream) {
  if (stages < 2 || stages > 4 || (c_pad & 7) || c_pad < c)
    return (int)cudaErrorInvalidValue;
  // the plan and the kernel must agree on the shared-memory layout
  if (smem_bytes != MID * MID * mid_pix_bytes(c) + stages * STAGE_BYTES)
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (h + TILE - 1) / TILE;
  const int tiles_w = (wd + TILE - 1) / TILE;
  static int cache_smem = -1, cache_blocks = 0;
  cudaError_t err;
  const int resident = vlg::resident_blocks(
      fused_lateral_mma_kernel, smem_bytes, &cache_smem, &cache_blocks, &err);
  if (err != cudaSuccess) return (int)err;
  if (blocks > resident) blocks = resident;
  const int n_tiles = n * tiles_h * tiles_w;
  if (blocks < 1 || blocks > n_tiles) return (int)cudaErrorInvalidValue;
  fused_lateral_mma_kernel<<<(unsigned)blocks, NTHREADS, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0),
      static_cast<const float*>(a0), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(a1),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), h, wd, c, c_pad, tiles_w, tiles_h,
      n_tiles, stages);
  return (int)cudaGetLastError();
}
