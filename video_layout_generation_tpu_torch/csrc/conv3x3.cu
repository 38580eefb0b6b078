// Kernel A: y = conv3x3(prelu(x, alpha)) + bias [+ residual], zero padding 1,
// stride 1 or 2, NHWC bf16 in and out, f32 accumulation; with `relu` the
// result is clamped at zero in the epilogue (the conv -> ReLU layers of VGG19
// and HNED). Its data gradient is a launch of the same kernel on the flipped,
// transposed weights.
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
// What bounds it on an H100, by shape class: the 3-, 8-, 10- and 20-channel
// ends of the nets and GridNet's 32-channel row at 256x256 are bound by
// device memory (144 FLOP per byte at C = 32 against a balance of ~295); from
// 64 channels up (GridNet rows 1-2, every layer of VGG19 and HNED past
// conv1_1) the bound is the tensor cores. The design (conv_common.cuh): an
// implicit GEMM on `mma.sync` m16n8k16 with a block tile of 8 x 16 or 16 x 16
// output pixels by BN = 32 or 64 output channels, four warps of two or four
// pixel rows each. The larger tile halves the `ldmatrix` traffic per `mma`
// and the number of items to set up and store; the smaller one is for
// stride 2 (whose input window would not fit) and for images too small to
// fill the card otherwise. The input tile with its halo and the weights are
// staged 16 input channels at a time through a `cp.async` ring, so shared
// memory per block does not depend on Ci. The blocks are persistent: each
// walks over a run of (pixel tile, channel block) items and the ring runs
// on across them, so that the loads of the next item are in flight while
// this one is multiplied and stored, which is what the shallow,
// memory-bound convs (two chunks at Ci = 32) need. The PReLU is applied to
// the A fragments in registers; bias, residual, ReLU and the rounding to
// bf16 happen on the accumulators, which reach device memory as 16-byte
// rows (store_mtile). Channel counts that are no multiple of 16 (Ci) or 8
// (Co) run on the same kernel: K is zero-padded in shared memory, N is
// masked at the store. These kernels are bound by instruction latency
// before anything else (12 or 8 warps an SM), so the staging and store code
// avoids divisions and 64-bit address arithmetic. The tile, BN, the number
// of stages and the grid come from the wrapper's plan
// (ops/kernels/conv3x3.py:conv_plan), which a CPU test holds.
#include "conv_common.cuh"

namespace {

using vlg::KC;
using vlg::NTHREADS;
using vlg::NWARPS;
using vlg::PIX_BYTES;
using vlg::W_ROWS;

constexpr int TILE_W = 16;   // one m16 tile a row; a warp owns MT rows

__host__ __device__ inline int in_extent(int tile, int stride) {
  return (tile - 1) * stride + 3;
}

struct Shape {
  int h, wd, ci, co, co_pad, stride, ho, wo, tiles_w, tiles_h, n_tiles,
      n_items, relu, stages;
};

// Where a block is in its run of items and in the item's chunks. Items are
// numbered channel block * n_tiles + pixel tile, pixel tiles row by row
// within an image; a block takes a contiguous run of them, so that the
// cursor steps from one to the next without a division. The loads run ahead
// of the arithmetic, so each keeps a cursor of its own.
struct Cursor {
  int chunk, tx, ty, n, cb;

  __device__ __forceinline__ void start(const Shape& s, int item) {
    chunk = 0;
    int t = item % s.n_tiles;
    cb = item / s.n_tiles;
    tx = t % s.tiles_w;
    t /= s.tiles_w;
    ty = t % s.tiles_h;
    n = t / s.tiles_h;
  }
  __device__ __forceinline__ void next(const Shape& s, int n_chunks,
                                       int n_images) {
    if (++chunk < n_chunks) return;
    chunk = 0;
    if (++tx < s.tiles_w) return;
    tx = 0;
    if (++ty < s.tiles_h) return;
    ty = 0;
    if (++n < n_images) return;
    n = 0;
    ++cb;
  }
};

// The second launch bound is the number of blocks that the plan's shared
// memory lets an SM hold: it tells ptxas how many registers a thread may
// take before a block is lost, so that it does not spill to save a few.
template <int MT, int NT, bool ACT>
__global__ void __launch_bounds__(NTHREADS, NT == 4 ? 3 : 2)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ alpha,
                   const __nv_bfloat16* __restrict__ res,
                   __nv_bfloat16* __restrict__ out, const Shape s) {
  constexpr int BN = NT * 8;
  constexpr int TILE_H = NWARPS * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int in_rows = in_extent(TILE_H, s.stride);
  const int in_cols = in_extent(TILE_W, s.stride);
  const int in_bytes = in_rows * in_cols * PIX_BYTES;
  const int stage_bytes = in_bytes + W_ROWS * vlg::w_row_bytes(BN);
  unsigned char* ring = smem + vlg::scratch_bytes(NT);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* scratch = reinterpret_cast<float*>(smem) + warp * 16 * (BN + 8);
  __nv_bfloat162 alpha2 = __float2bfloat162_rn(0.f);
  if (ACT) alpha2 = __float2bfloat162_rn(*alpha);

  // this lane's ldmatrix rows, relative to a stage's start
  uint32_t a_rel[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
    a_rel[m] = (((warp * MT + m) * s.stride) * in_cols +
                vlg::frag_row(lane) * s.stride) * PIX_BYTES +
               vlg::frag_half_bytes(lane);
  const uint32_t w_rel = in_bytes +
                         vlg::frag_row(lane) * vlg::w_row_bytes(BN) +
                         vlg::frag_half_bytes(lane);
  const uint32_t ring0 = vlg::smem_addr(ring);

  // granules of the input window a thread stages: 8 x 16 outputs at stride
  // 2 read 17 x 33 pixels, 16 x 16 at stride 1 read 18 x 18
  constexpr int MAXS = MT == 2 ? 9 : 6;
  uint32_t slot[(MAXS + 1) / 2];
  vlg::input_slots<MAXS>(in_rows, in_cols, slot);

  float acc[MT][NT][4];
  vlg::zero_acc<MT, NT>(acc);

  const int n_chunks = (s.ci + KC - 1) / KC;
  const int n_images = s.n_tiles / (s.tiles_h * s.tiles_w);
  const int first_item =
      (int)((long long)s.n_items * blockIdx.x / gridDim.x);
  const int end_item =
      (int)((long long)s.n_items * (blockIdx.x + 1) / gridDim.x);
  float bv[8];
  int bias_cb = -1;
  Cursor ld, cp;
  ld.start(s, first_item);
  cp.start(s, first_item);
  vlg::run_ring(
      (end_item - first_item) * n_chunks, s.stages,
      [&](int, int stage) {
        unsigned char* base = ring + stage * stage_bytes;
        vlg::stage_input<MAXS>(x + (size_t)ld.n * s.h * s.wd * s.ci, s.h, s.wd,
                               s.ci, ld.chunk * KC,
                               ld.ty * TILE_H * s.stride - 1,
                               ld.tx * TILE_W * s.stride - 1, in_rows,
                               in_cols, base, slot);
        vlg::stage_weights<BN>(w, s.ci, s.co_pad, ld.chunk * KC, ld.cb * BN,
                               base + in_bytes);
        ld.next(s, n_chunks, n_images);
      },
      [&](int, int stage) {
        const uint32_t base = ring0 + stage * stage_bytes;
        uint32_t a_addr[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) a_addr[m] = base + a_rel[m];
        vlg::mma_chunk<MT, NT, ACT>(acc, a_addr, in_cols * PIX_BYTES,
                                    PIX_BYTES, base + w_rel,
                                    vlg::w_row_bytes(BN), alpha2);
        if (cp.chunk == n_chunks - 1) {
          const int ox0 = cp.tx * TILE_W;
          if (cp.cb != bias_cb) {
            vlg::load_bias<NT>(bias, s.co, cp.cb * BN, bv);
            bias_cb = cp.cb;
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int oy = cp.ty * TILE_H + warp * MT + m;
            const long long row =
                oy < s.ho ? ((long long)cp.n * s.ho + oy) * s.wo : -1;
            vlg::store_mtile<NT>(acc[m], scratch, bv, res, out, s.co,
                                 cp.cb * BN, s.relu != 0, [&](int r) {
                                   return (row >= 0 && ox0 + r < s.wo)
                                              ? row + ox0 + r
                                              : -1LL;
                                 });
          }
          vlg::zero_acc<MT, NT>(acc);
        }
        cp.next(s, n_chunks, n_images);
      });
}

struct Args {
  const void *x, *w, *bias, *alpha, *res;
  void* out;
  int n, h, wd, ci, co, co_pad, stride, relu, stages, smem, blocks;
  cudaStream_t stream;
};

template <int MT, int NT, bool ACT>
cudaError_t launch(const Args& a) {
  constexpr int BN = NT * 8;
  constexpr int TILE_H = NWARPS * MT;
  Shape s;
  s.h = a.h; s.wd = a.wd; s.ci = a.ci; s.co = a.co; s.co_pad = a.co_pad;
  s.stride = a.stride; s.relu = a.relu; s.stages = a.stages;
  s.ho = (a.h - 1) / a.stride + 1;
  s.wo = (a.wd - 1) / a.stride + 1;
  s.tiles_h = (s.ho + TILE_H - 1) / TILE_H;
  s.tiles_w = (s.wo + TILE_W - 1) / TILE_W;
  s.n_tiles = a.n * s.tiles_h * s.tiles_w;
  s.n_items = s.n_tiles * ((a.co + BN - 1) / BN);
  const int stage = in_extent(TILE_H, a.stride) * in_extent(TILE_W, a.stride) *
                        PIX_BYTES + W_ROWS * vlg::w_row_bytes(BN);
  // the plan and the kernel must agree on the shared-memory layout
  if (a.smem != vlg::scratch_bytes(NT) + a.stages * stage ||
      (MT == 4 && a.stride != 1) ||
      a.blocks < 1 || a.blocks > s.n_items)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_mma_kernel<MT, NT, ACT>;
  static int cache_smem = -1, cache_blocks = 0;
  cudaError_t err;
  const int resident =
      vlg::resident_blocks(kernel, a.smem, &cache_smem, &cache_blocks, &err);
  if (err != cudaSuccess) return err;
  const int blocks = a.blocks < resident ? a.blocks : resident;
  kernel<<<(unsigned)blocks, NTHREADS, a.smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.alpha),
      static_cast<const __nv_bfloat16*>(a.res),
      static_cast<__nv_bfloat16*>(a.out), s);
  return cudaGetLastError();
}

template <int MT, int NT>
cudaError_t launch_act(const Args& a) {
  return a.alpha != nullptr ? launch<MT, NT, true>(a)
                            : launch<MT, NT, false>(a);
}

}  // namespace

// w holds (9 * ci) rows of co_pad values (co_pad a multiple of 8, >= co).
// tile_h (8 or 16 output rows a block), bn (32 or 64 output channels),
// stages (2 to 4), smem_bytes and blocks (the persistent grid, cut here to
// what the card holds at once) are the wrapper's plan.
extern "C" int vlg_prelu_conv3x3(const void* x, const void* w,
                                 const void* bias, const void* alpha,
                                 const void* res, void* out, int n, int h,
                                 int wd, int ci, int co, int co_pad,
                                 int stride, int relu, int tile_h, int bn,
                                 int stages, int smem_bytes, int blocks,
                                 void* stream) {
  if (stages < 2 || stages > 4 || (co_pad & 7) || co_pad < co ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, alpha, res, out, n, h, wd, ci, co, co_pad, stride,
               relu, stages, smem_bytes, blocks,
               static_cast<cudaStream_t>(stream)};
  if (tile_h == 8 && bn == 32) return (int)launch_act<2, 4>(a);
  if (tile_h == 8 && bn == 64) return (int)launch_act<2, 8>(a);
  if (tile_h == 16 && bn == 32) return (int)launch_act<4, 4>(a);
  if (tile_h == 16 && bn == 64) return (int)launch_act<4, 8>(a);
  return (int)cudaErrorInvalidValue;
}
