// Fused IntrinsicNeRF MLP backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// intrinsicnerf_tpu/ops/fused_mlp.py, launched there by `_fused_bwd`.
// Given the points in8 [P, 8] and the bf16 cotangent g [P, 128] of the
// packed output, it recomputes the forward without the five output
// products, backpropagates g through the heads and the trunk with ReLU
// masks from the recomputed activations, and returns dW = act^T g for all
// 20 packed weight blocks and db = sum(g) for the biases, in fp32.  The
// points get no gradient (exact: NeRF samples are not parameters).
// Rounding follows `_bwd_kernel`: every product takes bf16 operands with
// fp32 accumulation; each gradient is formed in fp32, its bias gradient
// is the fp32 sum of that unrounded value, and it is rounded to bf16 only
// as a product operand.  Saved activations are bf16 (the weight products
// cast them so anyway); the ReLU masks test the fp32 value, as the plain
// version does.
//
// Bound, on an H100 (989 TFLOP/s bf16, 3.35 TB/s).  Operations: the
// network needs 2,046,720 multiply-adds per point in the backward (C =
// 27): 691,072 to recompute the forward, 695,680 for the weight products
// and 659,968 for the input products of every layer whose input depends on
// parameters; 0.81 ms for the fine call's 196,608 points.  Bytes: 32 B of
// points and 256 B of cotangent per point, and the arena below, which the
// split into two passes writes and reads back: 11,776 B per point each
// way, 2.32 GB per fine call, 0.69 ms to write and 0.69 ms to read at the
// memory's rate.  So each pass is bound by its arena bytes (0.71 / 0.70 ms
// at fine), and a step's two calls by 1.84 ms of arena traffic.
//
// Design: four launches in one call.
//  0. `bwd_act_wimg_kernel`: the weight image, every K-slab the activation pass
//     streams (64 rows of W for a forward product, 64 columns of W^T for
//     an input product of the backward; 104 per tile, 2.98 MB in all),
//     each laid out as it sits in shared memory (128-byte swizzle,
//     hopper_mma.cuh), in the order the products consume them.
//  1. `bwd_act_wgmma_kernel`: one block per 64-point tile, one block per
//     SM (221 KB of shared memory): two consumer warpgroups and a producer
//     warp.  The producer moves the weight image slab by slab into a
//     3-stage ring of 32 KB with one bulk copy each (the copy engine, an
//     mbarrier per stage for full and one for empty), running ahead of the
//     consumers across layer boundaries and epilogues.  The consumers
//     recompute the forward and run the backward chain with the tile's
//     activations and gradients in shared memory, each a K-major operand
//     of 64-column atoms; every product is wgmma m64nNk16 from shared
//     memory with the two warpgroups splitting the output columns (N = 128
//     each for a 256-wide layer, 64 for a 128-wide head) and one slab's
//     products left in flight while the next is issued.  Epilogues work on
//     the accumulator registers: bias (loaded before the product) and ReLU,
//     the ReLU's mask kept as one bit per register in shared memory for
//     the backward (no re-read of the arena), rows past P zeroed in the
//     gradients, bf16 pairs into the next product's operand, then 16-byte
//     copies of the warpgroup's columns to the arena, and the bias partials
//     as column sums in a fixed order (lane shuffles, then the four warps).
//     The arena holds 5,888 bf16 per point, row-major per buffer; rows past
//     P are zero-gradient padding up to a multiple of 64.
//  2. `bwd_wgrad_gemm_kernel`: dW = A^T G for the 20 weight blocks as 51
//     output tiles of 128x128, each over one of `splits` point chunks, so
//     that 255 blocks of two warpgroups run as one wave at two per SM.
//     Point slabs of A and G (64 x 128 each) stream through a 3-stage ring
//     by 16-byte cp.async into swizzled atoms; the arena is point-major, so
//     both operands are MN-major and wgmma m64n128k16 takes both
//     transposed.  Each (tile, chunk) writes its fp32 partial to a
//     workspace [splits, 835,584] straight from the registers.
//  3. `reduce_rows_kernel` (twice): the partials and the per-tile bias
//     partials summed in a fixed order.
// No atomics anywhere: two launches on the same inputs give bitwise-equal
// gradients.  The TPU kernel accumulates dW in place across its sequential
// grid instead; a GPU grid runs in parallel and dW (3.3 MB in fp32) does
// not fit in a block, hence the arena and the partials.
//
// Copies: bulk copies (the copy engine without a tensor map) for the
// weights, whose image is contiguous per slab; 16-byte cp.async for the
// arena's slabs, which are strided.  TMA tensor maps would fit the arena
// too, but the arena is a fresh allocation on every call, so its maps
// would be encoded per call through the driver API (a libcuda link this
// plain-C build does not have).  Measured on the card (PERF.md, PR 5, at
// the fine shape): the activation pass took 5.5 ms with the weights loaded
// by cp.async from every thread behind a block barrier per slab, 3.4 ms with
// the producer's bulk copies, 2.8 ms with one slab's products in flight and
// the bias loaded ahead.

#include <climits>

#include "fused_mlp_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace fmlp;

// Arena layout: each buffer [p_pad, width] bf16 row-major, starting at
// (its offset below) * p_pad elements.
constexpr int AR_FEAT = 0;              // PE features, 128
constexpr int AR_ACT = AR_FEAT + IN_W;  // trunk activations 0..7, W each
constexpr int AR_A1 = AR_ACT + 8 * W;
constexpr int AR_S1 = AR_A1 + HW;
constexpr int AR_M1 = AR_S1 + HW;
constexpr int AR_F = AR_M1 + HW;        // feature (no ReLU), W
constexpr int AR_V = AR_F + W;
constexpr int AR_GO = AR_V + HW;        // the cotangent, zero past P, 128
constexpr int AR_G = AR_GO + OUT_W;     // trunk pre-activation gradients 0..7
constexpr int AR_GA1 = AR_G + 8 * W;
constexpr int AR_GS1 = AR_GA1 + HW;
constexpr int AR_GM1 = AR_GS1 + HW;
constexpr int AR_GV = AR_GM1 + HW;
constexpr int AR_GF = AR_GV + HW;
constexpr int AR_COLS = AR_GF + W;
static_assert(AR_COLS == 5888, "arena layout changed");

// ---- the activation pass ----
//
// Shared memory of one 64-point tile (byte offsets from a 1 KB boundary).
// Every activation or gradient buffer is K-major for the next product:
// 64-column atoms of 64 rows (hopper_mma.cuh), 8 KB each.
//  overlay, forward:  feat [0, 16K)  bufA [16K, 48K)  bufB [48K, 80K)
//                     head scratch [80K, 96K)
//  overlay, backward: go [0, 16K)  gv / ga1 / gs1 / gm1 [16K, 64K), the
//                     trunk gradients ping [16K, 48K) and pong [64K, 96K),
//                     gf [64K, 96K)
//  weight ring: ACT_STAGES x 32 KB, one K-slab of 64 of a weight block each
//  ReLU masks: one bit per accumulator register of each thread, 12 layers
//  column-sum scratch: [2 warpgroups][4 warps][128] fp32
//  the ring's barriers: full and empty, one each per stage
constexpr int ATOM = 64 * 128;  // one 64-row atom
constexpr int OV_FEAT = 0, OV_BUFA = 16384, OV_BUFB = 49152, OV_HEAD = 81920;
constexpr int OV_GO = 0, OV_R1 = 16384, OV_R2 = 65536;
constexpr int SM_RING = 98304;
constexpr int ACT_STAGES = 3;
constexpr int ACT_STAGE_BYTES = 32768;
constexpr int SM_MASKS = SM_RING + ACT_STAGES * ACT_STAGE_BYTES;
constexpr int N_MASKS = 12;  // act0..act7, v, a1, s1, m1
constexpr int SM_COLSUM = SM_MASKS + N_MASKS * NTHREADS * 8;
constexpr int SM_BARS = SM_COLSUM + 2 * 4 * 128 * 4;
constexpr int ACT_SMEM = SM_BARS + 2 * ACT_STAGES * 8 + 1024;  // + slack to align to 1 KB
static_assert(ACT_SMEM <= 232448, "the activation pass exceeds a block's shared memory");
static_assert(NTHREADS == 256, "two consumer warpgroups");
constexpr int ACT_THREADS = NTHREADS + 32;  // + the producer warp
enum { MK_V = 8, MK_A1, MK_S1, MK_M1 };

// One weight block as the products stream it, K-slab by K-slab: forward
// products read W [in, out] (K = in, N = out; MN-major: each slab is N/64
// atoms of 64 k-rows), the input products of the backward read W^T (K =
// out, N = in; K-major: each slab is N rows of 64 k).  `ldw` = out.
struct Seg {
  int w_off, ldw, K, N, wt;
};
#define FWD(off, in, out) {(int)(off), out, in, out, 0}
#define BWD(off, in, out) {(int)(off), out, out, in, 1}
#define SEG_TABLE                                                                             \
  {FWD(OFF_W0, IN_W, W), FWD(OFF_W1, W, W), FWD(OFF_W2, W, W), FWD(OFF_W3, W, W),             \
   FWD(OFF_W4, W, W), FWD(OFF_W5H, W, W), FWD(OFF_W5X, IN_W, W), FWD(OFF_W6, W, W),           \
   FWD(OFF_W7, W, W), FWD(OFF_WF, W, W), FWD(OFF_WVF, W, HW), FWD(OFF_WVD, IN_W, HW),         \
   FWD(OFF_WA1, W, HW), FWD(OFF_WS1, W, HW), FWD(OFF_WM1, W, HW),                             \
   BWD(OFF_WR, HW, OUT_W), BWD(OFF_WVF, W, HW), BWD(OFF_WA2, HW, OUT_W),                      \
   BWD(OFF_WS2, HW, OUT_W), BWD(OFF_WM2, HW, OUT_W),                                          \
   BWD(OFF_WSIG, W, OUT_W), BWD(OFF_WA1, W, HW), BWD(OFF_WS1, W, HW), BWD(OFF_WM1, W, HW),    \
   BWD(OFF_WF, W, W),                                                                         \
   BWD(OFF_W7, W, W), BWD(OFF_W6, W, W), BWD(OFF_W5H, W, W), BWD(OFF_W4, W, W),               \
   BWD(OFF_W3, W, W), BWD(OFF_W2, W, W), BWD(OFF_W1, W, W)}
constexpr int N_SEGS = 32;
constexpr Seg kSegs[N_SEGS] = SEG_TABLE;
__constant__ Seg c_segs[N_SEGS] = SEG_TABLE;
#undef SEG_TABLE
#undef FWD
#undef BWD

constexpr int count_slabs() {
  int n = 0;
  for (const Seg& s : kSegs) n += s.K / 64;
  return n;
}
constexpr long image_elems() {
  long n = 0;
  for (const Seg& s : kSegs) n += (long)s.K * s.N;
  return n;
}
constexpr int N_SLABS = count_slabs();       // 104 per tile
constexpr long IMG_ELEMS = image_elems();    // 1,490,944 bf16

// The weight image: every slab of every tile's sequence, in c_segs order,
// laid out byte for byte as it sits in a stage (64 * N bf16 each), so that
// the producer moves a slab with one bulk copy.  One block per slab.
__global__ void __launch_bounds__(NTHREADS)
bwd_act_wimg_kernel(const bf16* __restrict__ w, bf16* __restrict__ img) {
  int i = blockIdx.x, seg = 0;
  long off = 0;
  for (; seg < N_SEGS - 1 && i >= c_segs[seg].K / 64; ++seg) {
    i -= c_segs[seg].K / 64;
    off += (long)c_segs[seg].K * c_segs[seg].N;
  }
  const Seg s = c_segs[seg];
  unsigned char* st = reinterpret_cast<unsigned char*>(img + off + (long)i * 64 * s.N);
  const int k0 = i * 64;
  for (int e = threadIdx.x; e < 8 * s.N; e += NTHREADS) {
    const bf16* src;
    uint32_t dst;
    if (s.wt) {  // rows n of W^T's slab: W[n, k0 : k0 + 64]
      const int row = e >> 3, c = e & 7;
      src = w + s.w_off + (long)row * s.ldw + k0 + c * 8;
      dst = hmma::sw128(row, c);
    } else {  // rows k of W's slab: W[k0 + k, :], 64 columns per atom
      const int cpr = s.N >> 3;
      const int row = e / cpr, c = e % cpr;
      src = w + s.w_off + (long)(k0 + row) * s.ldw + c * 8;
      dst = (c >> 3) * ATOM + hmma::sw128(row, c & 7);
    }
    *reinterpret_cast<uint4*>(st + dst) = *reinterpret_cast<const uint4*>(src);
  }
}

// The producer: one thread of the extra warp moves the weight image into
// the ring, slab by slab, ACT_STAGES ahead of the consumers at most; a
// stage's `full` barrier completes when its bytes have landed, its
// `empty` barrier when the eight consumer warps are done with it.
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full, uint32_t empty,
                                        const bf16* __restrict__ img) {
  long off = 0;
  int i = 0;
  for (int seg = 0; seg < N_SEGS; ++seg) {
    const uint32_t bytes = 128 * c_segs[seg].N;  // 64 x N bf16
    for (int k = 0; k < c_segs[seg].K / 64; ++k, ++i) {
      const int st = i % ACT_STAGES;
      if (i >= ACT_STAGES) hmma::mbar_wait(empty + st * 8, ((i / ACT_STAGES) - 1) & 1);
      hmma::mbar_expect_tx(full + st * 8, bytes);
      hmma::bulk_load(ring + st * ACT_STAGE_BYTES, img + off, bytes, full + st * 8);
      off += bytes / 2;
    }
  }
}

// The consumers' side of the ring: the index of the next slab to consume
struct Ring {
  uint32_t base, full, empty;
  int it;
};

// the barrier of the 256 consumer threads (the producer warp stays out)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// acc[64 x NW] (this warpgroup's columns) += A[64, 64 * kslabs] @ the next
// kslabs slabs of the ring.  A: a K-major activation buffer at shared
// address `a`, written by both warpgroups' epilogues before this call.
// WT: the slabs hold W^T (K-major) rather than W (MN-major).
template <int NW, int WT>
__device__ __forceinline__ void mma_slabs(float (&acc)[NW / 2], Ring& r, uint32_t a, int kslabs) {
  const int wg = threadIdx.x >> 7;
  hmma::fence_proxy_async();  // the epilogues' shared writes, to wgmma's proxy
  consumer_sync();
  int prev = -1;  // the stage of the slab whose products may still run
  for (int s = 0; s < kslabs; ++s) {
    const int st = r.it % ACT_STAGES;
    hmma::mbar_wait(r.full + st * 8, (r.it / ACT_STAGES) & 1);
    const uint32_t slab = r.base + st * ACT_STAGE_BYTES;
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hmma::desc_sw128(a + s * ATOM + kk * 32, 16, 1024);
      const uint64_t db =
          WT ? hmma::desc_sw128(slab + wg * NW * 128 + kk * 32, 16, 1024)
             : hmma::desc_sw128(slab + wg * (NW / 64) * ATOM + kk * 2048, ATOM, 1024);
      if constexpr (NW == 128)
        hmma::wgmma_m64n128k16<0, WT ? 0 : 1>(acc, da, db, 1);
      else
        hmma::wgmma_m64n64k16<0, WT ? 0 : 1>(acc, da, db, 1);
    }
    hmma::wgmma_commit();
    if (prev >= 0) {  // the previous slab's products are done: its stage is free
      hmma::wgmma_wait<1>();
      if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(r.empty + prev * 8);
    }
    prev = st;
    ++r.it;
  }
  hmma::wgmma_wait<0>();
  if ((threadIdx.x & 31) == 0) hmma::mbar_arrive(r.empty + prev * 8);
  hmma::fence_regs(acc);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// byte offset of element (row, col) in a K-major buffer of 64-column atoms
__device__ __forceinline__ uint32_t kmaj(int row, int col) {
  return (uint32_t)((col >> 6) * ATOM) + hmma::sw128(row, (col & 63) >> 3) + (col & 7) * 2;
}

__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

// the 64 rows of columns [col0, col0 + ncols) of a K-major shared buffer
// to the arena (row stride `width`), 16 bytes at a time by `nt` threads
__device__ __forceinline__ void copy_out(const unsigned char* S, int col0, int ncols, int width,
                                         bf16* G, int t, int nt) {
  const int cpr = ncols >> 3;
  for (int e = t; e < 64 * cpr; e += nt) {
    const int row = e / cpr, c = col0 + (e % cpr) * 8;
    *reinterpret_cast<uint4*>(G + (long)row * width + c) =
        *reinterpret_cast<const uint4*>(S + kmaj(row, c));
  }
}

// the bias of this warpgroup's NW columns in the accumulator's column
// order, loaded before the product so that its latency hides behind it
template <int NW>
__device__ __forceinline__ void load_bias(float (&bv)[NW / 4], const float* __restrict__ bias) {
  const int col = (threadIdx.x >> 7) * NW + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    bv[2 * j] = __ldg(bias + col + j * 8);
    bv[2 * j + 1] = __ldg(bias + col + j * 8 + 1);
  }
}

// Forward epilogue of this warpgroup's NW columns: bf16(act(acc + bias))
// into the K-major buffer D (the next product's A), the ReLU's mask bits
// into `mask`, then the columns to the arena (G, row stride `width`).
template <int NW>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[NW / 2], const float (&bv)[NW / 4],
                                             bool relu, unsigned char* D, uint32_t* mask, bf16* G,
                                             int width) {
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, lane = lt & 31;
  const int r0 = (lt >> 5) * 16 + (lane >> 2);
  uint32_t bits[NW / 64] = {};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = wg * NW + j * 8 + 2 * (lane & 3);
    const float b0 = bv[2 * j], b1 = bv[2 * j + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      float v0 = acc[i] + b0, v1 = acc[i + 1] + b1;
      if (relu) {
        bits[i >> 5] |= (v0 > 0.0f ? 1u : 0u) << (i & 31);
        bits[i >> 5] |= (v1 > 0.0f ? 1u : 0u) << ((i + 1) & 31);
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(D + kmaj(r0 + 8 * h, col)) = __floats2bfloat162_rn(v0, v1);
    }
  }
  if (relu)
#pragma unroll
    for (int q = 0; q < NW / 64; ++q) mask[q] = bits[q];
  wg_sync();
  copy_out(D, wg * NW, NW, width, G, lt, 128);
}

// Gradient epilogue of this warpgroup's NW columns: v = acc, zero where
// the mask bit is clear (when `mask` is set) and past n; bf16(v) into D and
// the arena, and the fp32 column sums of v over the tile's 64 rows (lanes,
// then the four warps in order) into bsum.
template <int NW>
__device__ __forceinline__ void grad_epilogue(const float (&acc)[NW / 2], const uint32_t* mask,
                                              unsigned char* D, bf16* G, int width, float* bsum,
                                              float* colsum, long long row0, long long n) {
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127, warp = lt >> 5, lane = lt & 31;
  const int r0 = warp * 16 + (lane >> 2);
  uint32_t bits[NW / 64];
#pragma unroll
  for (int q = 0; q < NW / 64; ++q) bits[q] = mask ? mask[q] : 0xFFFFFFFFu;
  const bool live0 = row0 + r0 < n, live1 = row0 + r0 + 8 < n;
  float* cs = colsum + (wg * 4 + warp) * 128;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = wg * NW + j * 8 + 2 * (lane & 3);
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const bool live = h ? live1 : live0;
      const float v0 = live && ((bits[i >> 5] >> (i & 31)) & 1u) ? acc[i] : 0.0f;
      const float v1 = live && ((bits[i >> 5] >> ((i + 1) & 31)) & 1u) ? acc[i + 1] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(D + kmaj(r0 + 8 * h, col)) = __floats2bfloat162_rn(v0, v1);
      s0 += v0;
      s1 += v1;
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, o);
      s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, o);
    }
    if (lane < 4) {
      cs[j * 8 + 2 * lane] = s0;
      cs[j * 8 + 2 * lane + 1] = s1;
    }
  }
  wg_sync();
  copy_out(D, wg * NW, NW, width, G, lt, 128);
  if (lt < NW) {
    const float* c0 = colsum + wg * 4 * 128 + lt;
    bsum[wg * NW + lt] = ((c0[0] + c0[128]) + c0[256]) + c0[384];
  }
}

// PE features of the tile into the K-major buffer `feat` (two atoms), as
// kernel 1's compute_feat (fused_mlp_fwd.cu) computes them
__device__ __forceinline__ void compute_feat_kmaj(unsigned char* feat,
                                                  const float* __restrict__ in8,
                                                  const float* __restrict__ pe_mat,
                                                  const float* __restrict__ sin_mask,
                                                  long long row0, long long n) {
  for (int e = threadIdx.x; e < TILE_M * IN_W; e += NTHREADS) {
    const int i = e / IN_W, c = e % IN_W;
    const long long p = row0 + i;
    float f = 0.0f;
    if (p < n) {
      const float* x = in8 + p * IN8_W;
      float z = __fmul_rn(x[0], pe_mat[c]);
#pragma unroll
      for (int k = 1; k < IN8_W; ++k) z = __fadd_rn(z, __fmul_rn(x[k], pe_mat[k * IN_W + c]));
      f = sin_mask[c] != 0.0f ? sinf(z) : z;
    }
    *reinterpret_cast<bf16*>(feat + kmaj(i, c)) = __float2bfloat16(f);
  }
}

__global__ void __launch_bounds__(ACT_THREADS, 1)
bwd_act_wgmma_kernel(const float* __restrict__ in8, const float* __restrict__ pe_mat,
                     const float* __restrict__ sin_mask, const bf16* __restrict__ img,
                     const float* __restrict__ b, const bf16* __restrict__ g,
                     bf16* __restrict__ arena, float* __restrict__ bpart, long long n,
                     long long p_pad) {
  extern __shared__ __align__(128) unsigned char act_smem[];
  unsigned char* sm = act_smem + ((1024u - (hmma::smem_u32(act_smem) & 1023u)) & 1023u);
  const uint32_t sa = hmma::smem_u32(sm);
  const long long row0 = (long long)blockIdx.x * TILE_M;
  auto ar = [&](int off, int width) { return arena + (long)off * p_pad + row0 * width; };
  float* bsum = bpart + (long)blockIdx.x * B_TOTAL;
  float* colsum = reinterpret_cast<float*>(sm + SM_COLSUM);
  uint32_t* masks = reinterpret_cast<uint32_t*>(sm + SM_MASKS) + threadIdx.x * 2;
  auto mask = [&](int layer) { return masks + layer * NTHREADS * 2; };
  Ring ring{sa + SM_RING, sa + SM_BARS, sa + SM_BARS + ACT_STAGES * 8, 0};
  if (threadIdx.x == 0)
    for (int st = 0; st < ACT_STAGES; ++st) {
      hmma::mbar_init(ring.full + st * 8, 1);    // the producer's expect_tx
      hmma::mbar_init(ring.empty + st * 8, 8);   // the eight consumer warps
    }
  hmma::fence_mbar_init();
  __syncthreads();
  if (threadIdx.x >= NTHREADS) {  // the producer warp
    if (threadIdx.x == NTHREADS) produce(ring.base, ring.full, ring.empty, img);
    return;
  }
  float acc2[64];  // a 256-wide product: 128 columns per warpgroup
  float acc1[32];  // a 128-wide product: 64 columns per warpgroup

  // ---- forward recompute (kernel 1 without the output products) ----
  compute_feat_kmaj(sm + OV_FEAT, in8, pe_mat, sin_mask, row0, n);
  consumer_sync();
  copy_out(sm + OV_FEAT, 0, IN_W, IN_W, ar(AR_FEAT, IN_W), threadIdx.x, NTHREADS);
  uint32_t src = sa + OV_FEAT;
  int kslabs = IN_W / 64;
  float bv2[32], bv1[16];  // the product's bias
  for (int l = 0; l < 8; ++l) {
    const int dst = l % 2 == 0 ? OV_BUFA : OV_BUFB;
    zero_acc(acc2);
    load_bias<128>(bv2, b + B_TRUNK + l * W);
    mma_slabs<128, 0>(acc2, ring, src, kslabs);
    if (l == 5) mma_slabs<128, 0>(acc2, ring, sa + OV_FEAT, IN_W / 64);
    fwd_epilogue<128>(acc2, bv2, true, sm + dst, mask(l), ar(AR_ACT + l * W, W), W);
    src = sa + dst;
    kslabs = W / 64;
  }
  const uint32_t Hs = sa + OV_BUFB;  // act7
  zero_acc(acc2);  // f = H@w_f + b_f -> bufA
  load_bias<128>(bv2, b + B_F);
  mma_slabs<128, 0>(acc2, ring, Hs, 4);
  fwd_epilogue<128>(acc2, bv2, false, sm + OV_BUFA, nullptr, ar(AR_F, W), W);
  zero_acc(acc1);  // v = relu(f@wv_f + feat@wv_d + b_v)
  load_bias<64>(bv1, b + B_V);
  mma_slabs<64, 0>(acc1, ring, sa + OV_BUFA, 4);
  mma_slabs<64, 0>(acc1, ring, sa + OV_FEAT, 2);
  fwd_epilogue<64>(acc1, bv1, true, sm + OV_HEAD, mask(MK_V), ar(AR_V, HW), HW);
  zero_acc(acc1);  // a1, s1, m1 = relu(H@w + b)
  load_bias<64>(bv1, b + B_A1);
  mma_slabs<64, 0>(acc1, ring, Hs, 4);
  fwd_epilogue<64>(acc1, bv1, true, sm + OV_BUFA, mask(MK_A1), ar(AR_A1, HW), HW);
  zero_acc(acc1);
  load_bias<64>(bv1, b + B_S1);
  mma_slabs<64, 0>(acc1, ring, Hs, 4);
  fwd_epilogue<64>(acc1, bv1, true, sm + OV_BUFA + 2 * ATOM, mask(MK_S1), ar(AR_S1, HW), HW);
  zero_acc(acc1);
  load_bias<64>(bv1, b + B_M1);
  mma_slabs<64, 0>(acc1, ring, Hs, 4);
  fwd_epilogue<64>(acc1, bv1, true, sm + OV_HEAD, mask(MK_M1), ar(AR_M1, HW), HW);
  consumer_sync();  // the forward's buffers are read; the backward's overlay them

  // ---- backward chain ----
  {
    bf16* go_ar = ar(AR_GO, OUT_W);
    for (int e = threadIdx.x; e < TILE_M * OUT_W / 8; e += NTHREADS) {
      const int i = e >> 4, c = (e & 15) * 8;
      const long long p = row0 + i;
      const uint4 v =
          p < n ? *reinterpret_cast<const uint4*>(g + p * OUT_W + c) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(sm + OV_GO + kmaj(i, c)) = v;
      *reinterpret_cast<uint4*>(go_ar + (long)i * OUT_W + c) = v;
    }
    consumer_sync();
    if (threadIdx.x < OUT_W) {  // the five output biases' gradient: sum(go)
      float s = 0.0f;
      for (int i = 0; i < TILE_M; ++i)
        s += __bfloat162float(*reinterpret_cast<const bf16*>(sm + OV_GO + kmaj(i, threadIdx.x)));
      bsum[B_OUT + threadIdx.x] = s;
    }
  }
  const uint32_t go = sa + OV_GO;
  // gv = (go @ w_r^T) * (v > 0); gf = gv @ wv_f^T (f has no ReLU)
  zero_acc(acc1);
  mma_slabs<64, 1>(acc1, ring, go, 2);
  grad_epilogue<64>(acc1, mask(MK_V), sm + OV_R1, ar(AR_GV, HW), HW, bsum + B_V, colsum, row0, n);
  zero_acc(acc2);
  mma_slabs<128, 1>(acc2, ring, sa + OV_R1, 2);
  grad_epilogue<128>(acc2, nullptr, sm + OV_R2, ar(AR_GF, W), W, bsum + B_F, colsum, row0, n);
  // head gradients: g1 = (go @ w2^T) * (act1 > 0) -> ga1, gs1, gm1
  zero_acc(acc1);
  mma_slabs<64, 1>(acc1, ring, go, 2);
  grad_epilogue<64>(acc1, mask(MK_A1), sm + OV_R1, ar(AR_GA1, HW), HW, bsum + B_A1, colsum, row0,
                    n);
  zero_acc(acc1);
  mma_slabs<64, 1>(acc1, ring, go, 2);
  grad_epilogue<64>(acc1, mask(MK_S1), sm + OV_R1 + 2 * ATOM, ar(AR_GS1, HW), HW, bsum + B_S1,
                    colsum, row0, n);
  zero_acc(acc1);
  mma_slabs<64, 1>(acc1, ring, go, 2);
  grad_epilogue<64>(acc1, mask(MK_M1), sm + OV_R1 + 4 * ATOM, ar(AR_GM1, HW), HW, bsum + B_M1,
                    colsum, row0, n);
  // dH = go@w_sig^T + ga1@w_a1^T + gs1@w_s1^T + gm1@w_m1^T + gf@w_f^T
  zero_acc(acc2);
  mma_slabs<128, 1>(acc2, ring, go, 2);
  mma_slabs<128, 1>(acc2, ring, sa + OV_R1, 2);
  mma_slabs<128, 1>(acc2, ring, sa + OV_R1 + 2 * ATOM, 2);
  mma_slabs<128, 1>(acc2, ring, sa + OV_R1 + 4 * ATOM, 2);
  mma_slabs<128, 1>(acc2, ring, sa + OV_R2, 4);
  consumer_sync();  // gh7 overlays the head gradients just read
  grad_epilogue<128>(acc2, mask(7), sm + OV_R1, ar(AR_G + 7 * W, W), W, bsum + B_TRUNK + 7 * W,
                     colsum, row0, n);
  // trunk: gh_{l-1} = (gh_l @ w_l^T) * (act_{l-1} > 0), l = 7..1
  int cur = OV_R1, other = OV_R2;
  for (int l = 7; l >= 1; --l) {
    zero_acc(acc2);
    mma_slabs<128, 1>(acc2, ring, sa + cur, 4);
    grad_epilogue<128>(acc2, mask(l - 1), sm + other, ar(AR_G + (l - 1) * W, W), W,
                       bsum + B_TRUNK + (l - 1) * W, colsum, row0, n);
    const int t = cur;
    cur = other;
    other = t;
  }
}

// One weight gradient dW[K, N] = A[P, K]^T @ G[P, N] (arena buffers).
struct Job {
  int a_off, lda, g_off, ldg, K, N;
  long w_off;
};

constexpr int N_JOBS = 20;

// The weight-gradient GEMM.  Output tiles of TK x TN = 128 x 128 cover
// every block exactly (K and N are each 128 or 256): 51 tiles.  A block
// is two warpgroups, one per 64-row half of the tile, over one point
// chunk.  Point slabs of A [SLAB, 128] and G [SLAB, 128] stream through a
// ring of STAGES stages in shared memory by 16-byte cp.async, each slab
// stored as two 64-column atoms (hopper_mma.cuh); the arena is
// point-major, so both operands are MN-major (the contraction runs down
// the slab's rows) and the wgmma takes both transposed.
constexpr int TK = 128, TN = 128;
constexpr int N_TILES = (int)(W_TOTAL / (TK * TN));
static_assert(N_TILES * TK * TN == W_TOTAL, "every block is a whole number of tiles");
constexpr int SLAB = 64;                     // points per stage; p_pad is a multiple
constexpr int STAGES = 3;
constexpr int ATOM_BYTES = SLAB * 128;       // 64 columns x SLAB rows
constexpr int STAGE_BYTES = 4 * ATOM_BYTES;  // A: 2 atoms, G: 2 atoms (32 KB)
constexpr int WG_THREADS = 256;
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
static_assert(TILE_M % SLAB == 0, "the arena's rows are whole slabs");

#define JOB(a, la, g, lg, k, n, off) {a, la, g, lg, k, n, off}
__constant__ Job c_jobs[N_JOBS] = {
    JOB(AR_FEAT, IN_W, AR_G + 0 * W, W, IN_W, W, OFF_W0),
    JOB(AR_ACT + 0 * W, W, AR_G + 1 * W, W, W, W, OFF_W1),
    JOB(AR_ACT + 1 * W, W, AR_G + 2 * W, W, W, W, OFF_W2),
    JOB(AR_ACT + 2 * W, W, AR_G + 3 * W, W, W, W, OFF_W3),
    JOB(AR_ACT + 3 * W, W, AR_G + 4 * W, W, W, W, OFF_W4),
    JOB(AR_FEAT, IN_W, AR_G + 5 * W, W, IN_W, W, OFF_W5X),
    JOB(AR_ACT + 4 * W, W, AR_G + 5 * W, W, W, W, OFF_W5H),
    JOB(AR_ACT + 5 * W, W, AR_G + 6 * W, W, W, W, OFF_W6),
    JOB(AR_ACT + 6 * W, W, AR_G + 7 * W, W, W, W, OFF_W7),
    JOB(AR_ACT + 7 * W, W, AR_GO, OUT_W, W, OUT_W, OFF_WSIG),
    JOB(AR_ACT + 7 * W, W, AR_GA1, HW, W, HW, OFF_WA1),
    JOB(AR_A1, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WA2),
    JOB(AR_ACT + 7 * W, W, AR_GS1, HW, W, HW, OFF_WS1),
    JOB(AR_S1, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WS2),
    JOB(AR_ACT + 7 * W, W, AR_GF, W, W, W, OFF_WF),
    JOB(AR_F, W, AR_GV, HW, W, HW, OFF_WVF),
    JOB(AR_FEAT, IN_W, AR_GV, HW, IN_W, HW, OFF_WVD),
    JOB(AR_V, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WR),
    JOB(AR_ACT + 7 * W, W, AR_GM1, HW, W, HW, OFF_WM1),
    JOB(AR_M1, HW, AR_GO, OUT_W, HW, OUT_W, OFF_WM2),
};
#undef JOB

// one slab (SLAB points from row p) of A's columns [k0, k0 + 128) and G's
// [n0, n0 + 128) into the stage at shared address `st`; 16 threads per
// 256-byte row, 8 chunks per thread
__device__ __forceinline__ void load_slab(uint32_t st, const bf16* A, int lda, int k0,
                                          const bf16* G, int ldg, int n0, long long p) {
#pragma unroll
  for (int i = 0; i < 2 * SLAB * 16 / WG_THREADS; ++i) {
    const int e = threadIdx.x + i * WG_THREADS;
    const int op = e / (SLAB * 16);  // 0: A, 1: G
    const int row = (e / 16) % SLAB, c = e % 16;
    const bf16* src = op == 0 ? A + (p + row) * lda + k0 + c * 8 : G + (p + row) * ldg + n0 + c * 8;
    hmma::cp_async16(st + (uint32_t)(op * 2 + c / 8) * ATOM_BYTES + hmma::sw128(row, c % 8), src);
  }
}

__global__ void __launch_bounds__(WG_THREADS, 2)
bwd_wgrad_gemm_kernel(const bf16* __restrict__ arena, float* __restrict__ ws, long long p_pad,
                      long long chunk) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t ring = (hmma::smem_u32(wg_smem) + 1023u) & ~1023u;
  // the job owning this output tile: jobs own K*N / (TK*TN) tiles each,
  // in weight-buffer order
  int t = blockIdx.x, j = 0;
  for (; j < N_JOBS - 1; ++j) {
    const int tiles = c_jobs[j].K * c_jobs[j].N / (TK * TN);
    if (t < tiles) break;
    t -= tiles;
  }
  const Job job = c_jobs[j];
  const int tiles_n = job.N / TN;
  const int k0 = (t / tiles_n) * TK, n0 = (t % tiles_n) * TN;
  const bf16* A = arena + (long)job.a_off * p_pad;
  const bf16* G = arena + (long)job.g_off * p_pad;
  const long long p_begin = (long long)blockIdx.y * chunk;
  const long long p_end = p_begin + chunk < p_pad ? p_begin + chunk : p_pad;
  const int n_slabs = p_end > p_begin ? (int)((p_end - p_begin) / SLAB) : 0;
  const int wg = threadIdx.x / 128;  // this warpgroup's 64 rows of the tile

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs)
      load_slab(ring + s * STAGE_BYTES, A, job.lda, k0, G, job.ldg, n0, p_begin + s * SLAB);
    hmma::cp_async_commit();
  }
  for (int it = 0; it < n_slabs; ++it) {
    hmma::cp_async_wait<STAGES - 2>();  // slab `it` has landed (this thread's part)
    hmma::fence_proxy_async();
    __syncthreads();  // ... everyone's part; slab it - 1's stage is free
    const int nxt = it + STAGES - 1;
    if (nxt < n_slabs)
      load_slab(ring + (nxt % STAGES) * STAGE_BYTES, A, job.lda, k0, G, job.ldg, n0,
                p_begin + (long long)nxt * SLAB);
    hmma::cp_async_commit();
    const uint32_t st = ring + (it % STAGES) * STAGE_BYTES;
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB / 16; ++kk) {
      // 16 points: A^T rows = this half's 64 columns of A, B = G's 128
      const uint64_t da = hmma::desc_sw128(st + wg * ATOM_BYTES + kk * 2048, ATOM_BYTES, 1024);
      const uint64_t db = hmma::desc_sw128(st + 2 * ATOM_BYTES + kk * 2048, ATOM_BYTES, 1024);
      hmma::wgmma_m64n128k16<1, 1>(acc, da, db, 1);
    }
    hmma::wgmma_commit();
    hmma::wgmma_wait<0>();
  }
  hmma::fence_regs(acc);

  // the fp32 partial of this (tile, chunk), straight from the registers
  float* out = ws + (long)blockIdx.y * W_TOTAL + job.w_off;
  const int lt = threadIdx.x % 128;
  const int r0 = k0 + wg * 64 + (lt / 32) * 16 + (lt % 32) / 4;
#pragma unroll
  for (int jn = 0; jn < TN / 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + jn * 8 + 2 * (lt % 4);
      *reinterpret_cast<float2*>(out + (long)(r0 + 8 * h) * job.N + col) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
    }
}

// out[c] = sum_r in[r * ld + c], r in a fixed order: 8 row groups per
// column, then the groups in order.
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ in, long long rows, long long ld, long long cols,
                   float* __restrict__ out) {
  __shared__ float part[8][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < cols)
    for (long long r = threadIdx.y; r < rows; r += 8) s += in[r * ld + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = part[0][threadIdx.x];
    for (int k = 1; k < 8; ++k) t += part[k][threadIdx.x];
    out[c] = t;
  }
}

}  // namespace

// Scratch sizes for n points and `splits` point chunks of the weight
// products, in elements: arena (bf16) and bias partials, workspace (fp32).
extern "C" void fused_mlp_bwd_scratch(long long n, int splits, long long* arena_elems,
                                      long long* bpart_elems, long long* ws_elems) {
  const long long p_pad = (n + TILE_M - 1) / TILE_M * TILE_M;
  *arena_elems = (long long)AR_COLS * p_pad + IMG_ELEMS;  // + the weight image
  *bpart_elems = p_pad / TILE_M * B_TOTAL;
  *ws_elems = (long long)splits * W_TOTAL;
}

// in8 [n, 8] f32, pe_mat [8, 128] f32, sin_mask [128] f32, w / b: the
// forward kernel's flat bf16 weights and f32 biases, g [n, 128] bf16;
// scratch from fused_mlp_bwd_scratch; dw [835,584] f32 in the weight
// buffer's layout, db [2,944] f32 in the bias buffer's layout (its last
// 128 entries are the gradient of each of the five output biases).
// Launches on `stream`; returns the first failing launch's cudaError_t.
extern "C" int fused_mlp_bwd(const void* in8, const void* pe_mat, const void* sin_mask,
                             const void* w, const void* b, const void* g, void* arena,
                             void* bpart, void* ws, void* dw, void* db, long long n, int splits,
                             void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const long long p_pad = (n + TILE_M - 1) / TILE_M * TILE_M;
  const long long tiles = p_pad / TILE_M;
  if (tiles > INT_MAX || splits > 65535) return (int)cudaErrorInvalidValue;
  const long long slabs = p_pad / SLAB;
  const long long chunk = (slabs + splits - 1) / splits * SLAB;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_act_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ACT_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_wgrad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  bf16* img = static_cast<bf16*>(arena) + (long long)AR_COLS * p_pad;
  bwd_act_wimg_kernel<<<N_SLABS, NTHREADS, 0, s>>>(static_cast<const bf16*>(w), img);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_act_wgmma_kernel<<<(unsigned)tiles, ACT_THREADS, ACT_SMEM, s>>>(
      static_cast<const float*>(in8), static_cast<const float*>(pe_mat),
      static_cast<const float*>(sin_mask), img,
      static_cast<const float*>(b), static_cast<const bf16*>(g), static_cast<bf16*>(arena),
      static_cast<float*>(bpart), n, p_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_wgrad_gemm_kernel<<<dim3(N_TILES, splits), WG_THREADS, WG_SMEM, s>>>(
      static_cast<const bf16*>(arena), static_cast<float*>(ws), p_pad, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 rb(32, 8);
  reduce_rows_kernel<<<(unsigned)((W_TOTAL + 31) / 32), rb, 0, s>>>(
      static_cast<const float*>(ws), splits, W_TOTAL, W_TOTAL, static_cast<float*>(dw));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(unsigned)((B_TOTAL + 31) / 32), rb, 0, s>>>(
      static_cast<const float*>(bpart), tiles, B_TOTAL, B_TOTAL, static_cast<float*>(db));
  return (int)cudaGetLastError();
}
